// Kernel 3: explicit kriging weights B and conditional variances F, the
// closed-form instances (the body and its notes are in vecchia_bf_body.cuh).
#include "vecchia_bf_body.cuh"

// C interface, bound with ctypes by pynngp_tpu_torch/ops/_build.py.
//   params (C, 6); d_in (m, n_pad); d_tri (m(m-1)/2, n_pad); nn_idx (m, n_pad)
//   int32, read only with v; v (n_pad,) the per-site noise weights padded
//   with 1, or null; m >= 1; group, grid_x, smem_bytes and scratch as for
//   vecchia_suffstats_f32 (the ring without y planes, and without nn_idx
//   planes when v is null); b_out (C, m, n_pad); f_out (C, n_pad).
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int vecchia_bf_f32(const float* params, const float* d_in, const float* d_tri,
                              const int* nn_idx, const float* v, int n_pad, int m, int chains,
                              int family, int group, int grid_x, int smem_bytes, double* scratch,
                              float* b_out, float* f_out, void* stream) {
  return vecchia::launch_bf<false, false>(params, d_in, d_tri, nn_idx, v, n_pad, m, 0, chains,
                                          family, group, grid_x, smem_bytes, scratch, b_out,
                                          f_out, stream);
}
