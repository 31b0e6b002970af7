// Kernel 1: fused forward Vecchia sufficient statistics, the closed-form
// instances on the dist table layout (the body and its notes are in
// vecchia_suffstats_body.cuh).
#include "vecchia_suffstats_body.cuh"

// C interface, bound with ctypes by pynngp_tpu_torch/ops/_build.py.
//   params (C, 6); d_in (m, n_pad); d_tri (m(m-1)/2, n_pad); nn_idx (m, n_pad)
//   int32; y (n,) with y_stride 0, or (C, n) with y_stride n; v (n_pad,) the
//   per-site noise weights padded with 1, or null for homogeneous noise;
//   m >= 1 (the instance M >= m runs for m <= 20, the rolled one for
//   m <= 32, the shared-memory body up to kSmemM = 236, the cluster body up
//   to kClusterM = 608, the scratch body above); group (chains a block, one warp each), grid_x (blocks along the
//   32-site tiles) and smem_bytes (the tile ring's bytes for them) as
//   pynngp_tpu_torch/ops/geometry.py computes them, refused unless the bytes
//   match the ring's layout; for 32 < m <= 236 group chains a block, grid_x
//   blocks along the sites and smem_bytes group systems' bytes
//   (geometry.smem_geometry), scratch null; for 236 < m <= 608 group the
//   cluster size, grid_x clusters a chain and smem_bytes a block's bytes
//   (geometry.cluster_geometry), scratch null; above, group 1, smem_bytes 0,
//   grid_x blocks of 128 sites and scratch, a buffer of m(m-1)/2 + 6m
//   doubles for each of the launch's grid_x * C * 128 threads
//   (geometry.large_geometry), null otherwise;
//   f_out, r_out (C, n_pad); part (2, C, grid_x).
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int vecchia_suffstats_f32(const float* params, const float* d_in, const float* d_tri,
                                     const int* nn_idx, const float* y, int y_stride,
                                     const float* v, int n_pad, int m, int chains, int family,
                                     int group, int grid_x, int smem_bytes, double* scratch, float* f_out,
                                     float* r_out, float* part, void* stream) {
  return vecchia::launch_suffstats<false, false>(params, d_in, d_tri, nn_idx, y, y_stride, v, n_pad,
                                                 m, 0, chains, family, group, grid_x, smem_bytes, scratch,
                                                 f_out, r_out, part, stream);
}

extern "C" const char* vecchia_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
