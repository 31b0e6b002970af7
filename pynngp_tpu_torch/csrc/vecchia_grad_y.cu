// Kernel 2 with the y-cotangent outputs: the EMIT_Y instances of the fused
// Vecchia value + gradient pass (the body and its notes are in
// vecchia_grad_body.cuh).  Replaces the emit_y branch of _grad_kernel
// (pynngp_tpu/ops/pallas_bf.py:857-864).
#include "vecchia_grad_body.cuh"

// C interface, bound with ctypes by pynngp_tpu_torch/ops/_build.py.
//   The arguments of vecchia_grad_f32, and two more outputs: b_out
//   (C, m, n_pad), the kriging weights plane-major, and rof_out (C, n_pad),
//   r/F per site; both exactly 0 at padded sites, b_out also in invalid slots.
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int vecchia_grad_y_f32(const float* params, const float* d_in, const float* d_tri,
                                  const int* nn_idx, const float* y, int y_stride, const float* v,
                                  int n_pad, int m, int chains, int family, int group, int grid_x,
                                  int smem_bytes, double* scratch, float* part, float* b_out, float* rof_out,
                                  void* stream) {
  return vecchia::launch_grad<true, false, false>(params, d_in, d_tri, nn_idx, y, y_stride, v,
                                                  n_pad, m, 0, chains, family, false, group, grid_x,
                                                  smem_bytes, scratch, part, b_out, rof_out, stream);
}
