// Kernel 2 for the general-nu Matern with the y-cotangent outputs: the GENERAL
// and EMIT_Y instances of the fused value + gradient pass (body and notes in
// vecchia_grad_body.cuh).  Fixed effects with a general or sampled nu.
#include "vecchia_grad_body.cuh"

// C interface: the arguments of vecchia_grad_nu_f32, and the two outputs of
// vecchia_grad_y_f32, b_out (C, m, n_pad) and rof_out (C, n_pad).
extern "C" int vecchia_grad_y_nu_f32(const float* params, const float* d_in, const float* d_tri,
                                     const int* nn_idx, const float* y, int y_stride,
                                     const float* v, int n_pad, int m, int chains, int with_nu,
                                     int group, int grid_x, int smem_bytes, double* scratch, float* part,
                                     float* b_out, float* rof_out, void* stream) {
  return vecchia::launch_grad<true, true, false>(params, d_in, d_tri, nn_idx, y, y_stride, v, n_pad,
                                                 m, 0, chains, vecchia::kMaternGeneral,
                                                 with_nu != 0, group, grid_x, smem_bytes, scratch, part,
                                                 b_out, rof_out, stream);
}
