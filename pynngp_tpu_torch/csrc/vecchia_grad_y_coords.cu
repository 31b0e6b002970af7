// Kernel 2 on the coords table layout, closed-form rho, with the y-cotangent
// outputs: the EMIT_Y and COORDS instances of the fused value + gradient pass
// (body in vecchia_grad_body.cuh).  Replaces the emit_y and coords branches of
// _grad_kernel (pynngp_tpu/ops/pallas_bf.py:752, 857).
#include "vecchia_grad_body.cuh"

// C interface: the arguments of vecchia_grad_coords_f32, and the two outputs of
// vecchia_grad_y_f32, b_out (C, m, n_pad) and rof_out (C, n_pad).
extern "C" int vecchia_grad_y_coords_f32(const float* params, const float* co, const float* cn,
                                         const int* nn_idx, const float* y, int y_stride,
                                         const float* v, int n_pad, int m, int dim, int chains,
                                         int family, int group, int grid_x, int smem_bytes, double* scratch,
                                         float* part, float* b_out, float* rof_out, void* stream) {
  return vecchia::launch_grad<true, false, true>(params, co, cn, nn_idx, y, y_stride, v, n_pad, m,
                                                 dim, chains, family, false, group, grid_x,
                                                 smem_bytes, scratch, part, b_out, rof_out, stream);
}
