// Kernel 2 on the coords table layout for the general-nu Matern with the
// y-cotangent outputs: the EMIT_Y, GENERAL and COORDS instances of the fused
// value + gradient pass (body in vecchia_grad_body.cuh).  Fixed effects with a
// general or sampled nu on the coords layout.
#include "vecchia_grad_body.cuh"

// C interface: the arguments of vecchia_grad_nu_coords_f32, and the two outputs
// of vecchia_grad_y_f32, b_out (C, m, n_pad) and rof_out (C, n_pad).
extern "C" int vecchia_grad_y_nu_coords_f32(const float* params, const float* co, const float* cn,
                                            const int* nn_idx, const float* y, int y_stride,
                                            const float* v, int n_pad, int m, int dim, int chains,
                                            int with_nu, int group, int grid_x, int smem_bytes, double* scratch,
                                            float* part, float* b_out, float* rof_out,
                                            void* stream) {
  return vecchia::launch_grad<true, true, true>(params, co, cn, nn_idx, y, y_stride, v, n_pad, m,
                                                dim, chains, vecchia::kMaternGeneral, with_nu != 0,
                                                group, grid_x, smem_bytes, scratch, part, b_out, rof_out,
                                                stream);
}
