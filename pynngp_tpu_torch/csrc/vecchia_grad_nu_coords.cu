// Kernel 2 on the coords table layout for the general-nu Matern, without the
// y-cotangent outputs: the GENERAL and COORDS instances of the fused value +
// gradient pass (body in vecchia_grad_body.cuh).  Replaces the general and the
// coords branches of _grad_kernel and, with `with_nu`, its (dld_dnu, dq_dnu)
// outputs (pynngp_tpu/ops/pallas_bf.py:727, 752, 812-833).
#include "vecchia_grad_body.cuh"

// C interface: the arguments of vecchia_grad_coords_f32 with `with_nu` in the
// place of `family`; part is (8, C, grid_x) as for vecchia_grad_nu_f32.
extern "C" int vecchia_grad_nu_coords_f32(const float* params, const float* co, const float* cn,
                                          const int* nn_idx, const float* y, int y_stride,
                                          const float* v, int n_pad, int m, int dim, int chains,
                                          int with_nu, int group, int grid_x, int smem_bytes, double* scratch,
                                          float* part, void* stream) {
  return vecchia::launch_grad<false, true, true>(params, co, cn, nn_idx, y, y_stride, v, n_pad, m,
                                                 dim, chains, vecchia::kMaternGeneral, with_nu != 0,
                                                 group, grid_x, smem_bytes, scratch, part, nullptr, nullptr,
                                                 stream);
}
