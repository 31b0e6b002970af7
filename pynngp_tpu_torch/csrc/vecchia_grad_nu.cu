// Kernel 2 for the general-nu Matern, without the y-cotangent outputs: the
// GENERAL instances of the fused value + gradient pass (body and notes in
// vecchia_grad_body.cuh, Bessel K_nu in vecchia_bessel.cuh).  Replaces the
// general branches of _grad_kernel (pynngp_tpu/ops/pallas_bf.py:727) and, with
// `with_nu`, its (dld_dnu, dq_dnu) outputs (l.812-833, 852-856).
#include "vecchia_grad_body.cuh"

// C interface: the arguments of vecchia_grad_f32 with `with_nu` (non-zero for
// a sampled nu) in the place of `family`; nu is slot 4 of each chain's params
// row; part is (8, C, grid_x): the six sums of vecchia_grad_f32, then
// dlogdet/dnu and dquad/dnu (zeros without `with_nu`).
extern "C" int vecchia_grad_nu_f32(const float* params, const float* d_in, const float* d_tri,
                                   const int* nn_idx, const float* y, int y_stride, const float* v,
                                   int n_pad, int m, int chains, int with_nu, int group, int grid_x,
                                   int smem_bytes, double* scratch, float* part, void* stream) {
  return vecchia::launch_grad<false, true, false>(params, d_in, d_tri, nn_idx, y, y_stride, v,
                                                  n_pad, m, 0, chains, vecchia::kMaternGeneral,
                                                  with_nu != 0, group, grid_x, smem_bytes, scratch, part,
                                                  nullptr, nullptr, stream);
}
