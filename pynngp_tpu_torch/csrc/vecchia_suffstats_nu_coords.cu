// Kernel 1 on the coords table layout for the general-nu Matern: the GENERAL
// and COORDS instances of the fused forward pass (body in
// vecchia_suffstats_body.cuh).  Replaces _suffstats_kernel with
// _matern_rho_general and the coords branch of _dist_access
// (pynngp_tpu/ops/pallas_bf.py:338, 377, 409).
#include "vecchia_suffstats_body.cuh"

// C interface: the arguments of vecchia_suffstats_coords_f32 without `family`;
// nu is slot 4 of each chain's params row.
extern "C" int vecchia_suffstats_nu_coords_f32(const float* params, const float* co,
                                               const float* cn, const int* nn_idx, const float* y,
                                               int y_stride, const float* v, int n_pad, int m,
                                               int dim, int chains, int group, int grid_x,
                                               int smem_bytes, double* scratch, float* f_out, float* r_out,
                                               float* part, void* stream) {
  return vecchia::launch_suffstats<true, true>(params, co, cn, nn_idx, y, y_stride, v, n_pad, m,
                                               dim, chains, vecchia::kMaternGeneral, group, grid_x,
                                               smem_bytes, scratch, f_out, r_out, part, stream);
}
