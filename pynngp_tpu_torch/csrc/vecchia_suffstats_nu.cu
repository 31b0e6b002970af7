// Kernel 1 for the general-nu Matern: the GENERAL instances of the fused
// forward pass on the dist table layout (body in vecchia_suffstats_body.cuh,
// Bessel K_nu in vecchia_bessel.cuh).  Replaces the _matern_rho_general branch
// of _suffstats_kernel (pynngp_tpu/ops/pallas_bf.py:338-341, 409).
#include "vecchia_suffstats_body.cuh"

// C interface: the arguments of vecchia_suffstats_f32 without `family`; nu is
// slot 4 of each chain's params row.
extern "C" int vecchia_suffstats_nu_f32(const float* params, const float* d_in, const float* d_tri,
                                        const int* nn_idx, const float* y, int y_stride,
                                        const float* v, int n_pad, int m, int chains, int group,
                                        int grid_x, int smem_bytes, double* scratch, float* f_out, float* r_out,
                                        float* part, void* stream) {
  return vecchia::launch_suffstats<true, false>(params, d_in, d_tri, nn_idx, y, y_stride, v, n_pad,
                                                m, 0, chains, vecchia::kMaternGeneral, group,
                                                grid_x, smem_bytes, scratch, f_out, r_out, part, stream);
}
