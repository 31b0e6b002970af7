// Kernel 3 for the general-nu Matern: the GENERAL instances of the B/F pass
// (body in vecchia_bf_body.cuh, Bessel K_nu in vecchia_bessel.cuh).  Replaces
// _bf_kernel reading nu (pynngp_tpu/ops/pallas_bf.py:949) with
// _matern_rho_general.
#include "vecchia_bf_body.cuh"

// C interface: the arguments of vecchia_bf_f32 without `family`; nu is slot 4
// of each chain's params row.
extern "C" int vecchia_bf_nu_f32(const float* params, const float* d_in, const float* d_tri,
                                 const int* nn_idx, const float* v, int n_pad, int m,
                                 int chains, int group, int grid_x, int smem_bytes,
                                 double* scratch, float* b_out, float* f_out, void* stream) {
  return vecchia::launch_bf<true, false>(params, d_in, d_tri, nn_idx, v, n_pad, m, 0, chains,
                                         vecchia::kMaternGeneral, group, grid_x, smem_bytes,
                                         scratch, b_out, f_out, stream);
}
