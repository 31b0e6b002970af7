// Kernel 3 on the coords table layout for the general-nu Matern: the GENERAL
// and COORDS instances of the B/F pass (body in vecchia_bf_body.cuh).  Replaces
// _bf_kernel reading nu with the coords branch of _dist_access
// (pynngp_tpu/ops/pallas_bf.py:377, 941, 949).
#include "vecchia_bf_body.cuh"

// C interface: the arguments of vecchia_bf_coords_f32 without `family`; nu is
// slot 4 of each chain's params row.
extern "C" int vecchia_bf_nu_coords_f32(const float* params, const float* co, const float* cn,
                                        const int* nn_idx, const float* v, int n_pad, int m,
                                        int dim, int chains, int group, int grid_x,
                                        int smem_bytes, double* scratch, float* b_out,
                                        float* f_out, void* stream) {
  return vecchia::launch_bf<true, true>(params, co, cn, nn_idx, v, n_pad, m, dim, chains,
                                        vecchia::kMaternGeneral, group, grid_x, smem_bytes,
                                        scratch, b_out, f_out, stream);
}
