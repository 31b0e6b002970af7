// Kernel 3 on the coords table layout, closed-form rho: the COORDS instances of
// the B/F pass (body in vecchia_bf_body.cuh).  Replaces the coords branch of
// _bf_kernel (pynngp_tpu/ops/pallas_bf.py:941, via _dist_access l.377).
#include "vecchia_bf_body.cuh"

// C interface: the arguments of vecchia_bf_f32 with the coordinate planes in
// the place of the distance planes and their dimension d >= 1: co (d,
// n_pad), cn (m d, n_pad), plane k d + a for coordinate a of slot k.
extern "C" int vecchia_bf_coords_f32(const float* params, const float* co, const float* cn,
                                     const int* nn_idx, const float* v, int n_pad, int m,
                                     int dim, int chains, int family, int group, int grid_x,
                                     int smem_bytes, double* scratch, float* b_out,
                                     float* f_out, void* stream) {
  return vecchia::launch_bf<false, true>(params, co, cn, nn_idx, v, n_pad, m, dim, chains,
                                         family, group, grid_x, smem_bytes, scratch, b_out,
                                         f_out, stream);
}
