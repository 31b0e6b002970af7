// Kernel 1 on the coords table layout, closed-form rho: the COORDS instances
// of the fused forward pass (body in vecchia_suffstats_body.cuh, distance
// accessors in vecchia_common.cuh).  Replaces the coords branch of
// _suffstats_kernel (pynngp_tpu/ops/pallas_bf.py:409, via _dist_access l.377).
#include "vecchia_suffstats_body.cuh"

// C interface: the arguments of vecchia_suffstats_f32 with the coordinate
// planes in the place of the distance planes and their dimension d >= 1:
//   co (d, n_pad) the sites' centred coordinates; cn (m d, n_pad) their
//   neighbors', plane k d + a for coordinate a of slot k.
extern "C" int vecchia_suffstats_coords_f32(const float* params, const float* co, const float* cn,
                                            const int* nn_idx, const float* y, int y_stride,
                                            const float* v, int n_pad, int m, int dim, int chains,
                                            int family, int group, int grid_x, int smem_bytes, double* scratch,
                                            float* f_out, float* r_out, float* part, void* stream) {
  return vecchia::launch_suffstats<false, true>(params, co, cn, nn_idx, y, y_stride, v, n_pad, m,
                                                dim, chains, family, group, grid_x, smem_bytes, scratch,
                                                f_out, r_out, part, stream);
}
