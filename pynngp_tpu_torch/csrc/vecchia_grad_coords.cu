// Kernel 2 on the coords table layout, closed-form rho, without the
// y-cotangent outputs: the COORDS instances of the fused value + gradient pass
// (body in vecchia_grad_body.cuh).  Replaces the coords branch of _grad_kernel
// (pynngp_tpu/ops/pallas_bf.py:727, via _dist_access l.377).
#include "vecchia_grad_body.cuh"

// C interface: the arguments of vecchia_grad_f32 with the coordinate planes in
// the place of the distance planes and their dimension d >= 1: co (d,
// n_pad), cn (m d, n_pad), plane k d + a for coordinate a of slot k.
extern "C" int vecchia_grad_coords_f32(const float* params, const float* co, const float* cn,
                                       const int* nn_idx, const float* y, int y_stride,
                                       const float* v, int n_pad, int m, int dim, int chains,
                                       int family, int group, int grid_x, int smem_bytes, double* scratch,
                                       float* part, void* stream) {
  return vecchia::launch_grad<false, false, true>(params, co, cn, nn_idx, y, y_stride, v, n_pad, m,
                                                  dim, chains, family, false, group, grid_x,
                                                  smem_bytes, scratch, part, nullptr, nullptr, stream);
}
