// Kernel 2: fused Vecchia value + gradient pass, the instances without the
// y-cotangent outputs (the body and its notes are in vecchia_grad_body.cuh).
#include "vecchia_grad_body.cuh"

// C interface, bound with ctypes by pynngp_tpu_torch/ops/_build.py.
//   params (C, 6); d_in (m, n_pad); d_tri (m(m-1)/2, n_pad); nn_idx (m, n_pad)
//   int32; y (n,) with y_stride 0, or (C, n) with y_stride n; v (n_pad,) the
//   per-site noise weights padded with 1, or null; m >= 1; group, grid_x,
//   smem_bytes and scratch as for vecchia_suffstats_f32, with kernel 2's
//   limits: the shared-memory body up to kSmemGradM = 232
//   (geometry.smem_geometry(..., "vecchia_grad")), the cluster body up to
//   kClusterGradM = 608 (geometry.cluster_geometry(..., "vecchia_grad"),
//   scratch the hand-off buffer), the scratch body above; part
//   (6, C, grid_x) in the order logdet, quad, dlogdet/dphi, dquad/dphi,
//   dlogdet/dalpha, dquad/dalpha.
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int vecchia_grad_f32(const float* params, const float* d_in, const float* d_tri,
                                const int* nn_idx, const float* y, int y_stride, const float* v,
                                int n_pad, int m, int chains, int family, int group, int grid_x,
                                int smem_bytes, double* scratch, float* part, void* stream) {
  return vecchia::launch_grad<false, false, false>(params, d_in, d_tri, nn_idx, y, y_stride, v,
                                                   n_pad, m, 0, chains, family, false, group,
                                                   grid_x, smem_bytes, scratch, part, nullptr, nullptr,
                                                   stream);
}
