// Body of kernel 1, the fused forward Vecchia sufficient statistics, shared by
// its four translation units: vecchia_suffstats.cu (closed-form rho, GENERAL =
// false) and vecchia_suffstats_nu.cu (general-nu Matern, GENERAL = true) on the
// dist table layout, and the same two with _coords (COORDS = true: distances
// recomputed from coordinate planes, vecchia_common.cuh).
//
// Replaces the Pallas kernel _suffstats_kernel (pynngp_tpu/ops/pallas_bf.py:409,
// driven by _pallas_suffstats_call l.554; its coords branch through
// _dist_access, l.377 and l.437).  For every (site, chain) it builds
// the m x m unit-variance neighbor correlation C (+ alpha + jitter on valid
// diagonal slots, alpha v at the neighbor under heterogeneous noise, identity
// rows for invalid slots), factors it with the unrolled Cholesky-Crout
// recurrence, and forward-solves u = L^-1 c and w = L^-1 y_N.  It writes
// F = 1 + alpha (alpha v_i with v) - u.u and r = y - u.w per
// (chain, site), and one partial of sum log F and sum r^2/F per
// (block, chain) over the sites < n.  The wrapper (ops/suffstats.py) sums
// the (C, n_blocks) partials in float64, as XLA sums the TPU kernel's
// per-cell partials (pallas_bf.py:593-594): deterministic, no atomics.
//
// Design.  One thread per (site, chain): blocks of kBlock threads along
// sites, gridDim.y = chains.  The tables are shared by all chains, and so is y
// (y_stride = 0) unless each chain brings its own row of a (C, n) array
// (y_stride = n: the residual y - X beta with fixed effects); each thread
// gathers its y_N through nn_idx, and with noise weights its v_N.  The loop
// over the slots unrolls over the template parameter M and the factor lives
// in local memory ("Loop structure", vecchia_common.cuh).
//
// What bounds it.  A thread reads about (m^2/2 + 2m) * 4 bytes in the dist
// layout (distances, nn_idx, y_N), about 1 KB at m = 15, against ~m^3/6 dependent FMAs plus
// m(m+1)/2 exponentials: the serial recurrence makes it latency- and
// register-bound, not bandwidth-bound.  At m = 15 the strict lower factor
// alone is 105 floats per thread (in local memory).  Noise weights add the
// gather of v at the neighbors, through the nn_idx the y gather loads, and
// at the site.  The general-nu instances replace each
// exponential by a Bessel evaluation of some hundreds of operations
// (vecchia_bessel.cuh) and are bound by those.  The coords layout reads
// (m + 1) d coordinates in place of the m(m+1)/2 distances and spends, per
// distance, d subtractions and multiply-adds and one sqrt; it re-reads a
// neighbor's coordinates at every use instead of keeping m d of them live.
#pragma once

#include <cstddef>

#include "vecchia_common.cuh"

namespace vecchia {
namespace {

// ANY_D: the coords instance for d > kMaxDim (vecchia_common.cuh).  The body
// is a device function so that its two kinds of instance can carry different
// launch bounds (suffstats_kernel below).
template <int M, bool GENERAL, bool COORDS, bool ANY_D>
__device__ __forceinline__ void suffstats_body(
    const float* __restrict__ params, const float* __restrict__ tab_a,
    const float* __restrict__ tab_b, const int* __restrict__ nn_idx,
    const float* __restrict__ y_all, int y_stride, const float* __restrict__ v, int n_pad,
    int m, int dim, int family, float* __restrict__ f_out, float* __restrict__ r_out,
    float* __restrict__ part) {
  // the loops over the slots run to M, unrolled; in the ANY_D instance to
  // the call's m, which keeps them rolled
  const int top = ANY_D ? m : M;
  const int chain = blockIdx.y;
  const int site = blockIdx.x * kBlock + threadIdx.x;
  const float* pr = params + chain * kParams;
  const float* y = y_all + static_cast<size_t>(chain) * y_stride;
  const float phi = pr[0];
  const float alpha = pr[1];
  const float jitter = pr[2];
  const int n = static_cast<int>(pr[3]);
  const MaternSet* set = chain_matern_set<GENERAL>(pr, false);
  const OwnCoords<COORDS> own = load_own<COORDS>(tab_a, n_pad, site, dim);
  const Guard g(site, m);

  float low[tri(M, 0)];  // strict lower triangle of L, packed by tri(i, k)
  float inv_diag[M];
  float u[M];  // L^-1 c
  float w[M];  // L^-1 y_N

#pragma unroll
  for (int k = 0; k < top; ++k) {
    // slot k is a real neighbor iff k < m and site > k (identity row
    // otherwise; one past m reads the last slot's planes, Guard)
    const float mk = g.mask(k);
    const int nb = nn_idx[static_cast<size_t>(g.at(k)) * n_pad + site];
    float acc = 1.0f + mk * (slot_nugget(alpha, v, nb) + jitter);
#pragma unroll
    for (int j = 0; j < k; ++j) acc -= low[tri(k, j)] * low[tri(k, j)];
    const float inv = 1.0f / sqrtf(acc);
    inv_diag[k] = inv;
    float au = corr<GENERAL>(family, dist_in<COORDS, ANY_D>(tab_a, tab_b, own, g, k, dim,
                                                            n_pad, site),
                             phi, set) *
               mk;
    float aw = y[nb] * mk;
#pragma unroll
    for (int j = 0; j < k; ++j) {
      au -= low[tri(k, j)] * u[j];
      aw -= low[tri(k, j)] * w[j];
    }
    u[k] = au * inv;
    w[k] = aw * inv;
#pragma unroll
    for (int i = k + 1; i < top; ++i) {
      const float mi = g.mask(i);  // mask_i * mask_k, as i > k
      float a = corr<GENERAL>(family, dist_pair<COORDS, ANY_D>(tab_b, g, i, k, dim, n_pad, site),
                              phi, set) *
                mi;
#pragma unroll
      for (int j = 0; j < k; ++j) a -= low[tri(i, j)] * low[tri(k, j)];
      low[tri(i, k)] = a * inv;
    }
  }

  float ff = 1.0f + own_nugget(alpha, v, site);
  float bdoty = 0.0f;
#pragma unroll
  for (int k = 0; k < top; ++k) {
    ff -= u[k] * u[k];
    bdoty += u[k] * w[k];
  }
  const bool valid = site < n;
  const float resid = (valid ? y[site] : 0.0f) - bdoty;
  const size_t out = static_cast<size_t>(chain) * n_pad + site;
  f_out[out] = ff;
  r_out[out] = resid;
  const float sums[2] = {valid ? logf(ff) : 0.0f, valid ? resid * resid / ff : 0.0f};
  block_sum_store<2>(sums, part, gridDim.y * gridDim.x, chain * gridDim.x + blockIdx.x);
}

#define VECCHIA_SUFFSTATS_PARAMS                                                              \
  const float *__restrict__ params, const float *__restrict__ tab_a,                          \
      const float *__restrict__ tab_b, const int *__restrict__ nn_idx,                        \
      const float *__restrict__ y_all, int y_stride, const float *__restrict__ v, int n_pad,  \
      int m, int dim, int family, float *__restrict__ f_out, float *__restrict__ r_out,       \
      float *__restrict__ part
#define VECCHIA_SUFFSTATS_ARGS \
  params, tab_a, tab_b, nn_idx, y_all, y_stride, v, n_pad, m, dim, family, f_out, r_out, part

// The closed-form instances ask for three blocks an SM (at most 168
// registers): unbounded, the coords instance at M = 20 took 190 registers,
// two blocks an SM, and ran 46% slower than with the 168 of the instances
// before the m guard, while the same bound moved the general-nu instances'
// registers the other way (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
template <int M, bool GENERAL, bool COORDS, bool ANY_D>
__global__ void __launch_bounds__(kBlock, 3) suffstats_kernel(VECCHIA_SUFFSTATS_PARAMS) {
  suffstats_body<M, GENERAL, COORDS, ANY_D>(VECCHIA_SUFFSTATS_ARGS);
}

template <int M, bool GENERAL, bool COORDS, bool ANY_D>
__global__ void __launch_bounds__(kBlock) suffstats_nu_kernel(VECCHIA_SUFFSTATS_PARAMS) {
  suffstats_body<M, GENERAL, COORDS, ANY_D>(VECCHIA_SUFFSTATS_ARGS);
}
#undef VECCHIA_SUFFSTATS_PARAMS
#undef VECCHIA_SUFFSTATS_ARGS

// Validates the launch shape, picks the instance (M >= m, or the ANY_D one
// for coords with d > kMaxDim) and launches on `stream` without
// synchronising; returns cudaGetLastError().
template <bool GENERAL, bool COORDS>
int launch_suffstats(const float* params, const float* tab_a, const float* tab_b,
                     const int* nn_idx, const float* y, int y_stride, const float* v,
                     int n_pad, int m, int dim, int chains, int family, float* f_out,
                     float* r_out, float* part, void* stream) {
  if (!valid_launch<COORDS>(n_pad, chains, dim) || y_stride < 0 || launch_m(m) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_pad / kBlock, chains);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VECCHIA_SUFFSTATS_LAUNCH(MM, ANY)                                                  \
  if constexpr (GENERAL) {                                                                 \
    suffstats_nu_kernel<MM, GENERAL, COORDS, ANY><<<grid, kBlock, 0, s>>>(                 \
        params, tab_a, tab_b, nn_idx, y, y_stride, v, n_pad, m, dim, family, f_out, r_out, \
        part);                                                                             \
  } else {                                                                                 \
    suffstats_kernel<MM, GENERAL, COORDS, ANY><<<grid, kBlock, 0, s>>>(                    \
        params, tab_a, tab_b, nn_idx, y, y_stride, v, n_pad, m, dim, family, f_out, r_out, \
        part);                                                                             \
  }
  if (COORDS && dim > kMaxDim) {
    VECCHIA_SUFFSTATS_LAUNCH(kAnyDimM, COORDS);
    return static_cast<int>(cudaGetLastError());
  }
  switch (launch_m(m)) {
    case 7: VECCHIA_SUFFSTATS_LAUNCH(7, false); break;
    case 10: VECCHIA_SUFFSTATS_LAUNCH(10, false); break;
    case 15: VECCHIA_SUFFSTATS_LAUNCH(15, false); break;
    case 20: VECCHIA_SUFFSTATS_LAUNCH(20, false); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VECCHIA_SUFFSTATS_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace vecchia
