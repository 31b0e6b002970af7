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
// diagonal slots, identity rows for invalid slots), factors it with the
// unrolled Cholesky-Crout recurrence, and forward-solves u = L^-1 c and
// v = L^-1 y_N.  It writes F = 1 + alpha - u.u and r = y - u.v per
// (chain, site), and one partial of sum log F and sum r^2/F per
// (block, chain) over the sites < n.  The wrapper (ops/suffstats.py) sums
// the (C, n_blocks) partials in float64, as XLA sums the TPU kernel's
// per-cell partials (pallas_bf.py:593-594): deterministic, no atomics.
//
// Design.  One thread per (site, chain): blocks of kBlock threads along
// sites, gridDim.y = chains.  The tables are shared by all chains, and so is y
// (y_stride = 0) unless each chain brings its own row of a (C, n) array
// (y_stride = n: the residual y - X beta with fixed effects); each thread
// gathers its y_N through nn_idx.  The factor lives in registers, fully
// unrolled over the template parameter M.
//
// What bounds it.  A thread reads about (m^2/2 + 2m) * 4 bytes in the dist
// layout (distances, nn_idx, y_N), about 1 KB at m = 15, against ~m^3/6 dependent FMAs plus
// m(m+1)/2 exponentials: the serial recurrence makes it latency- and
// register-bound, not bandwidth-bound.  At m = 15 the strict lower factor
// alone is 105 live floats per thread.  The general-nu instances replace each
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

template <int M, bool GENERAL, bool COORDS>
__global__ void __launch_bounds__(kBlock)
suffstats_kernel(const float* __restrict__ params, const float* __restrict__ tab_a,
                 const float* __restrict__ tab_b, const int* __restrict__ nn_idx,
                 const float* __restrict__ y_all, int y_stride, int n_pad, int dim, int family,
                 float* __restrict__ f_out, float* __restrict__ r_out,
                 float* __restrict__ part) {
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

  float low[tri(M, 0)];  // strict lower triangle of L, packed by tri(i, k)
  float inv_diag[M];
  float u[M];  // L^-1 c
  float v[M];  // L^-1 y_N

#pragma unroll
  for (int k = 0; k < M; ++k) {
    // slot k is a real neighbor iff site > k (identity row otherwise)
    const float mk = site > k ? 1.0f : 0.0f;
    float acc = 1.0f + mk * (alpha + jitter);
#pragma unroll
    for (int j = 0; j < k; ++j) acc -= low[tri(k, j)] * low[tri(k, j)];
    const float inv = 1.0f / sqrtf(acc);
    inv_diag[k] = inv;
    const size_t at = static_cast<size_t>(k) * n_pad + site;
    float au =
        corr<GENERAL>(family, dist_in<COORDS>(tab_a, tab_b, own, k, dim, n_pad, site), phi, set) *
        mk;
    float av = y[nn_idx[at]] * mk;
#pragma unroll
    for (int j = 0; j < k; ++j) {
      au -= low[tri(k, j)] * u[j];
      av -= low[tri(k, j)] * v[j];
    }
    u[k] = au * inv;
    v[k] = av * inv;
#pragma unroll
    for (int i = k + 1; i < M; ++i) {
      const float mi = site > i ? 1.0f : 0.0f;  // mask_i * mask_k, as i > k
      float a =
          corr<GENERAL>(family, dist_pair<COORDS>(tab_b, i, k, dim, n_pad, site), phi, set) * mi;
#pragma unroll
      for (int j = 0; j < k; ++j) a -= low[tri(i, j)] * low[tri(k, j)];
      low[tri(i, k)] = a * inv;
    }
  }

  float ff = 1.0f + alpha;
  float bdoty = 0.0f;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    ff -= u[k] * u[k];
    bdoty += u[k] * v[k];
  }
  const bool valid = site < n;
  const float resid = (valid ? y[site] : 0.0f) - bdoty;
  const size_t out = static_cast<size_t>(chain) * n_pad + site;
  f_out[out] = ff;
  r_out[out] = resid;
  const float sums[2] = {valid ? logf(ff) : 0.0f, valid ? resid * resid / ff : 0.0f};
  block_sum_store<2>(sums, part, gridDim.y * gridDim.x, chain * gridDim.x + blockIdx.x);
}

// Validates the launch shape, picks the M instance and launches on `stream`
// without synchronising; returns cudaGetLastError().
template <bool GENERAL, bool COORDS>
int launch_suffstats(const float* params, const float* tab_a, const float* tab_b,
                     const int* nn_idx, const float* y, int y_stride, int n_pad, int m, int dim,
                     int chains, int family, float* f_out, float* r_out, float* part,
                     void* stream) {
  if (!valid_launch<COORDS>(n_pad, chains, dim) || y_stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_pad / kBlock, chains);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VECCHIA_SUFFSTATS_CASE(MM)                                                          \
  case MM:                                                                                  \
    suffstats_kernel<MM, GENERAL, COORDS><<<grid, kBlock, 0, s>>>(                         \
        params, tab_a, tab_b, nn_idx, y, y_stride, n_pad, dim, family, f_out, r_out, part); \
    break;
  switch (m) {
    VECCHIA_SUFFSTATS_CASE(7)
    VECCHIA_SUFFSTATS_CASE(10)
    VECCHIA_SUFFSTATS_CASE(15)
    VECCHIA_SUFFSTATS_CASE(20)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VECCHIA_SUFFSTATS_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace vecchia
