// Body of kernel 3, the explicit kriging weights B = C_N^-1 c and conditional
// variances F, shared by its four translation units: vecchia_bf.cu (closed-form
// rho, GENERAL = false) and vecchia_bf_nu.cu (general-nu Matern, GENERAL = true)
// on the dist table layout, and the same two with _coords (COORDS = true:
// distances recomputed from coordinate planes, vecchia_common.cuh).
//
// Replaces the Pallas kernel _bf_kernel (pynngp_tpu/ops/pallas_bf.py:941,
// driven by _run_bf l.991 and pallas_bf l.1036; its coords branch through
// _dist_access, l.377 and l.957).  For every (site, chain) it
// builds the m x m unit-variance neighbor correlation C (+ alpha + jitter on
// valid diagonal slots, alpha v at the neighbor under heterogeneous noise,
// identity rows for invalid slots), factors it with the unrolled
// Cholesky-Crout recurrence, forward-solves u = L^-1 c, writes
// F = 1 + alpha (alpha v_i with v) - u.u and back-substitutes B = L^-T u.  B is exactly 0 in
// invalid slots.  These are the outputs the latent-w Gibbs sweep and the
// conjugate beta update consume; there is no reduction and no partial.
//
// Padded sites (site >= n) write B = 0 and F = 1 and factor nothing: their
// table entries are zero, so with alpha = 0 (the latent model) their system
// is the singular all-ones matrix.  Nothing downstream has to slice them off
// before it takes a log or a reciprocal of F.
//
// Design.  One thread per (site, chain), as kernels 1 and 2 had it before
// their tile ring (vecchia_tile.cuh): blocks of kBlock threads along sites,
// gridDim.y = chains, the tables shared by all chains.  B is written plane-major, (C, m, n_pad), so the 32 threads of a
// warp store 32 adjacent floats of one plane; the sweep reads it in that
// layout and nothing is transposed.
//
// What bounds it.  Per thread about (m^2/2 + m/2) * 4 bytes of table reads
// and (m + 1) * 4 bytes of stores against ~m^3/6 + m^2 dependent FMAs and
// m(m+1)/2 exponentials: latency- and register-bound like kernel 2, because
// the back-substitution reads column i of L for every k > i and so keeps all
// of L live to the end (105 + 15 + 15 + 15 floats at m = 15, in registers:
// "Loop structure", vecchia_common.cuh).  With noise weights it also reads
// nn_idx and v at the neighbors and v at the site.  Its floor on
// an H100 is set by operations, the special-function rate of the
// exponentials, just above the bytes it must move (chip_smoke.py,
// kernel_bounds); it runs far above both.  The general-nu instances replace
// each exponential by a Bessel evaluation (vecchia_bessel.cuh).  The coords
// layout reads (m + 1) d coordinates for the m(m+1)/2 distances and recomputes
// each (d subtractions and multiply-adds and a sqrt).
#pragma once

#include <cstddef>

#include "vecchia_common.cuh"

namespace vecchia {
namespace {

// ROLLED: the rolled instance, for 20 < m <= kRolledM on either layout and
// for coords with d > kMaxDim (vecchia_common.cuh).  HETERO:
// the instance launched with noise weights.  Kernel 3 is the one body that
// takes noise as a template parameter: it gathers nothing else through nn_idx,
// and the weights' loads behind a runtime branch cost its homogeneous
// instances 2.5-5% on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), where
// kernels 1 and 2 pay under 1%.
template <int M, bool GENERAL, bool COORDS, bool ROLLED = false, bool HETERO = false>
__global__ void __launch_bounds__(kBlock)
bf_kernel(const float* __restrict__ params, const float* __restrict__ tab_a,
          const float* __restrict__ tab_b, const int* __restrict__ nn_idx,
          const float* __restrict__ v, int n_pad, int m, int dim, int family,
          float* __restrict__ b_out, float* __restrict__ f_out) {
  // the loops over the slots run to M, unrolled; in the ROLLED instance to
  // the call's m, which keeps them rolled
  const int top = ROLLED ? m : M;
  const int chain = blockIdx.y;
  const int site = blockIdx.x * kBlock + threadIdx.x;
  const float* pr = params + chain * kParams;
  const float phi = pr[0];
  const float alpha = pr[1];
  const float jitter = pr[2];
  const int n = static_cast<int>(pr[3]);
  float* b_site = b_out + static_cast<size_t>(chain) * m * n_pad + site;  // m planes
  float* f_site = f_out + static_cast<size_t>(chain) * n_pad + site;
  const MaternSet* set = chain_matern_set<GENERAL>(pr, false);  // before any thread leaves

  if (site >= n) {  // padded site: B = 0, F = 1
#pragma unroll
    for (int i = 0; i < top; ++i) {
      if (i < m) b_site[static_cast<size_t>(i) * n_pad] = 0.0f;
    }
    *f_site = 1.0f;
    return;
  }
  const OwnCoords<COORDS> own = load_own<COORDS>(tab_a, n_pad, site, dim);
  const Guard g(site, m);

  float low[tri(M, 0)];  // strict lower triangle of L, packed by tri(i, k)
  float inv_diag[M];
  float u[M];  // L^-1 c

#pragma unroll
  for (int k = 0; k < top; ++k) {
    // slot k is a real neighbor iff k < m and site > k (identity row
    // otherwise; one past m reads the last slot's planes, Guard)
    const float mk = g.mask(k);
    float nugget = alpha;
    if constexpr (HETERO) {
      nugget = alpha * v[nn_idx[static_cast<size_t>(g.at(k)) * n_pad + site]];
    }
    float acc = 1.0f + mk * (nugget + jitter);
#pragma unroll
    for (int j = 0; j < k; ++j) acc -= low[tri(k, j)] * low[tri(k, j)];
    const float inv = 1.0f / sqrtf(acc);
    inv_diag[k] = inv;
    float au = corr<GENERAL>(family, dist_in<COORDS, ROLLED>(tab_a, tab_b, own, g, k, dim,
                                                            n_pad, site),
                             phi, set) *
               mk;
#pragma unroll
    for (int j = 0; j < k; ++j) au -= low[tri(k, j)] * u[j];
    u[k] = au * inv;
#pragma unroll
    for (int i = k + 1; i < top; ++i) {
      const float mi = g.mask(i);  // mask_i * mask_k, as i > k
      float a = corr<GENERAL>(family, dist_pair<COORDS, ROLLED>(tab_b, g, i, k, dim, n_pad, site),
                              phi, set) *
                mi;
#pragma unroll
      for (int j = 0; j < k; ++j) a -= low[tri(i, j)] * low[tri(k, j)];
      low[tri(i, k)] = a * inv;
    }
  }

  float ff = 1.0f + (HETERO ? alpha * v[site] : alpha);
#pragma unroll
  for (int k = 0; k < top; ++k) ff -= u[k] * u[k];
  *f_site = ff;

  // back-substitution B = L^-T u, last slot first; the call's B has m planes
  float b[M];
#pragma unroll
  for (int i = top - 1; i >= 0; --i) {
    float ab = u[i];
#pragma unroll
    for (int k = i + 1; k < top; ++k) ab -= low[tri(k, i)] * b[k];
    b[i] = ab * inv_diag[i];
    if (i < m) b_site[static_cast<size_t>(i) * n_pad] = b[i];
  }
}

// Validates the launch shape, picks the instance (M >= m for m <= 20; the
// rolled one for larger m and for coords with d > kMaxDim) and launches on
// `stream` without synchronising; returns cudaGetLastError().
template <bool GENERAL, bool COORDS>
int launch_bf(const float* params, const float* tab_a, const float* tab_b, const int* nn_idx,
              const float* v, int n_pad, int m, int dim, int chains, int family, float* b_out,
              float* f_out, void* stream) {
  if (!valid_launch<COORDS>(n_pad, chains, dim) || launch_m(m) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_pad / kBlock, chains);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VECCHIA_BF_LAUNCH(MM, ANY)                                                          \
  if (v != nullptr) {                                                                       \
    bf_kernel<MM, GENERAL, COORDS, ANY, true><<<grid, kBlock, 0, s>>>(                      \
        params, tab_a, tab_b, nn_idx, v, n_pad, m, dim, family, b_out, f_out);              \
  } else {                                                                                  \
    bf_kernel<MM, GENERAL, COORDS, ANY, false><<<grid, kBlock, 0, s>>>(                     \
        params, tab_a, tab_b, nn_idx, v, n_pad, m, dim, family, b_out, f_out);              \
  }
  if (launch_m(m) == kRolledM || (COORDS && dim > kMaxDim)) {
    VECCHIA_BF_LAUNCH(kRolledM, true);
    return static_cast<int>(cudaGetLastError());
  }
  switch (launch_m(m)) {
    case 7: VECCHIA_BF_LAUNCH(7, false); break;
    case 10: VECCHIA_BF_LAUNCH(10, false); break;
    case 15: VECCHIA_BF_LAUNCH(15, false); break;
    case 20: VECCHIA_BF_LAUNCH(20, false); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VECCHIA_BF_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace vecchia
