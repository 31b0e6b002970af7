// The scratch bodies of the three kernels: every call with m > kRolledM
// that neither a shared-memory body nor the cluster body takes (kernels 1
// and 3 above kClusterM, vecchia_large_cluster.cuh; kernel 2 above
// kClusterGradM, vecchia_grad_cluster.cuh), on either table layout, closed-form rho or the general-nu Matern, with or
// without noise weights.  Each source's launcher sends such a call here.
//
// Why another design.  The tile ring (vecchia_tile.cuh) stages m(m+1)/2 + m
// planes a tile: at m = 64 on the dist layout one stage is (64 + 2,016 +
// 64 + 64) planes of 32 floats, 283 KB, where a block may take 227 KB for
// both.  And the unrolled or rolled instances keep a (site, chain)'s factor
// in registers or local memory sized at compile time.  So these instances
// run one thread per (site, chain), as the kernels did before the tile ring,
// read every distance, neighbor id, y and v where they use them from global
// memory, and keep the factor and its companions (1/diag, u, w, the
// derivatives of c, and p, q or B written over u and w) in a per-thread
// slice of a device scratch buffer: element j of thread g at
// scratch[j * threads + g], so a warp's 32 threads touch 32 consecutive
// doubles.  Loops run to the call's m.  A block is kBlock sites of one chain
// (gridDim.y = chains); grid_x blocks walk the sites in a grid-stride loop,
// so the buffer is sized by the threads of the launch, not by its sites:
// m(m-1)/2 + 6m doubles a thread (LargeState), allocated and sized by the
// wrapper (ops/geometry.py large_geometry).
//
// Numbers: the same recurrence as the tile bodies, in float64: the
// distances recomputed from coordinates, the closed forms of rho
// (ClosedForm64), every product and sum, and the state in the scratch
// buffer; the general-nu rho alone comes from the float32 Bessel routines.
// B, F, r and r/F are rounded to float32 as they are stored.  In float32,
// at m = 64 on the coords layout, the y cotangent formed from kernel 2's
// planes missed its limit (rtol 2e-3, atol 2e-4) by 1.17x, and by 1.28x
// with the sums alone in float64 (NVIDIA H100 80GB HBM3; PERF.md): each
// site's cotangent sums ~200 children's B r/F, and float32 rho and state
// leave more error in those than the limit allows at that m; in float64 the
// worst ratio was 0.008.  Float64 cost the instances ~30% at m = 64
// (kernel 1 40 -> 52 ms at n=10,000, 16 chains), where they run at 0.4% of
// their bound: a simple design, left for a later change to make fast.
// Kernels 1 and 2
// write one partial of each sum per (block, chain), a block's threads
// summed in a fixed order (warp shuffles, then the four warps in turn):
// deterministic, and the wrapper sums the (C, grid_x) partials in float64
// as it does the tile kernels'.  Padded sites follow the tile bodies: kernel
// 1 writes F and r for them and leaves them out of the sums, kernel 2 writes
// B = 0 and r/F = 0, kernel 3 writes B = 0 and F = 1 and factors nothing.
#pragma once

#include <cstddef>

#include "vecchia_tile.cuh"

namespace vecchia {
namespace {

// One thread's distances on global memory: from its site to slot k, and
// between slots i and k (i > k), read from the distance planes or recomputed
// from the coordinate planes, any d, in float64.
template <bool COORDS>
struct GlobalDistances {
  const float* a;  // the site's column of table a
  const float* b;  // and of table b
  int dim;
  size_t n_pad;

  __device__ __forceinline__ GlobalDistances(const float* __restrict__ tab_a,
                                             const float* __restrict__ tab_b, int dim_,
                                             int n_pad_, int site)
      : a(tab_a + site), b(tab_b + site), dim(dim_), n_pad(n_pad_) {}

  __device__ __forceinline__ double in(int k) const {
    if constexpr (COORDS) {
      double acc = 0.0;
#pragma unroll 1
      for (int c = 0; c < dim; ++c) {
        const double diff = static_cast<double>(a[c * n_pad]) - b[(k * dim + c) * n_pad];
        acc += diff * diff;
      }
      return sqrt(acc);
    } else {
      return a[k * n_pad];
    }
  }

  __device__ __forceinline__ double pair(int i, int k) const {
    if constexpr (COORDS) {
      double acc = 0.0;
#pragma unroll 1
      for (int c = 0; c < dim; ++c) {
        const double diff =
            static_cast<double>(b[(i * dim + c) * n_pad]) - b[(k * dim + c) * n_pad];
        acc += diff * diff;
      }
      return sqrt(acc);
    } else {
      return b[static_cast<size_t>(tri(i, k)) * n_pad];
    }
  }
};

// rho and d rho / d phi of the closed forms in float64: ClosedForm's
// formula (vecchia_tile.cuh) with float64 coefficients.
struct ClosedForm64 {
  double scale, t_max, c1, c2, c3, e1, e2, d1, d2, d3;

  __device__ __forceinline__ double arg(double d) const { return fmin(scale * d, t_max); }
  __device__ __forceinline__ double decay(double t) const { return exp(-(t * (e1 + e2 * t))); }
  __device__ __forceinline__ double rho(double d) const {
    const double t = arg(d);
    return (1.0 + t * (c1 + t * (c2 + t * c3))) * decay(t);
  }
  __device__ __forceinline__ double drho(double d) const {
    const double t = arg(d);
    return t * (d1 + t * (d2 + t * d3)) * decay(t);
  }
};

__device__ __forceinline__ ClosedForm64 closed_form64(int family, float phi) {
  const double inv = 1.0 / phi;
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  switch (family) {
    case kSqExp:
      return {inv, inf, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 2.0 * inv, 0.0};
    case kSpherical:
      return {inv, 1.0, -1.5, 0.0, 0.5, 0.0, 0.0, 1.5 * inv, 0.0, -1.5 * inv};
    case kMatern32:
      return {1.7320508075688772 * inv, inf, 1.0, 0.0, 0.0, 1.0, 0.0, 0.0, inv, 0.0};
    case kMatern52:
      return {2.23606797749979 * inv, inf, 1.0, 1.0 / 3.0, 0.0, 1.0, 0.0, 0.0, inv / 3.0,
              inv / 3.0};
    default:  // kExponential, kMatern12
      return {inv, inf, 0.0, 0.0, 0.0, 1.0, 0.0, inv, 0.0, 0.0};
  }
}

// rho of either set: the closed form in float64, or the general-nu Matern
// through the block's MaternSet (float32)
template <bool GENERAL>
__device__ __forceinline__ double large_rho(const ClosedForm64& cf, double d,
                                            const MaternSet* set) {
  if constexpr (GENERAL) {
    return rho_general(static_cast<float>(d), &set->at);
  } else {
    return cf.rho(d);
  }
}

// One thread's state in the scratch buffer.
struct LargeState {
  double* base;   // element 0 of this thread
  size_t stride;  // the launch's threads
  int m;

  // the strict lower triangle of L, packed by tri(i, k)
  __device__ __forceinline__ double& low(int i, int k) const {
    return base[static_cast<size_t>(tri(i, k)) * stride];
  }
  // vector `which` (kInv, kU, ...) at slot k; six vectors of m
  __device__ __forceinline__ double& vec(int which, int k) const {
    return base[static_cast<size_t>(tri(m, 0) + which * m + k) * stride];
  }
};

enum LargeVector : int { kInv = 0, kU = 1, kW = 2, kDc = 3, kDcn = 4 };

__device__ __forceinline__ LargeState large_state(double* __restrict__ scratch, int m) {
  const size_t threads = static_cast<size_t>(gridDim.x) * gridDim.y * blockDim.x;
  const size_t g = (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * blockDim.x +
                   threadIdx.x;
  return {scratch + g, threads, m};
}

// Builds and factors one (site, chain) system into `st`: L (strict lower),
// 1/diag, u = L^-1 c; with WITH_Y w = L^-1 y_N; with WITH_D the masked
// d c / d phi (and, GENERAL with `with_nu`, d c / d nu; zeros without).
// `site` indexes the shard's tables, `gsite` = site + off is the global
// index: slot k is a real neighbor iff min(gsite, m) > k; invalid slots are
// identity rows.
template <bool GENERAL, bool COORDS, bool WITH_Y, bool WITH_D>
__device__ void large_factor(const LargeState& st, const GlobalDistances<COORDS>& dist,
                             const int* __restrict__ nn_idx, const float* __restrict__ y,
                             const float* __restrict__ v, int n_pad, int m, int site,
                             int gsite, const ClosedForm64& cf, float alpha, float jitter,
                             const MaternSet* set, bool with_nu) {
  const int lim = min(gsite, m);
#pragma unroll 1
  for (int k = 0; k < m; ++k) {
    const double mk = lim > k ? 1.0 : 0.0;
    const int nbr = (WITH_Y || v != nullptr) ? nn_idx[static_cast<size_t>(k) * n_pad + site] : 0;
    const double nugget = v != nullptr ? static_cast<double>(alpha) * v[nbr] : alpha;
    double acc = 1.0 + mk * (nugget + jitter);
#pragma unroll 1
    for (int j = 0; j < k; ++j) acc -= st.low(k, j) * st.low(k, j);
    const double inv = rsqrt(acc);
    st.vec(kInv, k) = inv;
    const double dk = dist.in(k);
    double au;
    if constexpr (WITH_D && GENERAL) {
      const float2 rd = rho_drho_general(static_cast<float>(dk), &set->at);
      au = rd.x * mk;
      st.vec(kDc, k) = rd.y * mk;
      st.vec(kDcn, k) = with_nu ? drho_dnu_general(static_cast<float>(dk), set) * mk : 0.0;
    } else {
      au = large_rho<GENERAL>(cf, dk, set) * mk;
      if constexpr (WITH_D) st.vec(kDc, k) = cf.drho(dk) * mk;
    }
    double aw = WITH_Y ? y[nbr] * mk : 0.0;
#pragma unroll 1
    for (int j = 0; j < k; ++j) {
      au -= st.low(k, j) * st.vec(kU, j);
      if constexpr (WITH_Y) aw -= st.low(k, j) * st.vec(kW, j);
    }
    st.vec(kU, k) = au * inv;
    if constexpr (WITH_Y) st.vec(kW, k) = aw * inv;
#pragma unroll 1
    for (int i = k + 1; i < m; ++i) {
      const double mi = lim > i ? 1.0 : 0.0;  // mask_i * mask_k, as i > k
      double a = large_rho<GENERAL>(cf, dist.pair(i, k), set) * mi;
#pragma unroll 1
      for (int j = 0; j < k; ++j) a -= st.low(i, j) * st.low(k, j);
      st.low(i, k) = a * inv;
    }
  }
}

// Back-substitution L^-T x in place over vector `which` (u -> p or B, w -> q),
// last slot first.
__device__ __forceinline__ void large_back_substitute(const LargeState& st, int which) {
#pragma unroll 1
  for (int i = st.m - 1; i >= 0; --i) {
    double a = st.vec(which, i);
#pragma unroll 1
    for (int k = i + 1; k < st.m; ++k) a -= st.low(k, i) * st.vec(which, k);
    st.vec(which, i) = a * st.vec(kInv, i);
  }
}

// The block's sum of each of vals[0..NV) (every thread of the block calls
// it): each warp's shuffle tree, then thread 0 adds the warps in order and
// writes the v-th sum to out[v * out_stride + out_index].
template <int NV>
__device__ __forceinline__ void block_sum_store(const float (&vals)[NV], float* out,
                                                int out_stride, int out_index) {
  __shared__ float warp_sums[NV][kBlock / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    float s = vals[v];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) warp_sums[v][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float s = 0.0f;
      for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += warp_sums[v][w];
      out[v * out_stride + out_index] = s;
    }
  }
}

// The chain's parameters, as every large-m kernel starts.
struct LargeChain {
  int chain;
  float phi, alpha, jitter;
  int n;
  int off;  // the shard's first global site
  const float* pr;

  __device__ __forceinline__ explicit LargeChain(const float* __restrict__ params)
      : chain(blockIdx.y), pr(params + blockIdx.y * kParams) {
    phi = pr[0];
    alpha = pr[1];
    jitter = pr[2];
    n = static_cast<int>(pr[3]);
    off = static_cast<int>(pr[5]);
  }
};

// Kernel 1 at large m: F and r per (chain, site), partials of sum log F and
// sum r^2/F per (block, chain) over the sites < n.
template <bool GENERAL, bool COORDS>
__global__ void __launch_bounds__(kBlock)
suffstats_large_kernel(const float* __restrict__ params, const float* __restrict__ tab_a,
                       const float* __restrict__ tab_b, const int* __restrict__ nn_idx,
                       const float* __restrict__ y_all, int y_stride,
                       const float* __restrict__ v, int n_pad, int m, int dim, int family,
                       double* __restrict__ scratch, float* __restrict__ f_out,
                       float* __restrict__ r_out, float* __restrict__ part) {
  const LargeChain c(params);
  const MaternSet* set = chain_matern_set<GENERAL>(c.pr, false);
  const ClosedForm64 cf = GENERAL ? ClosedForm64{} : closed_form64(family, c.phi);
  const float* y = y_all + static_cast<size_t>(c.chain) * y_stride;
  const LargeState st = large_state(scratch, m);
  float sums[2] = {0.0f, 0.0f};
  // the block's sites, then grid_x blocks further on
  for (int site = blockIdx.x * kBlock + threadIdx.x; site < n_pad; site += gridDim.x * kBlock) {
    const GlobalDistances<COORDS> dist(tab_a, tab_b, dim, n_pad, site);
    const int gsite = site + c.off;
    large_factor<GENERAL, COORDS, true, false>(st, dist, nn_idx, y, v, n_pad, m, site, gsite,
                                               cf, c.alpha, c.jitter, set, false);
    double ff = 1.0 + (v != nullptr ? static_cast<double>(c.alpha) * v[gsite] : c.alpha);
    double bdoty = 0.0;
#pragma unroll 1
    for (int k = 0; k < m; ++k) {
      const double u = st.vec(kU, k);
      ff -= u * u;
      bdoty += u * st.vec(kW, k);
    }
    const bool valid = gsite < c.n;
    const double resid = (valid ? y[gsite] : 0.0) - bdoty;
    f_out[static_cast<size_t>(c.chain) * n_pad + site] = static_cast<float>(ff);
    r_out[static_cast<size_t>(c.chain) * n_pad + site] = static_cast<float>(resid);
    sums[0] += valid ? static_cast<float>(log(ff)) : 0.0f;
    sums[1] += valid ? static_cast<float>(resid * resid / ff) : 0.0f;
  }
  block_sum_store<2>(sums, part, gridDim.y * gridDim.x, c.chain * gridDim.x + blockIdx.x);
}

// Kernel 2 at large m: the six (closed form) or eight (GENERAL) value and
// derivative sums of vecchia_grad_body.cuh per (block, chain); with EMIT_Y
// also B = p (C, m, n_pad) and r/F (C, n_pad).
template <bool EMIT_Y, bool GENERAL, bool COORDS>
__global__ void __launch_bounds__(kBlock)
grad_large_kernel(const float* __restrict__ params, const float* __restrict__ tab_a,
                  const float* __restrict__ tab_b, const int* __restrict__ nn_idx,
                  const float* __restrict__ y_all, int y_stride, const float* __restrict__ v,
                  int n_pad, int m, int dim, int family, bool with_nu,
                  double* __restrict__ scratch, float* __restrict__ part,
                  float* __restrict__ b_out, float* __restrict__ rof_out) {
  constexpr int NV = GENERAL ? 8 : 6;
  const LargeChain c(params);
  const MaternSet* set = chain_matern_set<GENERAL>(c.pr, with_nu);
  const ClosedForm64 cf = GENERAL ? ClosedForm64{} : closed_form64(family, c.phi);
  const float* y = y_all + static_cast<size_t>(c.chain) * y_stride;
  const LargeState st = large_state(scratch, m);
  float acc[NV] = {};
  // the block's sites, then grid_x blocks further on
  for (int site = blockIdx.x * kBlock + threadIdx.x; site < n_pad; site += gridDim.x * kBlock) {
    const GlobalDistances<COORDS> dist(tab_a, tab_b, dim, n_pad, site);
    const int gsite = site + c.off;
    large_factor<GENERAL, COORDS, true, true>(st, dist, nn_idx, y, v, n_pad, m, site, gsite,
                                              cf, c.alpha, c.jitter, set, with_nu);
    const bool valid = gsite < c.n;
    const int lim = min(gsite, m);
    double ff = 1.0 + (v != nullptr ? static_cast<double>(c.alpha) * v[gsite] : c.alpha);
    double r = valid ? y[gsite] : 0.0;
#pragma unroll 1
    for (int k = 0; k < m; ++k) {
      const double u = st.vec(kU, k);
      ff -= u * u;
      r -= u * st.vec(kW, k);
    }
    // p = L^-T u over u, q = L^-T w over w (exactly zero on invalid slots);
    // dC/dalpha is the masked identity, diag(v) at the neighbors with v
    large_back_substitute(st, kU);
    large_back_substitute(st, kW);
    double pp = 0.0;
    double pq = 0.0;
    double df_phi = 0.0;
    double dr_phi = 0.0;
    double df_nu = 0.0;
    double dr_nu = 0.0;
#pragma unroll 1
    for (int i = 0; i < m; ++i) {
      const double p = st.vec(kU, i);
      const double q = st.vec(kW, i);
      const double vi = v != nullptr ? v[nn_idx[static_cast<size_t>(i) * n_pad + site]] : 1.0;
      pp += vi * p * p;
      pq += vi * p * q;
      if constexpr (EMIT_Y) {
        b_out[(static_cast<size_t>(c.chain) * m + i) * n_pad + site] =
            valid ? static_cast<float>(p) : 0.0f;
      }
      df_phi -= 2.0 * p * st.vec(kDc, i);
      dr_phi -= st.vec(kDc, i) * q;
      if constexpr (GENERAL) {
        df_nu -= 2.0 * p * st.vec(kDcn, i);
        dr_nu -= st.vec(kDcn, i) * q;
      }
    }
    // dC/dphi and dC/dnu have no diagonal
#pragma unroll 1
    for (int i = 0; i < m; ++i) {
      const double pi = st.vec(kU, i);
      const double qi = st.vec(kW, i);
#pragma unroll 1
      for (int j = i + 1; j < m; ++j) {
        const double mj = lim > j ? 1.0 : 0.0;  // mask_i * mask_j, as j > i
        const double pj = st.vec(kU, j);
        const double qj = st.vec(kW, j);
        const double dij = dist.pair(j, i);
        if constexpr (GENERAL) {
          const float dij32 = static_cast<float>(dij);
          const double dcij = rho_drho_general(dij32, &set->at).y * mj;
          df_phi += 2.0 * pi * pj * dcij;
          dr_phi += (pi * qj + pj * qi) * dcij;
          if (with_nu) {
            const double dcnij = drho_dnu_general(dij32, set) * mj;
            df_nu += 2.0 * pi * pj * dcnij;
            dr_nu += (pi * qj + pj * qi) * dcnij;
          }
        } else {
          const double dcij = cf.drho(dij) * mj;
          df_phi += 2.0 * pi * pj * dcij;
          dr_phi += (pi * qj + pj * qi) * dcij;
        }
      }
    }
    const double df_a = (v != nullptr ? v[gsite] : 1.0) + pp;
    const double dr_a = pq;
    const double inv_f = valid ? 1.0 / ff : 0.0;
    const double r_over_f = r * inv_f;
    const double ratio2 = r_over_f * r_over_f;
    if constexpr (EMIT_Y) {
      rof_out[static_cast<size_t>(c.chain) * n_pad + site] =
          valid ? static_cast<float>(r_over_f) : 0.0f;
    }
    acc[0] += valid ? static_cast<float>(log(ff)) : 0.0f;
    acc[1] += static_cast<float>(r * r_over_f);
    acc[2] += static_cast<float>(df_phi * inv_f);
    acc[3] += static_cast<float>(2.0 * r_over_f * dr_phi - ratio2 * df_phi);
    acc[4] += static_cast<float>(df_a * inv_f);
    acc[5] += static_cast<float>(2.0 * r_over_f * dr_a - ratio2 * df_a);
    if constexpr (GENERAL) {
      acc[6] += static_cast<float>(df_nu * inv_f);
      acc[7] += static_cast<float>(2.0 * r_over_f * dr_nu - ratio2 * df_nu);
    }
  }
  block_sum_store<NV>(acc, part, gridDim.y * gridDim.x, c.chain * gridDim.x + blockIdx.x);
}

// Kernel 3 at large m: B (C, m, n_pad) and F (C, n_pad); padded sites B = 0,
// F = 1.
template <bool GENERAL, bool COORDS>
__global__ void __launch_bounds__(kBlock)
bf_large_kernel(const float* __restrict__ params, const float* __restrict__ tab_a,
                const float* __restrict__ tab_b, const int* __restrict__ nn_idx,
                const float* __restrict__ v, int n_pad, int m, int dim, int family,
                double* __restrict__ scratch, float* __restrict__ b_out,
                float* __restrict__ f_out) {
  const LargeChain c(params);
  const MaternSet* set = chain_matern_set<GENERAL>(c.pr, false);
  const ClosedForm64 cf = GENERAL ? ClosedForm64{} : closed_form64(family, c.phi);
  const LargeState st = large_state(scratch, m);
  // the block's sites, then grid_x blocks further on
  for (int site = blockIdx.x * kBlock + threadIdx.x; site < n_pad; site += gridDim.x * kBlock) {
    float* b_site = b_out + static_cast<size_t>(c.chain) * m * n_pad + site;  // m planes
    float* f_site = f_out + static_cast<size_t>(c.chain) * n_pad + site;
    const int gsite = site + c.off;
    if (gsite >= c.n) {
#pragma unroll 1
      for (int i = 0; i < m; ++i) b_site[static_cast<size_t>(i) * n_pad] = 0.0f;
      *f_site = 1.0f;
      continue;
    }
    const GlobalDistances<COORDS> dist(tab_a, tab_b, dim, n_pad, site);
    large_factor<GENERAL, COORDS, false, false>(st, dist, nn_idx, nullptr, v, n_pad, m, site,
                                                gsite, cf, c.alpha, c.jitter, set, false);
    double ff = 1.0 + (v != nullptr ? static_cast<double>(c.alpha) * v[gsite] : c.alpha);
#pragma unroll 1
    for (int k = 0; k < m; ++k) ff -= st.vec(kU, k) * st.vec(kU, k);
    *f_site = static_cast<float>(ff);
    large_back_substitute(st, kU);  // B = L^-T u
#pragma unroll 1
    for (int i = 0; i < m; ++i) {
      b_site[static_cast<size_t>(i) * n_pad] = static_cast<float>(st.vec(kU, i));
    }
  }
}

// The launches (valid_large checked by the caller); return cudaGetLastError().
template <bool GENERAL, bool COORDS>
int launch_suffstats_large(const float* params, const float* tab_a, const float* tab_b,
                           const int* nn_idx, const float* y, int y_stride, const float* v,
                           int n_pad, int m, int dim, int chains, int family, int grid_x,
                           double* scratch, float* f_out, float* r_out, float* part,
                           cudaStream_t st) {
  suffstats_large_kernel<GENERAL, COORDS><<<dim3(grid_x, chains), kBlock, 0, st>>>(
      params, tab_a, tab_b, nn_idx, y, y_stride, v, n_pad, m, dim, family, scratch, f_out,
      r_out, part);
  return static_cast<int>(cudaGetLastError());
}

template <bool EMIT_Y, bool GENERAL, bool COORDS>
int launch_grad_large(const float* params, const float* tab_a, const float* tab_b,
                      const int* nn_idx, const float* y, int y_stride, const float* v,
                      int n_pad, int m, int dim, int chains, int family, bool with_nu,
                      int grid_x, double* scratch, float* part, float* b_out, float* rof_out,
                      cudaStream_t st) {
  grad_large_kernel<EMIT_Y, GENERAL, COORDS><<<dim3(grid_x, chains), kBlock, 0, st>>>(
      params, tab_a, tab_b, nn_idx, y, y_stride, v, n_pad, m, dim, family, with_nu, scratch,
      part, b_out, rof_out);
  return static_cast<int>(cudaGetLastError());
}

template <bool GENERAL, bool COORDS>
int launch_bf_large(const float* params, const float* tab_a, const float* tab_b,
                    const int* nn_idx, const float* v, int n_pad, int m, int dim, int chains,
                    int family, int grid_x, double* scratch, float* b_out, float* f_out,
                    cudaStream_t st) {
  bf_large_kernel<GENERAL, COORDS><<<dim3(grid_x, chains), kBlock, 0, st>>>(
      params, tab_a, tab_b, nn_idx, v, n_pad, m, dim, family, scratch, b_out, f_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace vecchia
