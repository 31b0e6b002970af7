// Kernel 2 for 32 < m <= kSmemGradM: each (site, chain) system factored by
// one warp in shared memory in float64, on the pieces of kernels 1 and 3's
// shared-memory body (vecchia_large_smem.cuh: SmemGroup, the fill, the
// factor).  The launcher of vecchia_grad_body.cuh sends such calls here;
// above kSmemGradM the cluster body (vecchia_grad_cluster.cuh) takes them.
//
// Replaces, at those m, the Pallas kernel _grad_kernel
// (pynngp_tpu/ops/pallas_bf.py:727, pallas_call l.918, emit_y l.857), whose
// function vecchia_grad_body.cuh states: the six (eight with GENERAL) value
// and derivative sums per (block, chain), and with EMIT_Y B = p and r/F.
//
// What bounded the scratch body (one thread a (site, chain), its state in a
// per-thread slice of a device buffer; 73 ms at n=10,000, m=64, 16 chains,
// 0.4% of its bound, PERF.md): the left-looking factor's ~m^3/3 float64
// loads a system from a buffer far beyond the L2, two back-substitutions
// over the same buffer, and a pair loop that read every pair distance again
// once a chain.  Here no state leaves the SM, and a pair distance is read
// twice a site for all the block's chains.
//
// Design.  A block is `group` warps (up to kMaxGroup chains of one site,
// one system each) and walks the sites blockIdx.x, blockIdx.x + gridDim.x,
// ... (static: each chain's partials have a fixed order).  For each site
// below n:
//   1. Fill (the block): kernel 1's bordered system (rows mp and mp + 1
//      hold c and y_N) and, beside the triangle, two vectors of mp words:
//      dc, the masked d c / d phi, and dcn, the masked d c / d nu (zero
//      unless `with_nu`).
//   2. Each warp on its own system: the factor (u and w come out as rows mp
//      and mp + 1), F = 1 + alpha (v) - u.u and r = y - u.w, then
//      p = L^-T u and q = L^-T w by back-substitution in place over both
//      rows, four slots a step (the corner's broadcasts shared by the two
//      right-hand sides); then by warp reductions p' dC/dalpha p,
//      p' dC/dalpha q and the diagonal-free parts -2 p.dc, -dc.q (and the
//      nu ones), which it adds with 1/F and r/F to its sums; with EMIT_Y it
//      writes B = p and r/F.  Last it overwrites dc and dcn with p and q,
//      packed, and leaves (1/F, r/F) in shared memory.
//   3. Pairs (the block): the threads take the pairs (i, k), i > k, of the
//      real slots, read each pair distance once (or recompute it from the
//      coordinates), evaluate d rho / d phi (and d rho / d nu) once a chain
//      and add 2 p_i p_k dC_ik and (p_i q_k + p_k q_i) dC_ik to the site's
//      terms; the site's sums are linear in them, so each thread weights
//      its terms by the chain's 1/F and r/F and keeps per-chain float64
//      sums across its sites.
// At the end every thread's pair sums go through a warp reduction and the
// block's warps in order, and each warp adds them to its own sums and
// writes one float32 partial a sum, rounded once: deterministic for a
// launch shape.  Padded sites (gsite >= n, the same for the whole block)
// factor nothing and add nothing; with EMIT_Y they write B = 0 and r/F = 0.
// A site's B and r/F depend on its own system alone, so a sharded launch
// gives the unsharded launch's bits (chip_smoke.py path 27).
//
// Memory: smem_grad_doubles(m) words a warp, the triangle and the two
// vectors: 18,944 bytes at m = 64, four warps 75,776 bytes, three blocks an
// SM.  The largest m whose one system fits a block is kSmemGradM = 232.
//
// Numbers: as the scratch body: float64 distances, closed forms
// (ClosedForm64, each chain's 1/phi for d rho / d phi), products, sums,
// factor and solves; the general-nu rho, d rho / d phi and d rho / d nu
// from the float32 Bessel routines; B and r/F rounded to float32 as they
// are stored.
#pragma once

#include <cstddef>

#include "vecchia_large_smem.cuh"

namespace vecchia {
namespace {

// float64 words of one kernel-2 system: the triangle and two vectors of mp.
__host__ __device__ constexpr int smem_grad_doubles(int m) {
  return smem_system_doubles(m) + 2 * smem_mp(m);
}

// The largest m whose one kernel-2 system fits a block's shared memory
// (ops/geometry.py M_SMEM_GRAD computes the same).
constexpr int smem_grad_max_m() {
  int m = kRolledM;
  while (smem_grad_doubles(m + 1) * 8 <= kMaxRingBytes) ++m;
  return m;
}
constexpr int kSmemGradM = smem_grad_max_m();
static_assert(kSmemGradM == 232, "ops/geometry.py M_SMEM_GRAD takes the same value");

// Whether a call of kernel 2 runs this body.
__host__ inline bool smem_grad_launch(int m) { return large_launch(m) && m <= kSmemGradM; }

__host__ inline bool valid_smem_grad(int n_pad, int m, int group, int grid_x, int smem_bytes,
                                     const double* scratch) {
  return valid_systems(n_pad, smem_grad_doubles(m), group, grid_x, smem_bytes, scratch);
}

// p = L^-T u and q = L^-T w in place over rows mp and mp + 1, four slots a
// step from the last (slots >= m hold u = w = 0 and give 0): the 4 x 4
// corner in every lane from broadcast reads, then each lane's earlier slots.
__device__ void smem_back_substitute2(double* a, int mp, int rows) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int i0 = mp - kPanel; i0 >= 0; i0 -= kPanel) {
    double bp[kPanel];
    double bq[kPanel];
#pragma unroll
    for (int c = kPanel - 1; c >= 0; --c) {
      const double* ci = a + smem_col_start(i0 + c, rows) - (i0 + c);  // ci[r] = L[r][i0+c]
      double xp = ci[mp];
      double xq = ci[mp + 1];
#pragma unroll
      for (int c2 = c + 1; c2 < kPanel; ++c2) {
        const double l = ci[i0 + c2];
        xp -= l * bp[c2];
        xq -= l * bq[c2];
      }
      bp[c] = xp * ci[i0 + c];  // times 1/L_ii
      bq[c] = xq * ci[i0 + c];
    }
    __syncwarp();  // every lane has read the step's x
    if (lane < kPanel) {
      double* cl = a + smem_col_start(i0 + lane, rows) - (i0 + lane);
      cl[mp] = lane == 0 ? bp[0] : lane == 1 ? bp[1] : lane == 2 ? bp[2] : bp[3];
      cl[mp + 1] = lane == 0 ? bq[0] : lane == 1 ? bq[1] : lane == 2 ? bq[2] : bq[3];
    }
    for (int j = lane; j < i0; j += 32) {
      double* cj = a + smem_col_start(j, rows) - j;
      const double l0 = cj[i0];
      const double l1 = cj[i0 + 1];
      const double l2 = cj[i0 + 2];
      const double l3 = cj[i0 + 3];
      cj[mp] -= l0 * bp[0] + l1 * bp[1] + l2 * bp[2] + l3 * bp[3];
      cj[mp + 1] -= l0 * bq[0] + l1 * bq[1] + l2 * bq[2] + l3 * bq[3];
    }
    __syncwarp();
  }
}

// Step 3: the block's threads over the site's pairs (i, k), i > k, of the
// real slots (i < lim), q = tri(i, k) the pair plane; each pair's distance
// once, its d rho / d phi (and d rho / d nu) once a chain, against every
// chain's packed p and q at g.vec.  pair[c] gains the site's terms weighted
// by its (1/F, r/F): [sum 2 dlogdet/dphi, dquad/dphi] and, GENERAL, the nu
// ones.
template <bool GENERAL, bool COORDS, int NP>
__device__ __forceinline__ void smem_pairs(const SmemGroup& g, const GroupChains& ch,
                                           const ClosedForm64& shape, const MaternSet* sets,
                                           const GlobalDistances<COORDS>& dist, int lim,
                                           bool with_nu, const double2* site_w,
                                           double (&pair)[kMaxGroup][NP]) {
  double t[kMaxGroup][NP];
#pragma unroll
  for (int c = 0; c < kMaxGroup; ++c) {
#pragma unroll
    for (int j = 0; j < NP; ++j) t[c][j] = 0.0;
  }
  const int pairs = lim * (lim - 1) / 2;
  for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
    int i = static_cast<int>((1.0f + sqrtf(8.0f * q + 1.0f)) * 0.5f);  // tri(i, 0) <= q
    if (i * (i - 1) / 2 > q) {
      --i;
    } else if ((i + 1) * i / 2 <= q) {
      ++i;
    }
    const int k = q - i * (i - 1) / 2;
    const double d = dist.pair(i, k);
#pragma unroll
    for (int c = 0; c < kMaxGroup; ++c) {
      if (c < g.active) {
        const double* pv = g.sys0 + c * g.sys_doubles + g.vec;
        const double* qv = pv + g.mp;
        const double pi = pv[i];
        const double pk = pv[k];
        const double two_pp = 2.0 * pi * pk;
        const double pq = pi * qv[k] + pk * qv[i];
        if constexpr (GENERAL) {
          const float d32 = static_cast<float>(d);
          const double dcik = rho_drho_general(d32, &sets[c].at).y;
          t[c][0] += two_pp * dcik;
          t[c][1] += pq * dcik;
          if (with_nu) {
            const double dcnik = drho_dnu_general(d32, sets + c);
            t[c][2] += two_pp * dcnik;
            t[c][3] += pq * dcnik;
          }
        } else {
          const double tt = fmin(ch.scale[c] * d, shape.t_max);
          const double dcik =
              ch.inv_phi[c] * (tt * (shape.d1 + tt * (shape.d2 + tt * shape.d3)) * shape.decay(tt));
          t[c][0] += two_pp * dcik;
          t[c][1] += pq * dcik;
        }
      }
    }
  }
  // d(log F) = dF / F, d(r^2/F) = 2 (r/F) dr - (r/F)^2 dF
#pragma unroll
  for (int c = 0; c < kMaxGroup; ++c) {
    if (c < g.active) {
      const double2 w = site_w[c];  // (1/F, r/F)
#pragma unroll
      for (int j = 0; j < NP; j += 2) {
        pair[c][j] += t[c][j] * w.x;
        pair[c][j + 1] += 2.0 * w.y * t[c][j + 1] - w.y * w.y * t[c][j];
      }
    }
  }
}

// Kernel 2 for 32 < m <= kSmemGradM: the NV value and derivative sums per
// (block, chain) over the sites < n, part[(v chains + chain) gridDim.x +
// blockIdx.x]; with EMIT_Y also B = p (C, m, n_pad) and r/F (C, n_pad).
template <bool EMIT_Y, bool GENERAL, bool COORDS>
__global__ void __launch_bounds__(kTile * kMaxGroup)
grad_smem_kernel(const float* __restrict__ params, const float* __restrict__ tab_a,
                 const float* __restrict__ tab_b, const int* __restrict__ nn_idx,
                 const float* __restrict__ y_all, int y_stride, const float* __restrict__ v,
                 int n_pad, int m, int dim, int chains, int family, bool with_nu,
                 float* __restrict__ part, float* __restrict__ b_out,
                 float* __restrict__ rof_out) {
  constexpr int NV = GENERAL ? 8 : 6;
  constexpr int NP = GENERAL ? 4 : 2;  // the pair terms a chain: sums 2, 3 (and 6, 7)
  extern __shared__ __align__(16) double systems[];
  __shared__ double2 site_w[kMaxGroup];  // each warp's (1/F, r/F) at the site
  const SmemGroup g = smem_group(systems, chains, m, smem_grad_doubles(m));
  const MaternSet* sets = group_matern_sets<GENERAL>(params, g, with_nu);
  const GroupChains ch = group_chains(params, g, GENERAL ? kMaternGeneral : family, y_all,
                                      y_stride);
  const ClosedForm64 shape = GENERAL ? ClosedForm64{} : closed_form64(family, 1.0f);
  const bool mine = g.warp < g.active;
  const int chain = g.c0 + min(g.warp, g.active - 1);
  const double alpha = params[chain * kParams + 1];
  const int n = static_cast<int>(params[g.c0 * kParams + 3]);
  const int off = static_cast<int>(params[g.c0 * kParams + 5]);  // the shard's first site
  const float* y = y_all + static_cast<size_t>(chain) * y_stride;
  const int mp = g.mp;
  double* a = g.sys0 + g.warp * g.sys_doubles;
  double* pv = a + g.vec;  // dc, then p
  double* qv = pv + mp;    // dcn, then q
  double acc[NV];          // the warp's sums of its sites' own terms, the same in every lane
#pragma unroll
  for (int s = 0; s < NV; ++s) acc[s] = 0.0;
  double pair[kMaxGroup][NP];  // this thread's pair terms by chain
#pragma unroll
  for (int c = 0; c < kMaxGroup; ++c) {
#pragma unroll
    for (int j = 0; j < NP; ++j) pair[c][j] = 0.0;
  }
  for (int site = blockIdx.x; site < n_pad; site += gridDim.x) {
    const int gsite = site + off;
    if (gsite >= n) {  // the same for the whole block
      if (EMIT_Y && mine) {
        for (int i = g.lane; i < m; i += 32) {
          b_out[(static_cast<size_t>(chain) * m + i) * n_pad + site] = 0.0f;
        }
        if (g.lane == 0) rof_out[static_cast<size_t>(chain) * n_pad + site] = 0.0f;
      }
      continue;
    }
    const int lim = min(gsite, m);
    const GlobalDistances<COORDS> dist(tab_a, tab_b, dim, n_pad, site);
    smem_fill<GENERAL, COORDS, true, true>(g, ch, shape, sets, dist, nn_idx, v, n_pad, site,
                                           lim, with_nu);
    __syncthreads();
    if (mine) {
      smem_factor(a, mp, g.rows, g.rows);
      double uu = 0.0;
      double uw = 0.0;
      for (int j = g.lane; j < mp; j += 32) {
        const double* col = a + smem_col_start(j, g.rows) - j;
        uu += col[mp] * col[mp];
        uw += col[mp] * col[mp + 1];
      }
      uu = warp_total(uu);
      uw = warp_total(uw);
      const double own_v = v != nullptr ? static_cast<double>(v[gsite]) : 1.0;
      const double ff = 1.0 + alpha * own_v - uu;
      const double r = y[gsite] - uw;
      smem_back_substitute2(a, mp, g.rows);
      // p' dC/dalpha p and p' dC/dalpha q (dC/dalpha: the masked identity,
      // diag(v) at the neighbors with v), -2 p.dc, -dc.q and the nu ones;
      // then p and q packed over dc and dcn for the pair pass
      double s[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
      for (int j = g.lane; j < mp; j += 32) {
        const double* col = a + smem_col_start(j, g.rows) - j;
        const double p = col[mp];  // exactly 0 on slots >= lim
        const double q = col[mp + 1];
        const double vj =
            v != nullptr && j < lim ? static_cast<double>(v[nn_idx[static_cast<size_t>(j) * n_pad + site]])
                                    : 1.0;
        s[0] += vj * p * p;
        s[1] += vj * p * q;
        s[2] -= 2.0 * p * pv[j];
        s[3] -= pv[j] * q;
        if constexpr (GENERAL) {
          s[4] -= 2.0 * p * qv[j];
          s[5] -= qv[j] * q;
        }
        if constexpr (EMIT_Y) {
          if (j < m) b_out[(static_cast<size_t>(chain) * m + j) * n_pad + site] = static_cast<float>(p);
        }
        pv[j] = p;
        qv[j] = q;
      }
#pragma unroll
      for (int t = 0; t < 6; ++t) {
        if (t < 4 || GENERAL) s[t] = warp_total(s[t]);
      }
      const double inv_f = 1.0 / ff;
      const double rof = r * inv_f;
      const double ratio2 = rof * rof;
      const double df_a = own_v + s[0];
      acc[0] += log(ff);
      acc[1] += r * rof;
      acc[2] += s[2] * inv_f;
      acc[3] += 2.0 * rof * s[3] - ratio2 * s[2];
      acc[4] += df_a * inv_f;
      acc[5] += 2.0 * rof * s[1] - ratio2 * df_a;
      if constexpr (GENERAL) {
        acc[6] += s[4] * inv_f;
        acc[7] += 2.0 * rof * s[5] - ratio2 * s[4];
      }
      if (g.lane == 0) {
        site_w[g.warp] = make_double2(inv_f, rof);
        if constexpr (EMIT_Y) {
          rof_out[static_cast<size_t>(chain) * n_pad + site] = static_cast<float>(rof);
        }
      }
    }
    __syncthreads();  // p, q, 1/F and r/F of every warp are in
    smem_pairs<GENERAL, COORDS, NP>(g, ch, shape, sets, dist, lim, with_nu, site_w, pair);
    __syncthreads();  // every thread is done with the systems before the next fill
  }
  // the block's pair sums of each chain: each warp's butterfly, then the
  // warps in order, in the systems' words (free now)
  double* red = systems;  // red[(warp * kMaxGroup + c) * NP + j]
#pragma unroll
  for (int c = 0; c < kMaxGroup; ++c) {
    if (c < g.active) {
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const double x = warp_total(pair[c][j]);
        if (g.lane == 0) red[(g.warp * kMaxGroup + c) * NP + j] = x;
      }
    }
  }
  __syncthreads();
  if (mine && g.lane == 0) {
    const int warps = blockDim.x >> 5;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      double x = 0.0;
      for (int w = 0; w < warps; ++w) x += red[(w * kMaxGroup + g.warp) * NP + j];
      acc[j < 2 ? 2 + j : 4 + j] += x;  // sums 2, 3, 6, 7
    }
#pragma unroll
    for (int s = 0; s < NV; ++s) {
      part[(s * chains + chain) * gridDim.x + blockIdx.x] = static_cast<float>(acc[s]);
    }
  }
}

// The launch (valid_smem_grad checked by the caller); returns
// cudaGetLastError().
template <bool EMIT_Y, bool GENERAL, bool COORDS>
int launch_grad_smem(const float* params, const float* tab_a, const float* tab_b,
                     const int* nn_idx, const float* y, int y_stride, const float* v, int n_pad,
                     int m, int dim, int chains, int family, bool with_nu, int group,
                     int grid_x, int smem_bytes, float* part, float* b_out, float* rof_out,
                     cudaStream_t st) {
  auto kern = grad_smem_kernel<EMIT_Y, GENERAL, COORDS>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<dim3(grid_x, (chains + group - 1) / group), kTile * group, smem_bytes, st>>>(
      params, tab_a, tab_b, nn_idx, y, y_stride, v, n_pad, m, dim, chains, family, with_nu,
      part, b_out, rof_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace vecchia
