// Kernel 2 for kSmemGradM < m <= kClusterGradM: each (site, chain) system
// factored by one thread-block cluster on the pieces of kernels 1 and 3's
// cluster body (vecchia_large_cluster.cuh: the share, the fill, the panel
// factor, the border sums, the back-substitution).  The launcher of
// vecchia_grad_body.cuh sends such calls here, between the shared-memory
// body (vecchia_grad_smem.cuh, a warp a system, up to kSmemGradM = 232) and
// the scratch body (vecchia_large_m.cuh, above kClusterGradM).
//
// Replaces, at those m, the Pallas kernel _grad_kernel
// (pynngp_tpu/ops/pallas_bf.py:727, pallas_call l.918, emit_y l.857), whose
// function vecchia_grad_body.cuh states: the six (eight with GENERAL) value
// and derivative sums per (cluster, chain), and with EMIT_Y B = p and r/F.
//
// What bounded the scratch body here (one thread a (site, chain), its state
// in a per-thread slice of a device buffer): the left-looking factor's
// ~m^3/3 dependent float64 loads a system from a buffer far beyond the L2,
// two more passes of m^2/2 loads over it for p and q, and a pair loop that
// read every pair distance again, once a chain.
//
// Design.  A cluster of cluster_blocks(m) blocks takes one (chain, site)
// system at a time, walking its chain's sites in a static stride, as
// kernels 1 and 3 do.  For each site below n:
//   1. Fill and factor kernel 1's bordered system (rows mp and mp + 1 hold c
//      and y_N), so that rows mp and mp + 1 of the factor are u = L^-1 c and
//      w = L^-1 y_N; each block sums u.u and u.w over its own columns.
//   2. p = L^-T u and q = L^-T w together, kernel 3's back-substitution over
//      rows mp and mp + 1: the owner of panel j solves its P unknowns of
//      both (threads 0 and 1, the corner's reads shared), a cluster barrier,
//      and every block copies the P solved values of each row from the owner
//      into p and q in its own staging buffer (free after the factor) and
//      subtracts them from its earlier columns' right-hand sides.  So at the
//      end every block holds all of p and q.
//   3. Each block over its own indices i: v_i p_i^2, v_i p_i q_i, -2 p.dc and
//      -dc.q (and the nu ones), dc_i and dcn_i computed from the tables where
//      used; with EMIT_Y it writes B = p there.  Then the pairs (i, k), i > k,
//      of its own columns k (the snake order balances them as it balances the
//      factor's trailing work): each pair distance read or recomputed once in
//      float64, d rho / d phi (and d rho / d nu) once, 2 p_i p_k dC_ik and
//      (p_i q_k + p_k q_i) dC_ik added.
//   4. Each block reduces its terms in a fixed order (warps, then the warps
//      in turn); block rank 0 adds the blocks' u.u, u.w and terms in rank
//      order through distributed shared memory, forms F, r and the site's
//      sums as the scratch body does, writes r/F with EMIT_Y, and its thread
//      0 keeps the sums in float64 across the cluster's sites: one float32
//      partial a sum a (cluster, chain), rounded once.  Deterministic for a
//      launch shape.
// Padded sites (gsite >= n, the same for the whole cluster) factor nothing
// and add nothing; with EMIT_Y they write B = 0 and r/F = 0.  Every remote
// read of a block comes before its next arrival at a cluster barrier, and
// the kernel ends with one.  A site's B and r/F depend on its own system
// alone, so a sharded launch gives the unsharded launch's bits
// (chip_smoke.py path 27).
//
// Memory: kernel 1's blocks (cluster_block_bytes) and nothing more: p and q
// take 2 mp words of the staging buffer's P (mp + 2 - P), so kernel 2 runs
// this body up to kernel 1's limit, kClusterGradM = kClusterM = 608.
//
// Numbers: as the scratch body: float64 distances, closed forms
// (ClosedForm64), products, sums, factor and solves; the general-nu rho,
// d rho / d phi and d rho / d nu from the float32 Bessel routines; B and r/F
// rounded to float32 as they are stored.
#pragma once

#include <cstddef>

#include "vecchia_grad_smem.cuh"
#include "vecchia_large_cluster.cuh"

namespace vecchia {
namespace {

// The largest m kernel 2 runs on this body: the blocks hold the system and
// the staging buffer holds p and q (ops/geometry.py M_CLUSTER_GRAD computes
// the same).
constexpr int grad_cluster_max_m() {
  int m = kSmemGradM;
  while (cluster_blocks(m + 1) != 0 && 2 * cluster_mp(m + 1) <= cluster_stage_words(m + 1)) ++m;
  return m;
}
constexpr int kClusterGradM = grad_cluster_max_m();
static_assert(kClusterGradM == 608, "ops/geometry.py M_CLUSTER_GRAD takes the same value");
// kernel 2's first m has kernel 1's first slots, so cluster_least_block_bytes
// (one block of this body an SM) holds for it too
static_assert(cluster_mp(kSmemGradM + 1) == cluster_mp(kSmemM + 1), "one block an SM");

// Whether a call of kernel 2 runs this body.
__host__ inline bool grad_cluster_launch(int m) { return m > kSmemGradM && m <= kClusterGradM; }

// d rho / d phi at distance d times wf and wr added to a block's terms t[2]
// (d F / d phi) and t[3] (d r / d phi), and with_nu d rho / d nu to t[4] and
// t[5].
template <bool GENERAL, int NB>
__device__ __forceinline__ void grad_cluster_add(const ClosedForm64& cf, const MaternSet* set,
                                                 bool with_nu, double d, double wf, double wr,
                                                 double (&t)[NB]) {
  if constexpr (GENERAL) {
    const float d32 = static_cast<float>(d);
    const double dc = rho_drho_general(d32, &set->at).y;
    t[2] += wf * dc;
    t[3] += wr * dc;
    if (with_nu) {
      const double dcn = drho_dnu_general(d32, set);
      t[4] += wf * dcn;
      t[5] += wr * dcn;
    }
  } else {
    const double dc = cf.drho(d);
    t[2] += wf * dc;
    t[3] += wr * dc;
  }
}

// Kernel 2 for kSmemGradM < m <= kClusterGradM: the NV value and derivative
// sums per (cluster, chain) over the sites < n, part[(v chains + chain)
// grid_x + cluster]; with EMIT_Y also B = p (C, m, n_pad) and r/F (C, n_pad).
template <bool EMIT_Y, bool GENERAL, bool COORDS>
__global__ void __launch_bounds__(kClusterThreads, 1)
grad_cluster_kernel(const float* __restrict__ params, const float* __restrict__ tab_a,
                    const float* __restrict__ tab_b, const int* __restrict__ nn_idx,
                    const float* __restrict__ y_all, int y_stride, const float* __restrict__ v,
                    int n_pad, int m, int dim, int chains, int family, bool with_nu,
                    double* __restrict__ slots, float* __restrict__ part,
                    float* __restrict__ b_out, float* __restrict__ rof_out) {
  constexpr int P = kClusterPanel;
  constexpr int NV = GENERAL ? 8 : 6;
  // a block's terms over its share: p' V p, p' V q, d F / d phi, d r / d phi
  // (and d F / d nu, d r / d nu); in red after u.u and u.w
  constexpr int NB = GENERAL ? 6 : 4;
  constexpr int NT = NB + 2;
  extern __shared__ __align__(16) double smem[];
  __shared__ double red[NT];
  const ClusterShare s = cluster_share(smem, m, slots);
  const ClusterWalk walk = cluster_walk(s, chains);
  const float* pr = params + walk.chain * kParams;
  const MaternSet* set = chain_matern_set<GENERAL>(pr, with_nu);
  const ClosedForm64 cf = GENERAL ? ClosedForm64{} : closed_form64(family, pr[0]);
  const double alpha = pr[1];
  const double jitter = pr[2];
  const int n = static_cast<int>(pr[3]);
  const int off = static_cast<int>(pr[5]);  // the shard's first site
  const float* y = y_all + static_cast<size_t>(walk.chain) * y_stride;
  float* b_chain = EMIT_Y ? b_out + static_cast<size_t>(walk.chain) * m * n_pad : nullptr;
  double* pv = s.stage;         // p, once the factor is done with the stage
  double* qv = s.stage + s.mp;  // q
  double acc[NV];               // thread 0 of rank 0: the cluster's sums
#pragma unroll
  for (int t = 0; t < NV; ++t) acc[t] = 0.0;
  for (int site = walk.first; site < n_pad; site += walk.stride) {
    const int gsite = site + off;
    if (gsite >= n) {  // the same for the whole cluster: no barrier
      if constexpr (EMIT_Y) {
        for (int i = s.rank * kClusterThreads + threadIdx.x; i < m; i += s.k * kClusterThreads) {
          b_chain[static_cast<size_t>(i) * n_pad + site] = 0.0f;
        }
        if (s.rank == 0 && threadIdx.x == 0) {
          rof_out[static_cast<size_t>(walk.chain) * n_pad + site] = 0.0f;
        }
      }
      continue;
    }
    const int lim = min(gsite, m);
    const GlobalDistances<COORDS> dist(tab_a, tab_b, dim, n_pad, site);
    cluster_fill<GENERAL, COORDS, true>(s, cf, set, dist, nn_idx, y, v, alpha, jitter, n_pad,
                                        site, lim);
    __syncthreads();
    cluster_factor(s);
    cluster_border_sums<true>(s, red);  // u.u, u.w before p and q overwrite u and w
    // p and q over rows mp and mp + 1, panels last first; each block copies
    // every solved panel of both into pv and qv
    const int last = s.np - 1;
    if (cluster_owner(last, s.k) == s.rank) cluster_solve_panel<2>(s, last);
    cluster_sync();
    for (int j = last;; --j) {
      if (threadIdx.x < 2 * P) {
        const int row = threadIdx.x / P;
        const int c = threadIdx.x % P;
        const int len = s.rows - j * P;
        const double* pan = cluster_map(cluster_panel(s, j), cluster_owner(j, s.k));
        (row == 0 ? pv : qv)[j * P + c] = pan[c * len + s.mp + row - j * P];
      }
      __syncthreads();  // panel j's p and q are in
      if (j == 0) break;
      const bool mine = cluster_owner(j - 1, s.k) == s.rank;
      if (mine) {  // look-ahead: the next panel first
        cluster_back_update<2>(s, j, pv + j * P, j - 1, -1, s.mp);
        __syncthreads();
        cluster_solve_panel<2>(s, j - 1);
      }
      cluster_arrive();  // panel j - 1 is solved (its owner's part)
      cluster_back_update<2>(s, j, pv + j * P, -1, mine ? j - 1 : -1, s.mp);
      cluster_wait();
    }
    // this block's terms: its own indices, then the pairs of its own columns
    double t[NB];
#pragma unroll
    for (int x = 0; x < NB; ++x) t[x] = 0.0;
    for (int idx = threadIdx.x;; idx += blockDim.x) {
      const int p = cluster_own_panel(idx / P, s.k, s.rank);
      const int i = p * P + idx % P;
      if (i >= m) break;  // the panels rise with idx
      const double pi = pv[i];  // exactly 0 on slots >= lim
      const double qi = qv[i];
      if constexpr (EMIT_Y) b_chain[static_cast<size_t>(i) * n_pad + site] = static_cast<float>(pi);
      if (i < lim) {
        // dC/dalpha is the masked identity, diag(v) at the neighbors with v
        const double vi =
            v != nullptr ? static_cast<double>(v[nn_idx[static_cast<size_t>(i) * n_pad + site]])
                         : 1.0;
        t[0] += vi * pi * pi;
        t[1] += vi * pi * qi;
        grad_cluster_add<GENERAL>(cf, set, with_nu, dist.in(i), -2.0 * pi, -qi, t);
      }
    }
    // dC/dphi and dC/dnu have no diagonal
    for (int a = 0, p = s.rank; p * P < lim; p = cluster_own_panel(++a, s.k, s.rank)) {
      const int c0 = p * P;
      const int items = P * (lim - c0);
      for (int e = threadIdx.x; e < items; e += blockDim.x) {
        const int i = c0 + e / P;
        const int k = c0 + e % P;
        if (k >= i) continue;
        const double pi = pv[i];
        const double pk = pv[k];
        grad_cluster_add<GENERAL>(cf, set, with_nu, dist.pair(i, k), 2.0 * pi * pk,
                                  pi * qv[k] + pk * qv[i], t);
      }
    }
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      const double total = cluster_block_total(t[x]);
      if (threadIdx.x == 0) red[2 + x] = total;
    }
    cluster_sync();  // every block's terms are in
    if (s.rank == 0 && threadIdx.x == 0) {
      double tot[NT];
#pragma unroll
      for (int x = 0; x < NT; ++x) tot[x] = cluster_total(s, red, x);
      const double own_v = v != nullptr ? static_cast<double>(v[gsite]) : 1.0;
      const double ff = 1.0 + alpha * own_v - tot[0];
      const double r = y[gsite] - tot[1];
      const double inv_f = 1.0 / ff;
      const double rof = r * inv_f;
      const double ratio2 = rof * rof;
      const double df_a = own_v + tot[2];
      acc[0] += log(ff);
      acc[1] += r * rof;
      acc[2] += tot[4] * inv_f;
      acc[3] += 2.0 * rof * tot[5] - ratio2 * tot[4];
      acc[4] += df_a * inv_f;
      acc[5] += 2.0 * rof * tot[3] - ratio2 * df_a;
      if constexpr (GENERAL) {
        acc[6] += tot[6] * inv_f;
        acc[7] += 2.0 * rof * tot[7] - ratio2 * tot[6];
      }
      if constexpr (EMIT_Y) {
        rof_out[static_cast<size_t>(walk.chain) * n_pad + site] = static_cast<float>(rof);
      }
    }
    // red is written again only after the next system's first barrier, which
    // rank 0 passes after reading it; p and q of the owner of panel 0 were
    // read before the barrier above
  }
  if (s.rank == 0 && threadIdx.x == 0) {
#pragma unroll
    for (int x = 0; x < NV; ++x) {
      part[(x * chains + walk.chain) * walk.stride + walk.first] = static_cast<float>(acc[x]);
    }
  }
  cluster_sync();  // no block exits while rank 0 may read its shared memory
}

// The launch (valid_cluster checked by the caller); returns the CUDA error.
template <bool EMIT_Y, bool GENERAL, bool COORDS>
int launch_grad_cluster(const float* params, const float* tab_a, const float* tab_b,
                        const int* nn_idx, const float* y, int y_stride, const float* v,
                        int n_pad, int m, int dim, int chains, int family, bool with_nu,
                        int group, int grid_x, int smem_bytes, double* slots, float* part,
                        float* b_out, float* rof_out, cudaStream_t st) {
  return cluster_launch_kernel(grad_cluster_kernel<EMIT_Y, GENERAL, COORDS>, group, grid_x,
                               chains, smem_bytes, st, params, tab_a, tab_b, nn_idx, y,
                               y_stride, v, n_pad, m, dim, chains, family, with_nu, slots, part,
                               b_out, rof_out);
}

}  // namespace
}  // namespace vecchia
