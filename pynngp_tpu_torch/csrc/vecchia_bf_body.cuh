// Body of kernel 3, the explicit kriging weights B = C_N^-1 c and conditional
// variances F, shared by its four translation units: vecchia_bf.cu (closed-form
// rho, GENERAL = false) and vecchia_bf_nu.cu (general-nu Matern, GENERAL = true)
// on the dist table layout, and the same two with _coords (COORDS = true:
// distances recomputed from coordinate planes).
//
// Replaces the Pallas kernel _bf_kernel (pynngp_tpu/ops/pallas_bf.py:941,
// driven by _run_bf l.991 and pallas_bf l.1036; its coords branch through
// _dist_access, l.377 and l.957).  For every (site, chain) it
// builds the m x m unit-variance neighbor correlation C (+ alpha + jitter on
// valid diagonal slots, alpha v at the neighbor under heterogeneous noise,
// identity rows for invalid slots), factors it with the Cholesky-Crout
// recurrence, forward-solves u = L^-1 c, writes
// F = 1 + alpha (alpha v_i with v) - u.u and back-substitutes B = L^-T u.  B is
// exactly 0 in invalid slots.  These are the outputs the latent-w Gibbs sweep
// and the conjugate beta update consume; there is no reduction and no partial.
//
// Padded sites (site >= n) write B = 0 and F = 1 and factor nothing: their
// table entries are zero, so with alpha = 0 (the latent model) their system
// is the singular all-ones matrix.  Nothing downstream has to slice them off
// before it takes a log or a reciprocal of F.
//
// Design.  Kernels 1 and 2's (vecchia_tile.cuh): a block is a group of up to
// kMaxGroup chains, one warp a chain, over tiles of 32 consecutive sites
// whose distance or coordinate planes come into a shared-memory stage by
// cp.async, the next tile's while the warps factor this one; with noise
// weights the stage also holds nn_idx and v at the neighbors, gathered
// through it.  Kernel 3 has no y, so its stage has no y planes, and without
// v no nn_idx planes either (nothing is gathered).  The closed forms take
// ClosedForm (1/phi once a chain, one branch-free formula) and the pivot
// rsqrtf.  B is written plane-major, (C, m, n_pad): a warp is 32 consecutive
// sites of one chain, so each plane's store is one 128-byte line, and the
// sweep reads B in that layout.  m <= 20 runs on the smallest built M >= m,
// unrolled with the factor in registers; 20 < m <= kRolledM and coords with
// d > kMaxDim on the rolled instance; kRolledM < m <= kSmemM on the
// shared-memory body (vecchia_large_smem.cuh: a warp a (site, chain)
// system), kSmemM < m <= kClusterM on the cluster body
// (vecchia_large_cluster.cuh: a thread-block cluster a system), larger m on
// the scratch body (vecchia_large_m.cuh).  At M = 20
// (15 < m <= 20) the closed-form coords instances run the team body
// (vecchia_team.cuh: a few lanes a system); the dist and general-nu ones
// keep this body (team_launch says why).
//
// What bounded the design before it (one thread per (site, chain), reading
// its tables from global memory), on an NVIDIA H100 80GB HBM3 at 700 W:
// 2.2 ms at n=100,000, m=15, 16 chains, 2.3% of its bound (PERF.md), with a
// correctly rounded division a correlation, the family switch inside its
// unrolled code and 1/sqrtf at each pivot, what cost kernels 1 and 2 most of
// their time.  What bounds it: the back-substitution reads column i of L for
// every k > i, so all of L stays live to the end (105 + 3 x 15 floats at
// m = 15), and the serial recurrence's latency at the warps an SM its
// registers allow.
#pragma once

#include <cstddef>

#include "vecchia_large_cluster.cuh"
#include "vecchia_large_m.cuh"
#include "vecchia_large_smem.cuh"
#include "vecchia_team.cuh"
#include "vecchia_tile.cuh"

namespace vecchia {
namespace {

// One warp's (site, chain) systems of one staged tile: writes B (m planes of
// b_chain) and F of its site.
template <int M, bool GENERAL, bool COORDS, bool ROLLED, bool HETERO>
__device__ __forceinline__ void bf_site(const float* st, const TileShape& s, int site,
                                        int gsite, int m, int dim, const ClosedForm& cf, float alpha,
                                        float jitter, int n, const MaternSet* set,
                                        const float* __restrict__ v, int n_pad,
                                        float* __restrict__ b_chain,
                                        float* __restrict__ f_row) {
  // the loops over the slots run to M, unrolled; in the rolled instance to
  // the call's m, which keeps them rolled
  const int top = ROLLED ? m : M;
  float* b_site = b_chain + site;  // m planes
  if (gsite >= n) {  // padded site: B = 0, F = 1
#pragma unroll
    for (int i = 0; i < top; ++i) {
      if (i < m) b_site[static_cast<size_t>(i) * n_pad] = 0.0f;
    }
    f_row[site] = 1.0f;
    return;
  }
  const float* sv = st + s.off_v * kTile + (threadIdx.x & 31);
  const TileDistances<COORDS, ROLLED> dist(st, s, dim);
  const int lim = min(gsite, m);  // slot k is a real neighbor iff lim > k

  float low[tri(M, 0)];  // strict lower triangle of L, packed by tri(i, k)
  float inv_diag[M];
  float u[M];  // L^-1 c, then B = L^-T u over it

#pragma unroll
  for (int k = 0; k < top; ++k) {
    // slots at or past m read zeros from the stage and are masked
    const float mk = lim > k ? 1.0f : 0.0f;
    const float nugget = HETERO ? alpha * sv[k * kTile] : alpha;
    float acc = 1.0f + mk * (nugget + jitter);
#pragma unroll
    for (int j = 0; j < k; ++j) acc -= low[tri(k, j)] * low[tri(k, j)];
    const float inv = rsqrtf(acc);
    inv_diag[k] = inv;
    float au = tile_rho<GENERAL>(cf, dist.in(k), set) * mk;
#pragma unroll
    for (int j = 0; j < k; ++j) au -= low[tri(k, j)] * u[j];
    u[k] = au * inv;
#pragma unroll
    for (int i = k + 1; i < top; ++i) {
      const float mi = lim > i ? 1.0f : 0.0f;  // mask_i * mask_k, as i > k
      float a = tile_rho<GENERAL>(cf, dist.pair(i, k), set) * mi;
#pragma unroll
      for (int j = 0; j < k; ++j) a -= low[tri(i, j)] * low[tri(k, j)];
      low[tri(i, k)] = a * inv;
    }
  }

  float ff = 1.0f + (HETERO ? alpha * v[gsite] : alpha);
#pragma unroll
  for (int k = 0; k < top; ++k) ff -= u[k] * u[k];
  f_row[site] = ff;

  // back-substitution B = L^-T u, last slot first; the call's B has m planes
#pragma unroll
  for (int i = top - 1; i >= 0; --i) {
    float ab = u[i];
#pragma unroll
    for (int k = i + 1; k < top; ++k) ab -= low[tri(k, i)] * u[k];
    u[i] = ab * inv_diag[i];
    if (i < m) b_site[static_cast<size_t>(i) * n_pad] = u[i];
  }
}

// The block's loop over its tiles: stage (and gather v), factor, store.
// HETERO: the instance launched with noise weights.  Kernel 3 is the one
// body that takes noise as a template parameter: with the nullable pointer of
// kernels 1 and 2 (a runtime branch) its coords instance at M = 15 held 254
// registers where it holds 217 now, and ran 7% slower (0.489 against
// 0.454 ms at n=100,000, 16 chains; the other instances within 2%; NVIDIA
// H100 80GB HBM3, 700 W, tools/time_trees.py --bf, PERF.md).
template <int M, bool GENERAL, bool COORDS, bool ROLLED, bool HETERO>
__global__ void __launch_bounds__(kTile * kMaxGroup)
bf_kernel(const float* __restrict__ params, const float* __restrict__ tab_a,
          const float* __restrict__ tab_b, const int* __restrict__ nn_idx,
          const float* __restrict__ v, int n_pad, int m, int dim, int chains, int family,
          float* __restrict__ b_out, float* __restrict__ f_out) {
  extern __shared__ __align__(16) float ring[];
  const int ml = ROLLED ? m : M;
  const int group = blockDim.x / kTile;
  const int c0 = blockIdx.y * group;
  const int warp = threadIdx.x / kTile;
  const int chain = c0 + warp;
  const bool active = chain < chains;  // a ragged last group has spare warps
  const TileShape s = tile_shape(m, ml, dim, COORDS, 0, HETERO, HETERO);
  const int stage_words = s.planes * kTile;
  const int safe = min(chain, chains - 1);
  const float* pr = params + safe * kParams;
  const float phi = pr[0];
  const float alpha = pr[1];
  const float jitter = pr[2];
  const int n = static_cast<int>(pr[3]);
  const int off = static_cast<int>(pr[5]);  // the shard's first global site
  const MaternSet* set = warp_matern_set<GENERAL>(pr, false);
  const ClosedForm cf = GENERAL ? ClosedForm{} : closed_form(family, phi);
  float* b_chain = b_out + static_cast<size_t>(safe) * m * n_pad;
  float* f_row = f_out + static_cast<size_t>(safe) * n_pad;

  for (int i = threadIdx.x; i < kStages * stage_words; i += blockDim.x) ring[i] = 0.0f;
  __syncthreads();
  const int tiles = n_pad / kTile;
  if (blockIdx.x < tiles) issue_tables(ring, s, tab_a, tab_b, nn_idx, n_pad, blockIdx.x);
  cp_async_commit();
  int i = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
    float* st = ring + (i % kStages) * stage_words;
    const int next = tile + gridDim.x;
    cp_async_wait<0>();
    __syncthreads();  // this tile's tables are in; every warp is done with the last
    if constexpr (HETERO) {
      issue_gathers(st, s, ml, nullptr, 0, 0, c0, chains, v);
      cp_async_commit();
    }
    if (next < tiles) {
      issue_tables(ring + ((i + 1) % kStages) * stage_words, s, tab_a, tab_b, nn_idx, n_pad,
                   next);
    }
    cp_async_commit();
    if constexpr (HETERO) {
      cp_async_wait<1>();  // the gathers, not the next tile's tables
      __syncthreads();
    }
    if (active) {
      const int site = tile * kTile + (threadIdx.x & 31);
      bf_site<M, GENERAL, COORDS, ROLLED, HETERO>(st, s, site, site + off, m, dim, cf, alpha,
                                                  jitter, n, set, v, n_pad, b_chain, f_row);
    }
  }
}

// Validates the launch shape and the wrapper's geometry (group chains a
// block, grid_x blocks along the tiles, the ring's bytes; for
// kRolledM < m <= kSmemM group chains a block, grid_x blocks along the sites,
// the systems' bytes and no scratch; for kSmemM < m <= kClusterM the
// cluster size, grid_x clusters a chain, a block's bytes and the hand-off
// buffer in scratch;
// above, grid_x blocks of kBlock sites of one chain and the scratch buffer),
// picks the instance (M >= m for m <= 20; the rolled one for
// 20 < m <= kRolledM and for coords with d > kMaxDim; the shared-memory body
// up to kSmemM, the cluster body up to kClusterM, the scratch body above)
// and launches on
// `stream` without synchronising; returns cudaGetLastError().
template <bool GENERAL, bool COORDS>
int launch_bf(const float* params, const float* tab_a, const float* tab_b, const int* nn_idx,
              const float* v, int n_pad, int m, int dim, int chains, int family, int group,
              int grid_x, int smem_bytes, double* scratch, float* b_out, float* f_out,
              void* stream) {
  if (!valid_launch<COORDS>(n_pad, chains, dim) || launch_m(m) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem_launch(m)) {
    if (!valid_smem(n_pad, m, group, grid_x, smem_bytes, scratch)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_bf_smem<GENERAL, COORDS>(params, tab_a, tab_b, nn_idx, v, n_pad, m, dim,
                                           chains, family, group, grid_x, smem_bytes, b_out,
                                           f_out, st);
  }
  if (cluster_launch(m)) {
    if (!valid_cluster(n_pad, m, chains, group, grid_x, smem_bytes, scratch)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_bf_cluster<GENERAL, COORDS>(params, tab_a, tab_b, nn_idx, v, n_pad, m, dim,
                                              chains, family, group, grid_x, smem_bytes,
                                              scratch, b_out, f_out, st);
  }
  if (large_launch(m)) {
    if (!valid_large(n_pad, group, grid_x, smem_bytes, scratch)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_bf_large<GENERAL, COORDS>(params, tab_a, tab_b, nn_idx, v, n_pad, m, dim,
                                            chains, family, grid_x, scratch, b_out, f_out, st);
  }
  const bool rolled = rolled_launch(m, COORDS, dim);
  const TileShape s = tile_shape(m, rolled ? m : launch_m(m), dim, COORDS, 0, v != nullptr,
                                 v != nullptr);
  if (!valid_tiles(s, group, grid_x, smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(grid_x, (chains + group - 1) / group);
  const dim3 block(kTile * group);
#define VECCHIA_BF_ONE(KERN_HETERO, KERN)                                                   \
  {                                                                                         \
    auto kern = v != nullptr ? KERN_HETERO : KERN;                                          \
    if (smem_bytes > 48 * 1024) {                                                           \
      const cudaError_t err = cudaFuncSetAttribute(                                         \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);                   \
      if (err != cudaSuccess) return static_cast<int>(err);                                 \
    }                                                                                       \
    kern<<<grid, block, smem_bytes, st>>>(params, tab_a, tab_b, nn_idx, v, n_pad, m, dim,   \
                                         chains, family, b_out, f_out);                     \
  }
#define VECCHIA_BF_LAUNCH(MM, ROLL)                                                         \
  VECCHIA_BF_ONE((bf_kernel<MM, GENERAL, COORDS, ROLL, true>),                              \
                 (bf_kernel<MM, GENERAL, COORDS, ROLL, false>))
  if (rolled) {
    VECCHIA_BF_LAUNCH(kRolledM, true);
    return static_cast<int>(cudaGetLastError());
  }
  switch (launch_m(m)) {
    case 7: VECCHIA_BF_LAUNCH(7, false); break;
    case 10: VECCHIA_BF_LAUNCH(10, false); break;
    case 15: VECCHIA_BF_LAUNCH(15, false); break;
    case 20:
      // closed form on coords: the team body (vecchia_team.cuh); dist and
      // general nu: this body (team_launch)
      if constexpr (GENERAL || !COORDS) {
        VECCHIA_BF_LAUNCH(20, false);
      } else {
        if (!team_launch(kTeamBf, GENERAL, COORDS, m, dim)) {
          return static_cast<int>(cudaErrorInvalidValue);
        }
        constexpr int kLanes = team_lanes(kTeamBf, true);
        VECCHIA_BF_ONE((bf_team_kernel<20, kLanes, true>), (bf_team_kernel<20, kLanes, false>));
      }
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VECCHIA_BF_LAUNCH
#undef VECCHIA_BF_ONE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace vecchia
