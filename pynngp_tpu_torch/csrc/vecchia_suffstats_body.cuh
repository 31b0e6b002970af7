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
// the (C, grid_x) partials in float64, as XLA sums the TPU kernel's
// per-cell partials (pallas_bf.py:593-594): deterministic, no atomics.
//
// Design.  A block is a group of up to kMaxGroup chains, one warp a chain,
// over tiles of 32 consecutive sites (vecchia_tile.cuh): the tile's
// distance or coordinate planes, nn_idx, y at the neighbors (once for a
// shared y, y_stride = 0, or one row a warp with y_stride = n: the residual
// y - X beta with fixed effects) and v at the neighbors (noise weights) come
// into a shared-memory stage by cp.async, the next tile's tables while the
// warps factor this one, and each warp factors its chain's systems reading
// them from there.  Each lane keeps its sums across the block's tiles; a
// warp's shuffle tree writes its chain's partial.  The loops over the slots
// unroll over the template parameter M and the factor lives in registers;
// the rolled instance (ROLLED: arrays for kRolledM, loops to m, in local
// memory) runs 20 < m <= 32 and coords with d > kMaxDim; 32 < m <= kSmemM
// runs the shared-memory body (vecchia_large_smem.cuh: a warp a (site,
// chain) system), kSmemM < m <= kClusterM the cluster body
// (vecchia_large_cluster.cuh: a thread-block cluster a system), larger m the
// scratch body (vecchia_large_m.cuh).  At M = 20 (15 < m <= 20) the closed-form coords instance runs the team body
// (vecchia_team.cuh: a few lanes a system); the dist and general-nu ones
// keep this body (team_launch says why).
//
// What bounded the design before it (one thread per (site, chain), blocks of
// 128 sites of one chain), on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/time_trees.py --m15, PERF.md; n=100,000, m=15, 16 chains):
// 2.16 ms a launch, 1.11 ms with every table and nn_idx load replaced by a
// value computed from the site index.  Each chain swept the tables from L2
// and device memory by itself, each distance loaded where the recurrence
// used it; and the arithmetic kept the warps waiting: a correctly rounded
// division a correlation, a switch on the family at each of the m(m+1)/2
// correlations of the unrolled code, and 1/sqrtf at each pivot.  This design
// takes the loads off the recurrence (the ring), and takes 1/phi once a
// chain, one branch-free closed form for every family (ClosedForm,
// vecchia_tile.cuh) and rsqrtf: 0.33 ms.  What bounds it now: the latency of
// the serial recurrence (pivot, then the next row) and the m(m+1)/2
// exponentials at the warps an SM that its registers allow, still ~6x its
// special-function bound.  The general-nu instances replace each exponential
// by a Bessel evaluation of some hundreds of operations (vecchia_bessel.cuh)
// and are bound by those.  The coords layout reads (m + 1) d coordinates in
// place of the m(m+1)/2 distances and spends, per distance, d subtractions
// and multiply-adds and a square root (tile_sqrt); it re-reads a neighbor's
// coordinates from the stage at every use instead of keeping m d of them
// live.  What bounded its coords instance at M = 20, which the team body
// replaced (NVIDIA H100 80GB HBM3, 700.00 W; n=500,000, m=20, 16 chains,
// tools/compare_parent.py --m20, PERF.md): 8.07 ms a launch; its ~230 live
// floats spilled under the 168 registers of three blocks an SM, and with
// 190 registers it ran 46% slower.
#pragma once

#include <cstddef>

#include "vecchia_large_cluster.cuh"
#include "vecchia_large_m.cuh"
#include "vecchia_large_smem.cuh"
#include "vecchia_team.cuh"
#include "vecchia_tile.cuh"

namespace vecchia {
namespace {

// One warp's (site, chain) systems of one staged tile: writes f and r and
// adds log F and r^2/F of its valid site to the lane's sums.
template <int M, bool GENERAL, bool COORDS, bool ROLLED>
__device__ __forceinline__ void suffstats_site(const float* st, const TileShape& s, int ml,
                                               int ycopy, bool hetero, int site, int gsite,
                                               int m, int dim, const ClosedForm& cf, float alpha,
                                               float jitter, int n, const MaternSet* set,
                                               const float* __restrict__ y,
                                               const float* __restrict__ v,
                                               float* __restrict__ f_row,
                                               float* __restrict__ r_row, float& sum_logf,
                                               float& sum_q) {
  // the loops over the slots run to M, unrolled; in the rolled instance to
  // the call's m, which keeps them rolled
  const int top = ROLLED ? m : M;
  const int lane = threadIdx.x & 31;
  const float* sy = st + (s.off_y + ycopy * ml) * kTile + lane;
  const float* sv = st + s.off_v * kTile + lane;
  const TileDistances<COORDS, ROLLED> dist(st, s, dim);
  const int lim = min(gsite, m);  // slot k is a real neighbor iff lim > k

  float low[tri(M, 0)];  // strict lower triangle of L, packed by tri(i, k)
  float u[M];            // L^-1 c
  float w[M];            // L^-1 y_N

#pragma unroll
  for (int k = 0; k < top; ++k) {
    // slots at or past m read zeros from the stage and are masked
    const float mk = lim > k ? 1.0f : 0.0f;
    const float nugget = hetero ? alpha * sv[k * kTile] : alpha;
    float acc = 1.0f + mk * (nugget + jitter);
#pragma unroll
    for (int j = 0; j < k; ++j) acc -= low[tri(k, j)] * low[tri(k, j)];
    const float inv = rsqrtf(acc);
    float au = tile_rho<GENERAL>(cf, dist.in(k), set) * mk;
    float aw = sy[k * kTile] * mk;
#pragma unroll
    for (int j = 0; j < k; ++j) {
      au -= low[tri(k, j)] * u[j];
      aw -= low[tri(k, j)] * w[j];
    }
    u[k] = au * inv;
    w[k] = aw * inv;
#pragma unroll
    for (int i = k + 1; i < top; ++i) {
      const float mi = lim > i ? 1.0f : 0.0f;  // mask_i * mask_k, as i > k
      float a = tile_rho<GENERAL>(cf, dist.pair(i, k), set) * mi;
#pragma unroll
      for (int j = 0; j < k; ++j) a -= low[tri(i, j)] * low[tri(k, j)];
      low[tri(i, k)] = a * inv;
    }
  }

  float ff = 1.0f + own_nugget(alpha, v, gsite);
  float bdoty = 0.0f;
#pragma unroll
  for (int k = 0; k < top; ++k) {
    ff -= u[k] * u[k];
    bdoty += u[k] * w[k];
  }
  const bool valid = gsite < n;
  const float resid = (valid ? y[gsite] : 0.0f) - bdoty;
  f_row[site] = ff;
  r_row[site] = resid;
  sum_logf += valid ? logf(ff) : 0.0f;
  sum_q += valid ? resid * resid / ff : 0.0f;
}

// The block's loop over its tiles: stage, gather, factor (vecchia_tile.cuh).
template <int M, bool GENERAL, bool COORDS, bool ROLLED>
__device__ __forceinline__ void suffstats_tiles(
    const float* __restrict__ params, const float* __restrict__ tab_a,
    const float* __restrict__ tab_b, const int* __restrict__ nn_idx,
    const float* __restrict__ y_all, int y_stride, const float* __restrict__ v, int n_pad,
    int m, int dim, int chains, int family, float* __restrict__ f_out,
    float* __restrict__ r_out, float* __restrict__ part) {
  extern __shared__ __align__(16) float ring[];
  const int ml = ROLLED ? m : M;
  const int group = blockDim.x / kTile;
  const int c0 = blockIdx.y * group;
  const int warp = threadIdx.x / kTile;
  const int chain = c0 + warp;
  const bool active = chain < chains;  // a ragged last group has spare warps
  const int ycopies = y_stride != 0 ? group : 1;
  const TileShape s = tile_shape(m, ml, dim, COORDS, ycopies, v != nullptr);
  const int stage_words = s.planes * kTile;
  const float* pr = params + min(chain, chains - 1) * kParams;
  const float phi = pr[0];
  const float alpha = pr[1];
  const float jitter = pr[2];
  const int n = static_cast<int>(pr[3]);
  const int off = static_cast<int>(pr[5]);  // the shard's first global site
  const float* y = y_all + static_cast<size_t>(min(chain, chains - 1)) * y_stride;
  const MaternSet* set = warp_matern_set<GENERAL>(pr, false);
  const ClosedForm cf = GENERAL ? ClosedForm{} : closed_form(family, phi);
  float* f_row = f_out + static_cast<size_t>(chain) * n_pad;
  float* r_row = r_out + static_cast<size_t>(chain) * n_pad;

  for (int i = threadIdx.x; i < kStages * stage_words; i += blockDim.x) ring[i] = 0.0f;
  __syncthreads();
  const int tiles = n_pad / kTile;
  if (blockIdx.x < tiles) issue_tables(ring, s, tab_a, tab_b, nn_idx, n_pad, blockIdx.x);
  cp_async_commit();
  float sum_logf = 0.0f;
  float sum_q = 0.0f;
  int i = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
    float* st = ring + (i % kStages) * stage_words;
    const int next = tile + gridDim.x;
    cp_async_wait<0>();
    __syncthreads();  // this tile's tables are in; every warp is done with the last
    issue_gathers(st, s, ml, y_all, y_stride, ycopies, c0, chains, v);
    cp_async_commit();
    if (next < tiles) {
      issue_tables(ring + ((i + 1) % kStages) * stage_words, s, tab_a, tab_b, nn_idx, n_pad,
                   next);
    }
    cp_async_commit();
    cp_async_wait<1>();  // the gathers, not the next tile's tables
    __syncthreads();
    if (active) {
      const int site = tile * kTile + (threadIdx.x & 31);
      suffstats_site<M, GENERAL, COORDS, ROLLED>(
          st, s, ml, y_stride != 0 ? warp : 0, v != nullptr, site, site + off, m, dim, cf,
          alpha, jitter, n, set, y, v, f_row, r_row, sum_logf, sum_q);
    }
  }
  if (active) {
    const float sums[2] = {sum_logf, sum_q};
    warp_sum_store<2>(sums, part, chains * gridDim.x, chain * gridDim.x + blockIdx.x);
  }
}

#define VECCHIA_SUFFSTATS_PARAMS                                                            \
  const float *__restrict__ params, const float *__restrict__ tab_a,                        \
      const float *__restrict__ tab_b, const int *__restrict__ nn_idx,                      \
      const float *__restrict__ y_all, int y_stride, const float *__restrict__ v, int n_pad, \
      int m, int dim, int chains, int family, float *__restrict__ f_out,                    \
      float *__restrict__ r_out, float *__restrict__ part
#define VECCHIA_SUFFSTATS_ARGS                                                              \
  params, tab_a, tab_b, nn_idx, y_all, y_stride, v, n_pad, m, dim, chains, family,          \
      f_out, r_out, part

// The closed-form coords instances ask for three blocks an SM (at most 168
// registers), the dist ones for two: with two the coords instance at
// M = 20 took 255 registers and ran 27% slower at n=500,000, 16 chains, the
// dist one 8% faster (NVIDIA H100 80GB HBM3, 700 W; PERF.md).  The
// general-nu instances take no bound: it moved their registers the other
// way.
template <int M, bool GENERAL, bool COORDS, bool ROLLED>
__global__ void __launch_bounds__(kTile * kMaxGroup, COORDS ? 3 : 2)
    suffstats_kernel(VECCHIA_SUFFSTATS_PARAMS) {
  suffstats_tiles<M, GENERAL, COORDS, ROLLED>(VECCHIA_SUFFSTATS_ARGS);
}

template <int M, bool GENERAL, bool COORDS, bool ROLLED>
__global__ void __launch_bounds__(kTile * kMaxGroup) suffstats_nu_kernel(VECCHIA_SUFFSTATS_PARAMS) {
  suffstats_tiles<M, GENERAL, COORDS, ROLLED>(VECCHIA_SUFFSTATS_ARGS);
}
#undef VECCHIA_SUFFSTATS_PARAMS
#undef VECCHIA_SUFFSTATS_ARGS

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
int launch_suffstats(const float* params, const float* tab_a, const float* tab_b,
                     const int* nn_idx, const float* y, int y_stride, const float* v,
                     int n_pad, int m, int dim, int chains, int family, int group, int grid_x,
                     int smem_bytes, double* scratch, float* f_out, float* r_out, float* part,
                     void* stream) {
  if (!valid_launch<COORDS>(n_pad, chains, dim) || y_stride < 0 || launch_m(m) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem_launch(m)) {
    if (!valid_smem(n_pad, m, group, grid_x, smem_bytes, scratch)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_suffstats_smem<GENERAL, COORDS>(
        params, tab_a, tab_b, nn_idx, y, y_stride, v, n_pad, m, dim, chains, family, group,
        grid_x, smem_bytes, f_out, r_out, part, static_cast<cudaStream_t>(stream));
  }
  if (cluster_launch(m)) {
    if (!valid_cluster(n_pad, m, chains, group, grid_x, smem_bytes, scratch)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_suffstats_cluster<GENERAL, COORDS>(
        params, tab_a, tab_b, nn_idx, y, y_stride, v, n_pad, m, dim, chains, family, group,
        grid_x, smem_bytes, scratch, f_out, r_out, part, static_cast<cudaStream_t>(stream));
  }
  if (large_launch(m)) {
    if (!valid_large(n_pad, group, grid_x, smem_bytes, scratch)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_suffstats_large<GENERAL, COORDS>(
        params, tab_a, tab_b, nn_idx, y, y_stride, v, n_pad, m, dim, chains, family, grid_x,
        scratch, f_out, r_out, part, static_cast<cudaStream_t>(stream));
  }
  const bool rolled = rolled_launch(m, COORDS, dim);
  const TileShape s = tile_shape(m, rolled ? m : launch_m(m), dim, COORDS,
                                 y_stride != 0 ? group : 1, v != nullptr);
  if (!valid_tiles(s, group, grid_x, smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(grid_x, (chains + group - 1) / group);
  const dim3 block(kTile * group);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VECCHIA_SUFFSTATS_ONE(...)                                                          \
  {                                                                                         \
    auto kern = __VA_ARGS__;                                                                \
    if (smem_bytes > 48 * 1024) {                                                           \
      const cudaError_t err = cudaFuncSetAttribute(                                         \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);                   \
      if (err != cudaSuccess) return static_cast<int>(err);                                 \
    }                                                                                       \
    kern<<<grid, block, smem_bytes, st>>>(params, tab_a, tab_b, nn_idx, y, y_stride, v,     \
                                         n_pad, m, dim, chains, family, f_out,              \
                                         r_out, part);                                      \
  }
#define VECCHIA_SUFFSTATS_LAUNCH(MM, ROLL)                                                  \
  if constexpr (GENERAL) {                                                                  \
    VECCHIA_SUFFSTATS_ONE(suffstats_nu_kernel<MM, GENERAL, COORDS, ROLL>);                  \
  } else {                                                                                  \
    VECCHIA_SUFFSTATS_ONE(suffstats_kernel<MM, GENERAL, COORDS, ROLL>);                     \
  }
  if (rolled) {
    VECCHIA_SUFFSTATS_LAUNCH(kRolledM, true);
    return static_cast<int>(cudaGetLastError());
  }
  switch (launch_m(m)) {
    case 7: VECCHIA_SUFFSTATS_LAUNCH(7, false); break;
    case 10: VECCHIA_SUFFSTATS_LAUNCH(10, false); break;
    case 15: VECCHIA_SUFFSTATS_LAUNCH(15, false); break;
    case 20:
      // closed form on coords: the team body (vecchia_team.cuh); dist and
      // general nu: this body (team_launch)
      if constexpr (!GENERAL && COORDS) {
        if (!team_launch(kTeamSuffstats, GENERAL, COORDS, m, dim)) {
          return static_cast<int>(cudaErrorInvalidValue);
        }
        VECCHIA_SUFFSTATS_ONE(suffstats_team_kernel<20, team_lanes(kTeamSuffstats, true)>);
      } else {
        VECCHIA_SUFFSTATS_LAUNCH(20, false);
      }
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VECCHIA_SUFFSTATS_LAUNCH
#undef VECCHIA_SUFFSTATS_ONE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace vecchia
