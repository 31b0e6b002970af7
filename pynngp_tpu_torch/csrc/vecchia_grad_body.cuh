// Body of kernel 2, the fused Vecchia value + gradient pass, shared by its eight
// translation units: vecchia_grad.cu (EMIT_Y = false) and vecchia_grad_y.cu
// (EMIT_Y = true) for closed-form rho, vecchia_grad_nu.cu and
// vecchia_grad_y_nu.cu the same for the general-nu Matern (GENERAL = true), all
// on the dist table layout, and the same four with _coords (COORDS = true:
// distances recomputed from coordinate planes, vecchia_common.cuh).  Each
// instance costs tens of seconds of ptxas at m = 20, so the sets are compiled
// by separate nvcc processes side by side.
//
// Replaces the Pallas kernel _grad_kernel (pynngp_tpu/ops/pallas_bf.py:727,
// driven by _run_grad l.867; its coords branch through _dist_access, l.377 and
// l.752).  For
// every (site, chain) it makes the same factorization as kernel 1,
// back-substitutes p = L^-T u and q = L^-T w (w = L^-1 y_N; p = C^-1 c,
// q = C^-1 y_N), and
// contracts them with dC/dphi (ClosedForm::drho) and dC/dalpha (the masked
// identity; diag(v) at the neighbors under heterogeneous noise, the
// reference's _grad_kernel l.743-835):
//   dF/dphi = -2 p.dc + p' dC p,   dr/dphi = -dc.q + p' dC q,
//   dF/dalpha = 1 + p.p,           dr/dalpha = p.q,
//   with v: dF/dalpha = v_i + p' diag(v_N) p,   dr/dalpha = p' diag(v_N) q.
// It writes, per (block, chain), partials of logdet, quad, dlogdet/dphi,
// dquad/dphi, dlogdet/dalpha and dquad/dalpha over the sites < n; the
// wrapper (ops/diff_suffstats.py) sums them in float64.  One pass over the
// tables gives the value and the gradient.
//
// GENERAL (the general branches of _rho_fn and _drho_fn, pallas_bf.py:338,
// 682, and with `with_nu` _drho_nu_fn and the with_nu contractions, l.704,
// 812-833, 852-856).  rho and d rho / d phi come from one Bessel evaluation
// (vecchia_bessel.cuh).  `with_nu`, a launch argument that every thread
// shares, is set for a sampled nu: dC/dnu, the central difference of rho in
// nu, is diagonal-free like dC/dphi and is contracted the same way into
// dlogdet/dnu and dquad/dnu, sums 6 and 7 (exact zeros without it, so a
// static general nu runs the same instances).  These instances always write
// 8 partials, the closed-form ones 6.  Per pair of neighbors they make one
// Bessel evaluation in the factorization and one (d rho / d phi) plus two
// (d rho / d nu) in the contractions.  The function needs three: the
// factorization's evaluation already holds K_{nu-1}, but keeping d rho / d phi
// of every pair until the contractions would cost m(m-1)/2 more registers in
// a body that spills at m = 15, so the pairs are evaluated again.
//
// EMIT_Y (the emit_y branch of _grad_kernel, pallas_bf.py:857-864) also
// writes what the y cotangent needs: the kriging weights B = p, plane-major
// (C, m, n_pad) so that a warp stores 32 adjacent floats of one plane, and
// r/F per site (C, n_pad).  p is live anyway, so the variant adds stores and
// no register state.  Padded sites (site >= n) hold B = 0 and r/F = 0 exactly,
// and so do invalid slots (site <= slot), where p is an exact zero of the
// recurrence: the gather that forms dquad/dy adds them without a mask.
//
// y is (n,) shared by all chains (y_stride = 0) or (C, n) with one row per
// chain (y_stride = n): with fixed effects the residual y - X beta differs by
// chain.
//
// Design.  As kernel 1's (vecchia_suffstats_body.cuh, vecchia_tile.cuh): a
// block is a group of up to kMaxGroup chains, one warp a chain, over tiles
// of 32 consecutive sites whose tables, y_N and v_N come into a
// shared-memory stage by cp.async, the next tile's tables while the warps
// work on this one.  The dC contractions read the pair distances from the
// stage a second time, and v at the neighbors twice (the diagonal, the alpha
// sums), at no cost in device memory.  The slot loops unroll over M, the
// loops nested in them stay rolled and the factor lives in local memory (see
// below); the rolled instance (arrays for kRolledM, loops to m) runs
// 20 < m <= 32 and coords with d > kMaxDim, and above 32 the shared-memory
// body (vecchia_grad_smem.cuh, a warp a (site, chain) system) up to
// kSmemGradM, the cluster body (vecchia_grad_cluster.cuh, a thread-block
// cluster a system) up to kClusterGradM, the scratch body
// (vecchia_large_m.cuh) above it.  At M = 20
// (15 < m <= 20) the closed-form instances run the team body
// (vecchia_team.cuh: a few lanes a system, its state in registers); the
// general-nu ones keep this body.
//
// What bounded the design before it (one thread per (site, chain); NVIDIA
// H100 80GB HBM3, 700 W, tools/time_trees.py --m15, PERF.md; n=100,000,
// m=15, 16 chains): 6.19 ms a launch, 4.73 ms without a table or nn_idx load,
// so the loads were a quarter of it; the rest the same arithmetic as kernel
// 1's (a division a correlation, the family switch, 1/sqrtf), with 228
// registers and 8 warps an SM.  This design stages the tables (the dC
// contractions read the pair planes from the stage too), takes ClosedForm's
// rho and d rho / d phi on one exponential, and leaves every loop nested in a
// slot loop rolled (an unroll count of M): the factor, u, w, p, q and dc in
// local memory, 128 registers and 16 warps an SM at m = 15.  ~1.0 ms.  What
// bounds it now: the serial recurrence and back-substitution, ~m^3/6 + m^2
// dependent FMAs, through L1.  EMIT_Y adds (m + 1) * 4 bytes of stores a
// thread.  In the coords layout every pair distance is recomputed twice, in
// the factorization and in the contractions (d subtractions and
// multiply-adds and a square root each time, from the staged coordinates).
//
// What bounded this body at M = 20, which the team body replaced for the
// closed forms (NVIDIA H100 80GB HBM3, 700.00 W; n=500,000, m=20, 16 chains,
// tools/compare_parent.py --m20, PERF.md): 46.82 ms a launch on dist (36.30
// on coords), 9.3x the M = 15 instance's time a (site, chain) for about
// twice the work.  A thread's 310 floats (the factor, u, w,
// dc, p, q, 1/L_kk) lived in local memory, and the M = 20 ring's 64 KB a
// block left L1 little room to hold them.
#pragma once

#include <cstddef>

#include "vecchia_grad_cluster.cuh"
#include "vecchia_grad_smem.cuh"
#include "vecchia_large_m.cuh"
#include "vecchia_team.cuh"
#include "vecchia_tile.cuh"

namespace vecchia {
namespace {

// One warp's (site, chain) systems of one staged tile: adds its valid
// site's NV sums to the lane's, and with EMIT_Y writes B and r/F.
template <int M, bool EMIT_Y, bool GENERAL, bool COORDS, bool ROLLED, int NV>
__device__ __forceinline__ void grad_site(const float* st, const TileShape& s, int ml, int ycopy,
                                          bool hetero, int site, int gsite, int m, int dim,
                                          const ClosedForm& cf, float alpha, float jitter, int n,
                                          const MaternSet* set, bool with_nu,
                                          const float* __restrict__ y,
                                          const float* __restrict__ v, int n_pad,
                                          float* __restrict__ b_chain,
                                          float* __restrict__ rof_row, float (&acc)[NV]) {
  // the loops over the slots run to M; in the rolled instance to the call's
  // m.  An explicit unroll count of M leaves every loop nested in a slot
  // loop rolled and the factor in local memory (128 registers at M = 15
  // where full unrolling held 226-238; PERF.md)
  const int top = ROLLED ? m : M;
  constexpr int kUnroll = ROLLED ? 1 : M;
  const int lane = threadIdx.x & 31;
  const float* sy = st + (s.off_y + ycopy * ml) * kTile + lane;
  const float* sv = st + s.off_v * kTile + lane;
  const TileDistances<COORDS, ROLLED> dist(st, s, dim);
  const int lim = min(gsite, m);  // slot k is a real neighbor iff lim > k

  float low[tri(M, 0)];  // strict lower triangle of L, packed by tri(i, k)
  float inv_diag[M];
  float u[M];   // L^-1 c
  float w[M];   // L^-1 y_N
  float dc[M];  // dc/dphi (masked)
  [[maybe_unused]] float dcn[GENERAL ? M : 1];  // dc/dnu (masked), GENERAL only

#pragma unroll (kUnroll)
  for (int k = 0; k < top; ++k) {
    // slots at or past m read zeros from the stage and are masked; their
    // special functions are skipped
    const float mk = lim > k ? 1.0f : 0.0f;
    const float nugget = hetero ? alpha * sv[k * kTile] : alpha;
    float au = 0.0f;
    dc[k] = 0.0f;
    if constexpr (GENERAL) dcn[k] = 0.0f;
    if (k < m) {
      const float dk = dist.in(k);
      if constexpr (GENERAL) {
        const float2 rd = rho_drho_general(dk, &set->at);
        dc[k] = rd.y * mk;
        dcn[k] = with_nu ? drho_dnu_general(dk, set) * mk : 0.0f;
        au = rd.x * mk;
      } else {
        const float2 rd = cf.rho_drho(dk);
        dc[k] = rd.y * mk;
        au = rd.x * mk;
      }
    }
    float aw = sy[k * kTile] * mk;
    float acc2 = 1.0f + mk * (nugget + jitter);
#pragma unroll (kUnroll)
    for (int j = 0; j < k; ++j) acc2 -= low[tri(k, j)] * low[tri(k, j)];
    const float inv = rsqrtf(acc2);
    inv_diag[k] = inv;
#pragma unroll (kUnroll)
    for (int j = 0; j < k; ++j) {
      au -= low[tri(k, j)] * u[j];
      aw -= low[tri(k, j)] * w[j];
    }
    u[k] = au * inv;
    w[k] = aw * inv;
#pragma unroll (kUnroll)
    for (int i = k + 1; i < top; ++i) {
      const float mi = lim > i ? 1.0f : 0.0f;  // mask_i * mask_k, as i > k
      float a = 0.0f;
      if (i < m) a = tile_rho<GENERAL>(cf, dist.pair(i, k), set) * mi;
#pragma unroll (kUnroll)
      for (int j = 0; j < k; ++j) a -= low[tri(i, j)] * low[tri(k, j)];
      low[tri(i, k)] = a * inv;
    }
  }

  const bool valid = gsite < n;
  float ff = 1.0f + own_nugget(alpha, v, gsite);
  float r = valid ? y[gsite] : 0.0f;
#pragma unroll (kUnroll)
  for (int k = 0; k < top; ++k) {
    ff -= u[k] * u[k];
    r -= u[k] * w[k];
  }

  // back-substitution p = L^-T u, q = L^-T w (exactly zero on invalid
  // slots).  dC/dalpha is the masked identity, diag(v) at the neighbors with
  // v: pp = p' dC/dalpha p and pq = p' dC/dalpha q
  float p[M];
  float q[M];
  float pp = 0.0f;
  float pq = 0.0f;
#pragma unroll (kUnroll)
  for (int i = top - 1; i >= 0; --i) {
    float ap = u[i];
    float aq = w[i];
#pragma unroll (kUnroll)
    for (int k = i + 1; k < top; ++k) {
      ap -= low[tri(k, i)] * p[k];
      aq -= low[tri(k, i)] * q[k];
    }
    p[i] = ap * inv_diag[i];
    q[i] = aq * inv_diag[i];
    const float vi = hetero ? sv[i * kTile] : 1.0f;  // p = 0 past the call's m
    pp += vi * p[i] * p[i];
    pq += vi * p[i] * q[i];
  }
  if constexpr (EMIT_Y) {
    float* b_site = b_chain + site;  // m planes
#pragma unroll (kUnroll)
    for (int i = 0; i < top; ++i) {
      if (i < m) b_site[static_cast<size_t>(i) * n_pad] = valid ? p[i] : 0.0f;
    }
  }

  // contractions with dC/dphi (diagonal-free: drho(0) = 0) and, GENERAL with
  // a sampled nu, with dC/dnu (diagonal-free too: rho(0) = 1 for every nu)
  float df_phi = 0.0f;
  float dr_phi = 0.0f;
  [[maybe_unused]] float df_nu = 0.0f;
  [[maybe_unused]] float dr_nu = 0.0f;
#pragma unroll (kUnroll)
  for (int i = 0; i < top; ++i) {
    df_phi -= 2.0f * p[i] * dc[i];
    dr_phi -= dc[i] * q[i];
    if constexpr (GENERAL) {
      df_nu -= 2.0f * p[i] * dcn[i];
      dr_nu -= dcn[i] * q[i];
    }
  }
#pragma unroll (kUnroll)
  for (int i = 0; i < top; ++i) {
#pragma unroll (kUnroll)
    for (int j = i + 1; j < top; ++j) {
      if (j >= m) continue;
      const float mj = lim > j ? 1.0f : 0.0f;  // mask_i * mask_j, as j > i
      const float dij = dist.pair(j, i);
      if constexpr (GENERAL) {
        const float dcij = rho_drho_general(dij, &set->at).y * mj;
        df_phi += 2.0f * p[i] * p[j] * dcij;
        dr_phi += (p[i] * q[j] + p[j] * q[i]) * dcij;
        if (with_nu) {
          const float dcnij = drho_dnu_general(dij, set) * mj;
          df_nu += 2.0f * p[i] * p[j] * dcnij;
          dr_nu += (p[i] * q[j] + p[j] * q[i]) * dcnij;
        }
      } else {
        const float dcij = cf.drho(dij) * mj;
        df_phi += 2.0f * p[i] * p[j] * dcij;
        dr_phi += (p[i] * q[j] + p[j] * q[i]) * dcij;
      }
    }
  }
  const float df_a = (v != nullptr ? v[gsite] : 1.0f) + pp;
  const float dr_a = pq;

  const float inv_f = valid ? 1.0f / ff : 0.0f;
  const float r_over_f = r * inv_f;
  const float ratio2 = r_over_f * r_over_f;
  if constexpr (EMIT_Y) rof_row[site] = valid ? r_over_f : 0.0f;
  // d(r^2/F) = 2 r dr / F - (r/F)^2 dF; r_over_f carries the validity mask
  acc[0] += valid ? logf(ff) : 0.0f;
  acc[1] += r * r_over_f;
  acc[2] += df_phi * inv_f;
  acc[3] += 2.0f * r_over_f * dr_phi - ratio2 * df_phi;
  acc[4] += df_a * inv_f;
  acc[5] += 2.0f * r_over_f * dr_a - ratio2 * df_a;
  if constexpr (GENERAL) {
    acc[6] += df_nu * inv_f;
    acc[7] += 2.0f * r_over_f * dr_nu - ratio2 * df_nu;
  }
}

// The block's loop over its tiles: stage, gather, factor and contract
// (vecchia_tile.cuh); one partial of each sum per (block, chain).
template <int M, bool EMIT_Y, bool GENERAL, bool COORDS, bool ROLLED = false>
__global__ void __launch_bounds__(kTile * kMaxGroup)
grad_kernel(const float* __restrict__ params, const float* __restrict__ tab_a,
            const float* __restrict__ tab_b, const int* __restrict__ nn_idx,
            const float* __restrict__ y_all, int y_stride, const float* __restrict__ v,
            int n_pad, int m, int dim, int chains, int family,
            float* __restrict__ part, float* __restrict__ b_out, float* __restrict__ rof_out,
            bool with_nu) {
  constexpr int NV = GENERAL ? 8 : 6;
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
  const int safe = min(chain, chains - 1);
  const float* pr = params + safe * kParams;
  const float phi = pr[0];
  const float alpha = pr[1];
  const float jitter = pr[2];
  const int n = static_cast<int>(pr[3]);
  const int off = static_cast<int>(pr[5]);  // the shard's first global site
  const float* y = y_all + static_cast<size_t>(safe) * y_stride;
  const MaternSet* set = warp_matern_set<GENERAL>(pr, with_nu);
  const ClosedForm cf = GENERAL ? ClosedForm{} : closed_form(family, phi);
  float* b_chain = EMIT_Y ? b_out + static_cast<size_t>(safe) * m * n_pad : nullptr;
  float* rof_row = EMIT_Y ? rof_out + static_cast<size_t>(safe) * n_pad : nullptr;

  for (int i = threadIdx.x; i < kStages * stage_words; i += blockDim.x) ring[i] = 0.0f;
  __syncthreads();
  const int tiles = n_pad / kTile;
  if (blockIdx.x < tiles) issue_tables(ring, s, tab_a, tab_b, nn_idx, n_pad, blockIdx.x);
  cp_async_commit();
  float acc[NV] = {};
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
      grad_site<M, EMIT_Y, GENERAL, COORDS, ROLLED, NV>(
          st, s, ml, y_stride != 0 ? warp : 0, v != nullptr, site, site + off, m, dim, cf,
          alpha, jitter, n, set, with_nu, y, v, n_pad, b_chain, rof_row, acc);
    }
  }
  if (active) warp_sum_store<NV>(acc, part, chains * gridDim.x, chain * gridDim.x + blockIdx.x);
}

// Validates the launch shape and the wrapper's geometry (group chains a
// block, grid_x blocks along the tiles, the ring's bytes; for kRolledM <
// m <= kSmemGradM group chains a block and their systems' bytes; for
// kSmemGradM < m <= kClusterGradM the cluster size, grid_x clusters a chain,
// a block's bytes and the hand-off buffer in scratch; above, grid_x blocks
// of kBlock sites of one chain and the scratch buffer), picks the instance
// (M >= m for m <= 20; the rolled one for 20 < m <= kRolledM and for coords
// with d > kMaxDim; the shared-memory body, the cluster body, then the
// scratch body above) and launches on `stream` without synchronising;
// returns cudaGetLastError().
template <bool EMIT_Y, bool GENERAL, bool COORDS>
int launch_grad(const float* params, const float* tab_a, const float* tab_b, const int* nn_idx,
                const float* y, int y_stride, const float* v, int n_pad, int m, int dim,
                int chains, int family, bool with_nu, int group, int grid_x,
                int smem_bytes, double* scratch, float* part, float* b_out, float* rof_out,
                void* stream) {
  if (!valid_launch<COORDS>(n_pad, chains, dim) || y_stride < 0 || launch_m(m) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem_grad_launch(m)) {
    if (!valid_smem_grad(n_pad, m, group, grid_x, smem_bytes, scratch)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_grad_smem<EMIT_Y, GENERAL, COORDS>(
        params, tab_a, tab_b, nn_idx, y, y_stride, v, n_pad, m, dim, chains, family, with_nu,
        group, grid_x, smem_bytes, part, b_out, rof_out, static_cast<cudaStream_t>(stream));
  }
  if (grad_cluster_launch(m)) {
    if (!valid_cluster(n_pad, m, chains, group, grid_x, smem_bytes, scratch)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_grad_cluster<EMIT_Y, GENERAL, COORDS>(
        params, tab_a, tab_b, nn_idx, y, y_stride, v, n_pad, m, dim, chains, family, with_nu,
        group, grid_x, smem_bytes, scratch, part, b_out, rof_out,
        static_cast<cudaStream_t>(stream));
  }
  if (large_launch(m)) {
    if (!valid_large(n_pad, group, grid_x, smem_bytes, scratch)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_grad_large<EMIT_Y, GENERAL, COORDS>(
        params, tab_a, tab_b, nn_idx, y, y_stride, v, n_pad, m, dim, chains, family, with_nu,
        grid_x, scratch, part, b_out, rof_out, static_cast<cudaStream_t>(stream));
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
#define VECCHIA_GRAD_ONE(...)                                                               \
  {                                                                                         \
    auto kern = __VA_ARGS__;                                                                \
    if (smem_bytes > 48 * 1024) {                                                           \
      const cudaError_t err = cudaFuncSetAttribute(                                         \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);                   \
      if (err != cudaSuccess) return static_cast<int>(err);                                 \
    }                                                                                       \
    kern<<<grid, block, smem_bytes, st>>>(params, tab_a, tab_b, nn_idx, y, y_stride, v,     \
                                         n_pad, m, dim, chains, family, part, b_out,        \
                                         rof_out, with_nu);                                 \
  }
#define VECCHIA_GRAD_LAUNCH(MM, ROLL) VECCHIA_GRAD_ONE(grad_kernel<MM, EMIT_Y, GENERAL, COORDS, ROLL>)
  if (rolled) {
    VECCHIA_GRAD_LAUNCH(kRolledM, true);
    return static_cast<int>(cudaGetLastError());
  }
  switch (launch_m(m)) {
    case 7: VECCHIA_GRAD_LAUNCH(7, false); break;
    case 10: VECCHIA_GRAD_LAUNCH(10, false); break;
    case 15: VECCHIA_GRAD_LAUNCH(15, false); break;
    case 20:
      // closed form: the team body (vecchia_team.cuh); general nu: its own
      if constexpr (GENERAL) {
        VECCHIA_GRAD_LAUNCH(20, false);
      } else {
        if (!team_launch(kTeamGrad, GENERAL, COORDS, m, dim)) {
          return static_cast<int>(cudaErrorInvalidValue);
        }
        VECCHIA_GRAD_ONE(grad_team_kernel<20, team_lanes(kTeamGrad, COORDS), EMIT_Y, COORDS>);
      }
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VECCHIA_GRAD_LAUNCH
#undef VECCHIA_GRAD_ONE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace vecchia
