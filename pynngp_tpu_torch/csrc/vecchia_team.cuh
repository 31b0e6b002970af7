// Kernels 1, 2 and 3 at M = 20 (15 < m <= 20) on a team of lanes a (site,
// chain) system: the closed-form instances of kernel 2 (vecchia_grad.cu,
// vecchia_grad_y.cu and their _coords sources) and the closed-form coords
// instances of kernels 1 and 3 (vecchia_suffstats_coords.cu,
// vecchia_bf_coords.cu).  The launchers of vecchia_suffstats_body.cuh,
// vecchia_grad_body.cuh and vecchia_bf_body.cuh send such calls here
// (team_launch); every other M, kernels 1 and 3 on dist and the general-nu
// instances keep their bodies.
//
// Replaces, at those shapes, the Pallas kernels _suffstats_kernel
// (pynngp_tpu/ops/pallas_bf.py:409, pallas_call l.572), _grad_kernel
// (l.727, pallas_call l.918, emit_y l.857) and _bf_kernel (l.941,
// pallas_call l.1015), their coords branches through _dist_access (l.377,
// l.437, l.752, l.957), whose functions vecchia_suffstats_body.cuh,
// vecchia_grad_body.cuh and vecchia_bf_body.cuh state.
//
// What bounded the design before it (one thread a (site, chain) system, on
// an NVIDIA H100 80GB HBM3 at 700.00 W, n=500,000, m=20, 16 chains,
// tools/compare_parent.py --m20, PERF.md): kernel 2 46.82 ms a launch on
// dist and 36.30 on coords (5.85 ns a (site, chain) on dist, 9.3x its
// M = 15 instance's for about twice the work), its loops nested in the slot
// loops rolled and the thread's 310 floats of state (the factor's 190, u,
// w, dc, p, q and 1/L_kk) in local memory, which the ring's 64 KB a block
// left little L1 to hold; kernel 1-coords 8.07 ms, its ~230 live floats
// spilled under the 168 registers of its three blocks an SM (190 registers
// without the cap ran 46% slower); kernel 3-coords 10.74 ms, 4.3% of its
// bound, all of L and the rows' coordinates live to the back-substitution
// at 255 registers with 240 B of stack and 1,668 B of spill loads.
//
// Design.  The tile ring, its cp.async staging and the launch geometry stay
// those of vecchia_tile.cuh.  A warp turns a staged tile of 32 sites into
// systems T lanes a system (team_lanes: 2 or 4 by instance): lane t of a
// team holds the rows i = r T + t (r < R = M / T) of the system bordered
// with c and y_N, in registers, and the vectors c (then u = L^-1 c), y_N
// (then w = L^-1 y_N), 1/L_ii, dc / dphi, p and q by the same index; a warp
// factors 32 / T sites of its chain at once, T passes over the tile.  The factor is
// right-looking: at pivot k its owner's rsqrt, c_k and y_k go to the team
// by three shuffles, and each entry L[j][k] of the pivot's column by one,
// so that every lane updates its own rows; u_k and w_k reach every lane, so
// F and r are summed in the lane-by-lane order of the thread-a-system
// bodies.  Kernel 2's back-substitution p = L^-T u, q = L^-T w runs the
// columns in reverse: each lane's part of column i's dot products, a
// butterfly over the team, and the owner's p_i and q_i.  Its dC/dphi pair
// contractions go by the row that owns the pair: p_i and q_i by two
// shuffles, d rho / d phi of the pairs (j, i) of the lane's rows, and four
// team sums at the end.  A row's storage runs to the last column any lane
// of the team needs at that r (columns past the lane's own row are kept
// finite and never read), so every index is a compile-time constant and the
// state stays in registers.  One lane of the team writes the site's outputs
// and adds its sums (lane p on pass p: one site a lane a tile).  Kernel 3's
// system is bordered with c alone (TeamSystem without y), its B = L^-T u is
// kernel 2's p (TeamSystem::back_substitute), written plane-major by every
// lane for its rows, and it keeps no sums.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W, n=500,000, m=20, 16 chains,
// tools/compare_parent.py --m20): kernel 2 5.22 ms on dist (2 lanes) and
// 11.14 on coords (4 lanes), 12.5% and 5.9% of its float32-operation bound
// (chip_smoke.py kernel_bounds: 0.653 and 0.659 ms); kernel 1-coords 4.23
// (2 lanes), 11.0% of its special-function bound (0.465 ms).  Teams of 2
// ran kernel 2 on dist 27% and kernel 1-coords 21% faster than teams of 4
// (fewer passes, half the pivot column's shuffles), kernel 2 on coords 25%
// slower (its rows and their coordinates spill at 2); teams of 8 lost
// everywhere.  What bounds it now: a lane holds ~200 live floats at 217-255
// registers (kernel 2 spills up to 124 bytes a thread, its EMIT_Y coords
// instance; ptxas -v), so 8 warps an SM hide the shuffles' and the
// exponentials' latency poorly; on coords every pair distance is computed
// twice, in the fill and the contractions.
//
// Numbers: float32 throughout, as the thread-a-system bodies: the same
// fill (ClosedForm), the same order of the factor's updates, and of F and
// r; the back-substitution's and the contractions' sums in another order
// (a lane's part, then the team's butterfly, the same bits in every lane).
// Deterministic for a launch shape.  Slots k >= m, and padded sites, are
// the masked identity rows of the other bodies; p = 0 there exactly, so
// EMIT_Y's B = 0 on invalid slots and padded sites, as before.  Kernel 3's
// padded sites factor the identity (no slot real) in place of their system,
// singular at alpha = 0, and write B = 0 and F = 1.
#pragma once

#include <cstddef>

#include "vecchia_tile.cuh"

namespace vecchia {

// The kernels a team body takes (their C launchers name themselves by it).
enum TeamKernel { kTeamSuffstats, kTeamGrad, kTeamBf };

// Lanes a (site, chain) system by kernel and layout (2, 4 or 8 take the same
// code), chosen on the H100 by tools/time_trees.py --m20 (PERF.md): 4 for
// kernel 2 on coords, 2 for the others; the kernels take it as their second
// template argument, which chip_smoke.py's tile_resources reads from their
// names.
__host__ __device__ constexpr int team_lanes(TeamKernel kernel, bool coords) {
  return kernel == kTeamGrad && coords ? 4 : 2;
}

// Whether a tile launch runs a team body (ops/geometry.py team_body states
// the same rule): closed-form rho on the unrolled M = 20 instance (15 < m
// <= 20, d <= kMaxDim on coords), every kernel on coords and kernel 2 on
// dist.  Kernels 1 and 3 on dist keep a lane a system: their thread bodies
// hold the system in 255 registers without spilling, and the card measured
// them faster than teams of 2, 4 and 8 (2.45 ms against 3.01 and 3.12 at
// n=500,000, 16 chains, PERF.md).
__host__ inline bool team_launch(TeamKernel kernel, bool general, bool coords, int m,
                                 int dim) {
  return !general && launch_m(m) == 20 && !(coords && dim > kMaxDim) &&
         (coords || kernel == kTeamGrad);
}

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// The value of lane `src` of the caller's team.
template <int T>
__device__ __forceinline__ float team_get(float x, int src) {
  return __shfl_sync(kFullMask, x, src, T);
}

// The sum over the caller's team, the same bits in every lane (each level
// adds the same two partial sums in every lane of a pair).
template <int T>
__device__ __forceinline__ float team_sum(float x) {
#pragma unroll
  for (int off = T / 2; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off, T);
  return x;
}

// The distances of a team's system in a staged tile, column `col` of the
// stage: from the site to slot i, and between slots i and k, read from the
// distance planes or recomputed from the coordinate planes (the site's own
// coordinates held, slot k's read where used: every lane of the team reads
// the same word).
template <bool COORDS>
struct TeamDistances {
  const float* sa;
  const float* sb;
  int dim;
  float own[COORDS ? kMaxDim : 1];

  __device__ __forceinline__ TeamDistances(const float* st, const TileShape& s, int dim_,
                                           int col)
      : sa(st + col), sb(st + s.off_b * kTile + col), dim(dim_) {
    if constexpr (COORDS) {
#pragma unroll
      for (int a = 0; a < kMaxDim; ++a) own[a] = a < dim ? sa[a * kTile] : 0.0f;
    }
  }

  // coordinate a of slot k (0 past d)
  __device__ __forceinline__ float coord(int k, int a) const {
    return a < dim ? sb[(k * dim + a) * kTile] : 0.0f;
  }

  __device__ __forceinline__ static float norm(const float (&x)[kMaxDim],
                                               const float (&z)[kMaxDim]) {
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < kMaxDim; ++a) {
      const float diff = x[a] - z[a];
      acc += diff * diff;
    }
    return tile_sqrt(acc);
  }

  __device__ __forceinline__ float in(int i) const { return sa[i * kTile]; }
  __device__ __forceinline__ float pair(int i, int k) const { return sb[tri(i, k) * kTile]; }
};

// The fill and the factor of one team's system: on return a[r][j] (j < i)
// holds L[i][j] of the lane's row i = r T + t, cu[r] and yw[r] u_i and w_i,
// inv[r] 1/L_ii, and ff and rr the site's F and y - u.w; dc[r] d c_i / d phi
// (GRAD) and oc[r] the coordinates of slot i (COORDS).  Kernel 3's system
// (WITH_Y false) is bordered with c alone: no y_N, w or rr, and no registers
// for them.
template <int M, int T, bool GRAD, bool COORDS, bool WITH_Y = true>
struct TeamSystem {
  static constexpr int R = (M + T - 1) / T;
  // a row's storage: the columns up to the last row of its r
  __host__ __device__ static constexpr int cols(int r) { return (r + 1) * T < M ? (r + 1) * T : M; }

  float a[R][M];
  float cu[R];
  float yw[WITH_Y ? R : 1];
  float inv[R];
  float dc[GRAD ? R : 1];
  float oc[COORDS ? R : 1][kMaxDim];
  float mrow[R];  // row i is a real neighbor slot
  int slot[R];    // min(i, M - 1): the stage's plane of row i

  __device__ __forceinline__ void build(const TeamDistances<COORDS>& dist, const float* sy,
                                        const float* sv, bool hetero, int lim,
                                        const ClosedForm& cf, float alpha, float jitter) {
    const int t = threadIdx.x & (T - 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = r * T + t;
      slot[r] = min(i, M - 1);
      mrow[r] = lim > i ? 1.0f : 0.0f;
      const float nugget = hetero ? alpha * sv[slot[r] * kTile] : alpha;
      float din;
      if constexpr (COORDS) {
#pragma unroll
        for (int x = 0; x < kMaxDim; ++x) oc[r][x] = dist.coord(slot[r], x);
        din = TeamDistances<COORDS>::norm(dist.own, oc[r]);
      } else {
        din = dist.in(slot[r]);
      }
      if constexpr (GRAD) {
        const float2 rd = cf.rho_drho(din);
        cu[r] = rd.x * mrow[r];
        dc[r] = rd.y * mrow[r];
      } else {
        cu[r] = cf.rho(din) * mrow[r];
      }
      if constexpr (WITH_Y) yw[r] = sy[slot[r] * kTile] * mrow[r];
      const float diag = 1.0f + mrow[r] * (nugget + jitter);
      // slot k's column for every row that stores it: columns below the
      // lane's row the masked correlation, its own the diagonal, past it 0
      if constexpr (!COORDS) {
#pragma unroll
        for (int k = 0; k < cols(r); ++k) {
          const float rho = cf.rho(dist.pair(slot[r], k < slot[r] ? k : 0)) * mrow[r];
          a[r][k] = k < i ? rho : (k == i ? diag : 0.0f);
        }
      } else {
        // the diagonal and the zeros now; the correlations below, a slot's
        // coordinates read once for every row
#pragma unroll
        for (int k = 0; k < cols(r); ++k) a[r][k] = k == i ? diag : 0.0f;
      }
    }
    if constexpr (COORDS) {
#pragma unroll
      for (int k = 0; k < M - 1; ++k) {
        float ck[kMaxDim];
#pragma unroll
        for (int x = 0; x < kMaxDim; ++x) ck[x] = dist.coord(k, x);
#pragma unroll
        for (int r = k / T; r < R; ++r) {
          const int i = r * T + t;
          const float rho = cf.rho(TeamDistances<COORDS>::norm(oc[r], ck)) * mrow[r];
          a[r][k] = k < i ? rho : a[r][k];
        }
      }
    }
  }

  // Right-looking Cholesky of the bordered system; ff and rr start at
  // 1 + the own nugget and at y[gsite] (0 at a padded site); rr is unread
  // without y.  Column k's updates reach each entry in the order of the
  // thread-a-system bodies' Cholesky-Crout sums (j = 0, 1, ...).
  __device__ __forceinline__ void factor(float& ff, float& rr) {
    const int t = threadIdx.x & (T - 1);
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const int ko = k % T;
      const int kr = k / T;
      const float pinv = team_get<T>(rsqrtf(a[kr][k]), ko);
      const float uk = team_get<T>(cu[kr], ko) * pinv;
      [[maybe_unused]] float wk = 0.0f;
      if constexpr (WITH_Y) wk = team_get<T>(yw[kr], ko) * pinv;
      if (t == ko) {
        cu[kr] = uk;
        if constexpr (WITH_Y) yw[kr] = wk;
        inv[kr] = pinv;
      }
      ff -= uk * uk;
      if constexpr (WITH_Y) rr -= uk * wk;
#pragma unroll
      for (int r = kr; r < R; ++r) {
        a[r][k] *= pinv;  // L[i][k] on the rows below the pivot
        if (r > kr || t > ko) {
          cu[r] -= uk * a[r][k];
          if constexpr (WITH_Y) yw[r] -= wk * a[r][k];
        }
      }
#pragma unroll
      for (int j = k + 1; j < M; ++j) {
        const float ljk = team_get<T>(a[j / T][k], j % T);
#pragma unroll
        for (int r = j / T; r < R; ++r) a[r][j] -= a[r][k] * ljk;
      }
    }
  }

  // After factor: the back-substitution p = L^-T u (and q = L^-T w with y)
  // from the last column: the lane's rows below i, then the team's sum (the
  // same bits in every lane), then the owner's p_i (q_i).  Each lane holds
  // p and q of its rows; p = 0 exactly where u and the column below are.
  __device__ __forceinline__ void back_substitute(float (&p)[R],
                                                  float (&q)[WITH_Y ? R : 1]) const {
    const int t = threadIdx.x & (T - 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      p[r] = 0.0f;
      if constexpr (WITH_Y) q[r] = 0.0f;
    }
#pragma unroll
    for (int i = M - 1; i >= 0; --i) {
      const int io = i % T;
      const int ir = i / T;
      float sp = 0.0f;
      [[maybe_unused]] float sq = 0.0f;
#pragma unroll
      for (int r = ir; r < R; ++r) {
        const float l = (r > ir || t > io) ? a[r][i] : 0.0f;
        sp += l * p[r];
        if constexpr (WITH_Y) sq += l * q[r];
      }
      sp = team_sum<T>(sp);
      if constexpr (WITH_Y) sq = team_sum<T>(sq);
      if (t == io) {
        p[ir] = (cu[ir] - sp) * inv[ir];
        if constexpr (WITH_Y) q[ir] = (yw[ir] - sq) * inv[ir];
      }
    }
  }
};

// Kernel 1's team body at one site: writes f and r from the team's lane
// `adder`, which adds log F and r^2/F of a valid site to its sums.
template <int M, int T>
__device__ __forceinline__ void suffstats_team_site(
    const float* st, const TileShape& s, int ycopy, bool hetero, int adder, int col, int site,
    int gsite,
    int m, int dim, const ClosedForm& cf, float alpha, float jitter, int n,
    const float* __restrict__ y, const float* __restrict__ v, float* __restrict__ f_row,
    float* __restrict__ r_row, float& sum_logf, float& sum_q) {
  const TeamDistances<true> dist(st, s, dim, col);
  TeamSystem<M, T, false, true> sys;
  sys.build(dist, st + (s.off_y + ycopy * M) * kTile + col, st + s.off_v * kTile + col,
            hetero, min(gsite, m), cf, alpha, jitter);
  const bool valid = gsite < n;
  float ff = 1.0f + own_nugget(alpha, v, gsite);
  float bdoty = 0.0f;
  sys.factor(ff, bdoty);
  bdoty = -bdoty;  // factor subtracts u_k w_k from its start
  if ((threadIdx.x & (T - 1)) == adder) {
    const float resid = (valid ? y[gsite] : 0.0f) - bdoty;
    f_row[site] = ff;
    r_row[site] = resid;
    sum_logf += valid ? logf(ff) : 0.0f;
    sum_q += valid ? resid * resid / ff : 0.0f;
  }
}

// Kernel 2's team body at one site: the six sums of its valid site added
// to the team's lane `adder`'s, and with EMIT_Y B (every lane its rows) and
// r/F.
template <int M, int T, bool EMIT_Y, bool COORDS>
__device__ __forceinline__ void grad_team_site(
    const float* st, const TileShape& s, int ycopy, bool hetero, int adder, int col, int site,
    int gsite,
    int m, int dim, const ClosedForm& cf, float alpha, float jitter, int n,
    const float* __restrict__ y, const float* __restrict__ v, int n_pad,
    float* __restrict__ b_chain, float* __restrict__ rof_row, float (&acc)[6]) {
  using System = TeamSystem<M, T, true, COORDS>;
  constexpr int R = System::R;
  const int t = threadIdx.x & (T - 1);
  const float* sv = st + s.off_v * kTile + col;
  const TeamDistances<COORDS> dist(st, s, dim, col);
  System sys;
  sys.build(dist, st + (s.off_y + ycopy * M) * kTile + col, sv, hetero, min(gsite, m), cf,
            alpha, jitter);
  const bool valid = gsite < n;
  float ff = 1.0f + own_nugget(alpha, v, gsite);
  float rr = valid ? y[gsite] : 0.0f;
  sys.factor(ff, rr);
  float p[R];
  float q[R];
  sys.back_substitute(p, q);

  // the lane's part of p' dC/dalpha p and p' dC/dalpha q (the masked
  // identity, diag(v_N) with noise weights; p = 0 past the call's m) and of
  // the diagonal-free -2 p.dc and -dc.q; with EMIT_Y B = p of its rows
  float pp = 0.0f;
  float pq = 0.0f;
  float df_phi = 0.0f;
  float dr_phi = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float vi = hetero ? sv[sys.slot[r] * kTile] : 1.0f;
    pp += vi * p[r] * p[r];
    pq += vi * p[r] * q[r];
    df_phi -= 2.0f * p[r] * sys.dc[r];
    dr_phi -= sys.dc[r] * q[r];
    if constexpr (EMIT_Y) {
      const int i = r * T + t;
      if (i < m) b_chain[static_cast<size_t>(i) * n_pad + site] = valid ? p[r] : 0.0f;
    }
  }
  // the pairs (j, i), j > i, of the lane's rows j: p_i and q_i from their
  // owner, d rho / d phi of the pair's distance
#pragma unroll
  for (int i = 0; i < M - 1; ++i) {
    const int io = i % T;
    const int ir = i / T;
    const float pi = team_get<T>(p[ir], io);
    const float qi = team_get<T>(q[ir], io);
    [[maybe_unused]] float ci[kMaxDim];
    if constexpr (COORDS) {
#pragma unroll
      for (int x = 0; x < kMaxDim; ++x) ci[x] = dist.coord(i, x);
    }
#pragma unroll
    for (int r = ir; r < R; ++r) {
      if (r > ir || t > io) {
        float dij;
        if constexpr (COORDS) {
          dij = TeamDistances<COORDS>::norm(sys.oc[r], ci);
        } else {
          dij = dist.pair(sys.slot[r], i);
        }
        const float dcij = cf.drho(dij) * sys.mrow[r];
        df_phi += 2.0f * pi * p[r] * dcij;
        dr_phi += (pi * q[r] + p[r] * qi) * dcij;
      }
    }
  }
  pp = team_sum<T>(pp);
  pq = team_sum<T>(pq);
  df_phi = team_sum<T>(df_phi);
  dr_phi = team_sum<T>(dr_phi);

  if (t == adder) {
    const float df_a = (v != nullptr ? v[gsite] : 1.0f) + pp;
    const float dr_a = pq;
    const float inv_f = valid ? 1.0f / ff : 0.0f;
    const float r_over_f = rr * inv_f;
    const float ratio2 = r_over_f * r_over_f;
    if constexpr (EMIT_Y) rof_row[site] = valid ? r_over_f : 0.0f;
    acc[0] += valid ? logf(ff) : 0.0f;
    acc[1] += rr * r_over_f;
    acc[2] += df_phi * inv_f;
    acc[3] += 2.0f * r_over_f * dr_phi - ratio2 * df_phi;
    acc[4] += df_a * inv_f;
    acc[5] += 2.0f * r_over_f * dr_a - ratio2 * df_a;
  }
}

// Kernel 3's team body at one site (coords): B of the lane's rows
// (plane-major, every lane its own), F from the team's lane `writer`.  The system is
// bordered with c alone, and B = L^-T u is kernel 2's p.  A padded site
// (gsite >= n) factors the identity instead of its all-ones system at
// alpha = 0 (no slot is real, so every lane of the warp still takes the
// team's shuffles) and writes B = 0 and F = 1; B = 0 exactly on invalid
// slots, where u and the column below are.  The noise weights: alpha v at
// the neighbors through the stage (HETERO), alpha v_i at the site.
template <int M, int T, bool HETERO>
__device__ __forceinline__ void bf_team_site(const float* st, const TileShape& s, int writer,
                                             int col, int site, int gsite, int m, int dim,
                                             const ClosedForm& cf, float alpha, float jitter,
                                             int n, const float* __restrict__ v, int n_pad,
                                             float* __restrict__ b_chain,
                                             float* __restrict__ f_row) {
  using System = TeamSystem<M, T, false, true, false>;
  constexpr int R = System::R;
  const int t = threadIdx.x & (T - 1);
  const bool valid = gsite < n;
  const TeamDistances<true> dist(st, s, dim, col);
  System sys;
  sys.build(dist, nullptr, st + s.off_v * kTile + col, HETERO, valid ? min(gsite, m) : 0, cf,
            alpha, jitter);
  float ff = 1.0f + (HETERO && valid ? alpha * v[gsite] : alpha);
  float unused = 0.0f;
  sys.factor(ff, unused);
  float p[R];
  float no_q[1];
  sys.back_substitute(p, no_q);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * T + t;
    if (i < m) b_chain[static_cast<size_t>(i) * n_pad + site] = valid ? p[r] : 0.0f;
  }
  if (t == writer) f_row[site] = valid ? ff : 1.0f;
}

// The block's loop over its tiles (vecchia_tile.cuh's ring, walked as the
// thread-a-system bodies walk it), calling site_fn(st, adder, col, site,
// gsite) for each of the T passes over a staged tile (32 / T sites
// of the warp's chain a pass); returns whether the warp's chain is real.
// Pass p's sites add their sums to the lanes p of their teams, so that
// each lane adds one site a tile, as in the thread-a-system bodies, and a
// term passes through as many float32 additions on its way to a partial.
// Kernel 3 (WITH_Y false) stages no y: its tile gathers only v, and only
// with noise weights, as its thread-a-system body does.
template <int M, int T, bool WITH_Y = true, typename Site>
__device__ __forceinline__ bool team_tiles(const TileShape& s, const float* __restrict__ tab_a,
                                           const float* __restrict__ tab_b,
                                           const int* __restrict__ nn_idx,
                                           const float* __restrict__ y_all, int y_stride,
                                           const float* __restrict__ v, int n_pad, int chains,
                                           int off, Site&& site_fn) {
  extern __shared__ __align__(16) float ring[];
  const int group = blockDim.x / kTile;
  const int c0 = blockIdx.y * group;
  const bool active = c0 + static_cast<int>(threadIdx.x / kTile) < chains;
  const int ycopies = WITH_Y ? (y_stride != 0 ? group : 1) : 0;
  const bool gathers = WITH_Y || v != nullptr;
  const int stage_words = s.planes * kTile;
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
    if (gathers) {
      issue_gathers(st, s, M, y_all, y_stride, ycopies, c0, chains, v);
      cp_async_commit();
    }
    if (next < tiles) {
      issue_tables(ring + ((i + 1) % kStages) * stage_words, s, tab_a, tab_b, nn_idx, n_pad,
                   next);
    }
    cp_async_commit();
    if (gathers) {
      cp_async_wait<1>();  // the gathers, not the next tile's tables
      __syncthreads();
    }
    if (active) {
#pragma unroll 1
      for (int pass = 0; pass < T; ++pass) {
        const int col = pass * (kTile / T) + (threadIdx.x & 31) / T;
        const int site = tile * kTile + col;
        site_fn(st, pass, col, site, site + off);
      }
    }
  }
  return active;
}

// Kernel 2's team instances, T = team_lanes(kTeamGrad, COORDS) lanes a system (a
// template argument, so that the kernel's name carries it); the arguments of
// grad_kernel (with_nu unread).
template <int M, int T, bool EMIT_Y, bool COORDS>
__global__ void __launch_bounds__(kTile * kMaxGroup)
grad_team_kernel(const float* __restrict__ params, const float* __restrict__ tab_a,
                 const float* __restrict__ tab_b, const int* __restrict__ nn_idx,
                 const float* __restrict__ y_all, int y_stride, const float* __restrict__ v,
                 int n_pad, int m, int dim, int chains, int family,
                 float* __restrict__ part, float* __restrict__ b_out,
                 float* __restrict__ rof_out, bool /*with_nu*/) {
  const int group = blockDim.x / kTile;
  const int warp = threadIdx.x / kTile;
  const int chain = blockIdx.y * group + warp;
  const int safe = min(chain, chains - 1);
  const float* pr = params + safe * kParams;
  const float alpha = pr[1];
  const float jitter = pr[2];
  const int n = static_cast<int>(pr[3]);
  const int off = static_cast<int>(pr[5]);  // the shard's first global site
  const float* y = y_all + static_cast<size_t>(safe) * y_stride;
  const ClosedForm cf = closed_form(family, pr[0]);
  float* b_chain = EMIT_Y ? b_out + static_cast<size_t>(safe) * m * n_pad : nullptr;
  float* rof_row = EMIT_Y ? rof_out + static_cast<size_t>(safe) * n_pad : nullptr;
  const TileShape s = tile_shape(m, M, dim, COORDS, y_stride != 0 ? group : 1, v != nullptr);
  const int ycopy = y_stride != 0 ? warp : 0;
  float acc[6] = {};
  const bool active = team_tiles<M, T>(
      s, tab_a, tab_b, nn_idx, y_all, y_stride, v, n_pad, chains, off,
      [&](const float* st, int adder, int col, int site, int gsite) {
        grad_team_site<M, T, EMIT_Y, COORDS>(st, s, ycopy, v != nullptr, adder, col, site,
                                             gsite, m, dim, cf, alpha, jitter, n, y, v,
                                             n_pad, b_chain, rof_row, acc);
      });
  if (active) warp_sum_store<6>(acc, part, chains * gridDim.x, chain * gridDim.x + blockIdx.x);
}

// Kernel 1's team instance (coords), T = team_lanes(kTeamSuffstats, true)
// lanes a system; the arguments of suffstats_kernel.
template <int M, int T>
__global__ void __launch_bounds__(kTile * kMaxGroup)
suffstats_team_kernel(const float* __restrict__ params, const float* __restrict__ tab_a,
                      const float* __restrict__ tab_b, const int* __restrict__ nn_idx,
                      const float* __restrict__ y_all, int y_stride, const float* __restrict__ v,
                      int n_pad, int m, int dim, int chains, int family,
                      float* __restrict__ f_out, float* __restrict__ r_out,
                      float* __restrict__ part) {
  const int group = blockDim.x / kTile;
  const int warp = threadIdx.x / kTile;
  const int chain = blockIdx.y * group + warp;
  const int safe = min(chain, chains - 1);
  const float* pr = params + safe * kParams;
  const float alpha = pr[1];
  const float jitter = pr[2];
  const int n = static_cast<int>(pr[3]);
  const int off = static_cast<int>(pr[5]);
  const float* y = y_all + static_cast<size_t>(safe) * y_stride;
  const ClosedForm cf = closed_form(family, pr[0]);
  float* f_row = f_out + static_cast<size_t>(chain) * n_pad;
  float* r_row = r_out + static_cast<size_t>(chain) * n_pad;
  const TileShape s = tile_shape(m, M, dim, true, y_stride != 0 ? group : 1, v != nullptr);
  const int ycopy = y_stride != 0 ? warp : 0;
  float sum_logf = 0.0f;
  float sum_q = 0.0f;
  const bool active = team_tiles<M, T>(
      s, tab_a, tab_b, nn_idx, y_all, y_stride, v, n_pad, chains, off,
      [&](const float* st, int adder, int col, int site, int gsite) {
        suffstats_team_site<M, T>(st, s, ycopy, v != nullptr, adder, col, site, gsite, m,
                                  dim, cf, alpha, jitter, n, y, v, f_row, r_row, sum_logf,
                                  sum_q);
      });
  if (active) {
    const float sums[2] = {sum_logf, sum_q};
    warp_sum_store<2>(sums, part, chains * gridDim.x, chain * gridDim.x + blockIdx.x);
  }
}

// Kernel 3's team instances (coords), T = team_lanes(kTeamBf, true) lanes a
// system, the noise weights a template parameter (HETERO) as in bf_kernel;
// the arguments of bf_kernel.
template <int M, int T, bool HETERO>
__global__ void __launch_bounds__(kTile * kMaxGroup)
bf_team_kernel(const float* __restrict__ params, const float* __restrict__ tab_a,
               const float* __restrict__ tab_b, const int* __restrict__ nn_idx,
               const float* __restrict__ v, int n_pad, int m, int dim, int chains, int family,
               float* __restrict__ b_out, float* __restrict__ f_out) {
  const int group = blockDim.x / kTile;
  const int chain = blockIdx.y * group + static_cast<int>(threadIdx.x / kTile);
  const int safe = min(chain, chains - 1);
  const float* pr = params + safe * kParams;
  const float alpha = pr[1];
  const float jitter = pr[2];
  const int n = static_cast<int>(pr[3]);
  const int off = static_cast<int>(pr[5]);
  const ClosedForm cf = closed_form(family, pr[0]);
  float* b_chain = b_out + static_cast<size_t>(safe) * m * n_pad;
  float* f_row = f_out + static_cast<size_t>(safe) * n_pad;
  const TileShape s = tile_shape(m, M, dim, true, 0, HETERO, HETERO);
  const float* vh = HETERO ? v : nullptr;
  team_tiles<M, T, false>(s, tab_a, tab_b, nn_idx, nullptr, 0, vh, n_pad, chains, off,
                          [&](const float* st, int writer, int col, int site, int gsite) {
                            bf_team_site<M, T, HETERO>(st, s, writer, col, site, gsite, m,
                                                       dim, cf, alpha, jitter, n, vh, n_pad,
                                                       b_chain, f_row);
                          });
}

}  // namespace
}  // namespace vecchia
