// Kernels 1 and 3 for 32 < m <= kSmemM: each (site, chain) system factored
// by one warp, its factor in shared memory in float64.  The launchers of
// vecchia_suffstats_body.cuh and vecchia_bf_body.cuh send such calls here;
// above kSmemM they keep the scratch body of vecchia_large_m.cuh.  Kernel 2
// builds on the same pieces (the fill with WITH_D, the factor) in
// vecchia_grad_smem.cuh, up to its own limit kSmemGradM.
//
// What bounded the scratch body (one thread a (site, chain), its factor in a
// per-thread slice of a device buffer): its left-looking Cholesky loads
// about m^3/3 float64 words a system from that buffer, ~120 GB at m = 64,
// n_pad = 10,112 and 16 chains, from a 2.6 GB buffer far beyond the 50 MB
// L2, so the loads went to device memory: ~36 ms of its 52.5 (PERF.md).
// Here no state leaves the SM.
//
// Design.  A block is `group` warps (up to kMaxGroup chains of one site, as
// many systems as fit its shared memory), and walks the sites blockIdx.x,
// blockIdx.x + gridDim.x, ... (static: each chain's partials have a fixed
// order).  For each site:
//   1. Fill: the block's threads build every warp's system in shared memory,
//      each pair distance read once from the tables (plane-major: a distance
//      of one site is one word of its plane) or recomputed once from the
//      coordinates, and its correlation evaluated for every chain of the
//      block.  The system is bordered: rows mp and mp + 1 below the mp x mp
//      correlation hold c (the site's correlations with its neighbors) and,
//      in kernel 1, y_N, so the factorization produces u = L^-1 c and
//      w = L^-1 y_N as its last two rows.  mp is m rounded up to kPanel;
//      slots m..mp-1 are identity rows, as masked slots are.
//   2. Factor: each warp factors its own system in place, kPanel columns a
//      step: the lanes take the rows k0 + lane + 32 t, two a lane a pass
//      while more than 32 rows are left, and for the step's four columns
//      subtract each row's dot products over the columns before k0 (a load
//      of the row's element and two 16-byte broadcasts of the panel rows,
//      shared by the pass's rows, for four FMAs a row); then the 4 x 4
//      corner runs in registers with shuffles.  Sums run in the scratch
//      body's order (columns 0, 1, ...), pivots by rsqrt: the same
//      recurrence as before.
//   3. Kernel 1: F = 1 + alpha (v) - u.u and r = y - u.w by warp reductions,
//      F and r stored, log F and r^2/F added to the warp's sums over the
//      sites < n.  Kernel 3: F, and B = L^-T u by back-substitution in
//      place over row mp, four slots a step; padded sites (gsite >= n)
//      write B = 0 and F = 1 and factor nothing.
// A site's outputs depend on its own system alone, so a sharded launch gives
// the unsharded launch's bits (chip_smoke.py path 27).
//
// Layout of one system: columns 0..mp-1 of a lower triangle of
// rows = mp + 2 rows, column k holding rows k..rows-1 (the diagonal stores
// 1/L_kk), its length rounded up to odd so that column k starts at a word of
// k's parity: the panel rows k0..k0+3 of any column then start on a 16-byte
// boundary, and a lane's loads down a column are consecutive words (no bank
// conflicts).  smem_system_doubles(m) words a warp; at m = 64 that is 2,240
// (17,920 bytes), four warps 71,680 bytes, three blocks an SM.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; n=10,000, m=64, 16 chains,
// sqexp; tools/time_trees.py --large, PERF.md): kernel 1 5.1 ms and kernel
// 3 5.6 ms on dist, 22-24x their float32-operation bound.  In this body's
// first version (kernel 1 4.9 ms) kernel 1 took 3.5 ms with the fill's
// tables and exponentials taken out and 2.1 ms with the factor taken out:
// the two halves overlap only across blocks, as a block's warps wait for
// each other at the fill.  The factor is bound by shared-memory traffic and
// its serial steps (a 4 x 4 corner with shuffles every four columns), not by
// float64 throughput (~0.8 ms of FMAs); the fill by its scattered table
// loads, one 32-byte sector a distance.  Three blocks of four warps an SM at
// m = 64 (shared memory); at m = 128 one block of three warps, whose latency
// nothing hides (kernel 1 72 ms).  Taken: two rows a lane a pass while more
// than 32 rows are left (kernel 3 -14%, kernel 1 -6% on coords and +4% on
// dist), the back-substitution four slots a step (kernel 3 -7%).  Not
// taken: four 8-byte broadcasts in place of two 16-byte ones (kernel 3
// -10%, kernel 1 +5-18%), B in registers during the back-substitution
// (+24%), the fill's loop unrolled (+-5%, mixed).
//
// Numbers: as the scratch body: float64 distances, closed forms
// (ClosedForm64), products, sums and factor; the general-nu rho from the
// float32 Bessel routines; B, F and r rounded to float32 as they are stored.
#pragma once

#include <cstddef>

#include "vecchia_large_m.cuh"

namespace vecchia {
namespace {

constexpr int kPanel = 4;  // columns a factorization step

// m rounded up to kPanel: the system's slots
__host__ __device__ constexpr int smem_mp(int m) { return (m + kPanel - 1) / kPanel * kPanel; }

// First word of column k of a system whose columns hold `rows` rows less k,
// each rounded up to an odd count.
__host__ __device__ constexpr int smem_col_start(int k, int rows) {
  return k * rows - k * (k - 1) / 2 + ((rows & 1) ? k / 2 : (k + 1) / 2);
}

// float64 words of one system (mp columns of mp + 2 rows).
__host__ __device__ constexpr int smem_system_doubles(int m) {
  return smem_col_start(smem_mp(m), smem_mp(m) + 2);
}

// The largest m whose one system fits a block's shared memory
// (ops/geometry.py M_SMEM computes the same).
constexpr int smem_max_m() {
  int m = kRolledM;
  while (smem_system_doubles(m + 1) * 8 <= kMaxRingBytes) ++m;
  return m;
}
constexpr int kSmemM = smem_max_m();
static_assert(kSmemM == 236, "ops/geometry.py M_SMEM takes the same value");

// Whether a call of kernel 1 or 3 runs this body.
__host__ inline bool smem_launch(int m) { return large_launch(m) && m <= kSmemM; }

// The wrapper's geometry for a shared-memory body: group warps (chains) a
// block, grid_x blocks along the sites, group systems of `words` float64
// words each, no scratch buffer.
__host__ inline bool valid_systems(int n_pad, int words, int group, int grid_x,
                                   int smem_bytes, const double* scratch) {
  return group >= 1 && group <= kMaxGroup && grid_x >= 1 && grid_x <= n_pad &&
         scratch == nullptr && smem_bytes == group * words * 8 && smem_bytes <= kMaxRingBytes;
}

__host__ inline bool valid_smem(int n_pad, int m, int group, int grid_x, int smem_bytes,
                                const double* scratch) {
  return valid_systems(n_pad, smem_system_doubles(m), group, grid_x, smem_bytes, scratch);
}

// The block's chains and its warp's system.
struct SmemGroup {
  int c0;      // the block's first chain
  int active;  // its chains (a ragged last group has spare warps)
  int warp;
  int lane;
  int mp;
  int rows;         // layout rows: mp + 2
  int sys_doubles;  // words a system (kernel 2: with its two vectors)
  int vec;          // kernel 2: first word of the vectors dc and dcn after the triangle
  double* sys0;     // the block's first system
};

// `sys_doubles`: the words a warp's system takes, smem_system_doubles(m)
// unless the body keeps more beside the triangle.
__device__ __forceinline__ SmemGroup smem_group(double* smem, int chains, int m,
                                                int sys_doubles) {
  SmemGroup g;
  const int group = blockDim.x >> 5;
  g.c0 = blockIdx.y * group;
  g.active = min(group, chains - g.c0);
  g.warp = threadIdx.x >> 5;
  g.lane = threadIdx.x & 31;
  g.mp = smem_mp(m);
  g.rows = g.mp + 2;
  g.sys_doubles = sys_doubles;
  g.vec = smem_system_doubles(m);
  g.sys0 = smem;
  return g;
}

__device__ __forceinline__ SmemGroup smem_group(double* smem, int chains, int m) {
  return smem_group(smem, chains, m, smem_system_doubles(m));
}

// What the fill needs of each of the block's chains, in registers.
struct GroupChains {
  double scale[kMaxGroup];  // closed forms: t = scale d (ClosedForm64.scale)
  double inv_phi[kMaxGroup];  // closed forms: d rho / d phi is 1/phi times the phi = 1 shape's
  double alpha[kMaxGroup];
  double jitter[kMaxGroup];
  const float* y[kMaxGroup];
};

__device__ __forceinline__ GroupChains group_chains(const float* __restrict__ params,
                                                   const SmemGroup& g, int family,
                                                   const float* __restrict__ y_all,
                                                   int y_stride) {
  GroupChains ch;
#pragma unroll
  for (int c = 0; c < kMaxGroup; ++c) {
    const int chain = g.c0 + min(c, g.active - 1);
    const float* pr = params + chain * kParams;
    ch.scale[c] = family == kMaternGeneral ? 0.0 : closed_form64(family, pr[0]).scale;
    ch.inv_phi[c] = 1.0 / pr[0];
    ch.alpha[c] = pr[1];
    ch.jitter[c] = pr[2];
    ch.y[c] = y_all + static_cast<size_t>(chain) * y_stride;
  }
  return ch;
}

// The MaternSet of each of the block's chains (GENERAL), or null: lane 0 of
// each warp builds its chain's, with the two ends of the difference in nu
// where `with_nu` (kernel 2 for a sampled nu).  Every thread of the block
// must call it.
template <bool GENERAL>
__device__ __forceinline__ const MaternSet* group_matern_sets(const float* __restrict__ params,
                                                              const SmemGroup& g,
                                                              bool with_nu = false) {
  if constexpr (GENERAL) {
    __shared__ MaternSet sets[kMaxGroup];
    if (g.lane == 0 && g.warp < g.active) {
      const float* pr = params + (g.c0 + g.warp) * kParams;
      make_matern_set(pr[0], pr[4], with_nu, &sets[g.warp]);
    }
    __syncthreads();
    return sets;
  } else {
    return nullptr;
  }
}

// rho of chain c at distance d: the closed form with its scale in float64,
// or the general-nu Matern through its set (float32).
template <bool GENERAL>
__device__ __forceinline__ double group_rho(const ClosedForm64& shape, double scale, double d,
                                            const MaternSet* set) {
  if constexpr (GENERAL) {
    return rho_general(static_cast<float>(d), &set->at);
  } else {
    const double t = fmin(scale * d, shape.t_max);
    return (1.0 + t * (shape.c1 + t * (shape.c2 + t * shape.c3))) * shape.decay(t);
  }
}

// Step 1: every active chain's bordered system of `site` into its warp's
// words, by all the block's threads.  Strict lower entries in column-major
// order (consecutive threads write consecutive words), then each slot's
// diagonal, c and (WITH_Y) y_N.  Slot k is real iff lim = min(gsite, m) > k;
// the others are identity rows, and rows mp + 1 stay unwritten without y.
// WITH_D (kernel 2) also writes the masked d c / d phi and d c / d nu (zero
// unless `with_nu`) into the vectors at g.vec, c from the same evaluation
// (the general nu: rho_drho_general's rho, as the scratch body takes it).
template <bool GENERAL, bool COORDS, bool WITH_Y, bool WITH_D = false>
__device__ void smem_fill(const SmemGroup& g, const GroupChains& ch, const ClosedForm64& shape,
                          const MaternSet* sets, const GlobalDistances<COORDS>& dist,
                          const int* __restrict__ nn_idx, const float* __restrict__ v,
                          int n_pad, int site, int lim, bool with_nu = false) {
  const int mp = g.mp;
  const int pairs = mp * (mp - 1) / 2;
  for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
    // the q-th strict lower entry, column-major: counted from the last
    // column back, entry r lies in reversed column cc with
    // cc(cc+1)/2 <= r < (cc+1)(cc+2)/2
    const int r = pairs - 1 - q;
    int cc = static_cast<int>((sqrtf(8.0f * r + 1.0f) - 1.0f) * 0.5f);
    if ((cc + 1) * (cc + 2) / 2 <= r) {
      ++cc;
    } else if (cc * (cc + 1) / 2 > r) {
      --cc;
    }
    const int k = mp - 2 - cc;
    const int i = mp - 1 - (r - cc * (cc + 1) / 2);
    const int at = smem_col_start(k, g.rows) - k + i;
    const bool real = lim > i;  // mask_i * mask_k, as i > k
    const double d = real ? dist.pair(i, k) : 0.0;
#pragma unroll
    for (int c = 0; c < kMaxGroup; ++c) {
      if (c < g.active) {
        g.sys0[c * g.sys_doubles + at] =
            real ? group_rho<GENERAL>(shape, ch.scale[c], d, sets + c) : 0.0;
      }
    }
  }
  for (int k = threadIdx.x; k < mp; k += blockDim.x) {
    const bool real = lim > k;
    const int nbr =
        real && (WITH_Y || v != nullptr) ? nn_idx[static_cast<size_t>(k) * n_pad + site] : 0;
    const double dk = real ? dist.in(k) : 0.0;
    const double vk = real && v != nullptr ? static_cast<double>(v[nbr]) : 1.0;
    const int base = smem_col_start(k, g.rows) - k;
#pragma unroll
    for (int c = 0; c < kMaxGroup; ++c) {
      if (c < g.active) {
        double* a = g.sys0 + c * g.sys_doubles + base;
        a[k] = real ? 1.0 + (ch.alpha[c] * vk + ch.jitter[c]) : 1.0;
        if constexpr (WITH_D) {
          double* dc = g.sys0 + c * g.sys_doubles + g.vec;  // dc[k], then dcn[k] at mp + k
          if constexpr (GENERAL) {
            const float dk32 = static_cast<float>(dk);
            const float2 rd = real ? rho_drho_general(dk32, &sets[c].at) : make_float2(0.0f, 0.0f);
            a[mp] = rd.x;
            dc[k] = rd.y;
            dc[mp + k] = real && with_nu ? drho_dnu_general(dk32, sets + c) : 0.0;
          } else {
            const double t = fmin(ch.scale[c] * dk, shape.t_max);
            const double e = shape.decay(t);
            a[mp] = real ? (1.0 + t * (shape.c1 + t * (shape.c2 + t * shape.c3))) * e : 0.0;
            dc[k] = real ? ch.inv_phi[c] * (t * (shape.d1 + t * (shape.d2 + t * shape.d3)) * e)
                         : 0.0;
            dc[mp + k] = 0.0;
          }
        } else {
          a[mp] = real ? group_rho<GENERAL>(shape, ch.scale[c], dk, sets + c) : 0.0;
        }
        if constexpr (WITH_Y) a[mp + 1] = real ? static_cast<double>(ch.y[c][nbr]) : 0.0;
      }
    }
  }
}

// One pass of a panel step over the rows t0 + lane + 32 h, h < ROWS, of the
// columns k0..k0+3: each row's dot products over the columns before k0 (its
// element and the panel rows' two 16-byte broadcasts a column, shared by the
// ROWS rows), then the 4 x 4 corner: computed from lanes 0..3 (rows
// k0..k0+3) in the step's first pass, applied from inv and corner after.
template <int ROWS>
__device__ __forceinline__ void panel_pass(double* a, int rows, int nrows, int k0, int t0,
                                           bool first, double (&inv)[kPanel],
                                           double (&corner)[kPanel][kPanel]) {
  const int lane = threadIdx.x & 31;
  int row[ROWS];
  double s[ROWS][kPanel];
#pragma unroll
  for (int h = 0; h < ROWS; ++h) {
    row[h] = min(t0 + 32 * h + lane, nrows - 1);  // a lane past the last row reads it
#pragma unroll
    for (int c = 0; c < kPanel; ++c) {
      s[h][c] = row[h] >= k0 + c ? a[smem_col_start(k0 + c, rows) - (k0 + c) + row[h]] : 0.0;
    }
  }
  int bj = 0;  // column j's base: its word of row r is bj + r
#pragma unroll 4
  for (int j = 0; j < k0; ++j) {
    const double2 p01 = *reinterpret_cast<const double2*>(a + bj + k0);
    const double2 p23 = *reinterpret_cast<const double2*>(a + bj + k0 + 2);
#pragma unroll
    for (int h = 0; h < ROWS; ++h) {
      const double l = a[bj + row[h]];
      s[h][0] -= l * p01.x;
      s[h][1] -= l * p01.y;
      s[h][2] -= l * p23.x;
      s[h][3] -= l * p23.y;
    }
    bj += ((rows - j) | 1) - 1;
  }
  if (first) {
#pragma unroll
    for (int c = 0; c < kPanel; ++c) {
      inv[c] = rsqrt(__shfl_sync(0xffffffffu, s[0][c], c));
      s[0][c] *= inv[c];
#pragma unroll
      for (int c2 = c + 1; c2 < kPanel; ++c2) {
        corner[c2][c] = __shfl_sync(0xffffffffu, s[0][c], c2);
        s[0][c2] -= s[0][c] * corner[c2][c];
      }
    }
  }
#pragma unroll
  for (int h = 0; h < ROWS; ++h) {
    if (h == 0 && first) continue;  // done above
#pragma unroll
    for (int c = 0; c < kPanel; ++c) {
      s[h][c] *= inv[c];
#pragma unroll
      for (int c2 = c + 1; c2 < kPanel; ++c2) s[h][c2] -= s[h][c] * corner[c2][c];
    }
  }
#pragma unroll
  for (int h = 0; h < ROWS; ++h) {
    const int i = t0 + 32 * h + lane;
    if (i >= nrows) continue;
#pragma unroll
    for (int c = 0; c < kPanel; ++c) {
      if (i >= k0 + c) a[smem_col_start(k0 + c, rows) - (k0 + c) + i] = i == k0 + c ? inv[c] : s[h][c];
    }
  }
}

// Step 2: one warp factors its system `a` in place over rows 0..nrows-1 (of
// the layout's `rows`): L below the diagonal, 1/L_kk on it, and the border
// rows become u (row mp) and w (row mp + 1).  A lane takes two rows a pass
// where the step has more than 32 rows left, one otherwise.
__device__ void smem_factor(double* a, int mp, int rows, int nrows) {
#pragma unroll 1
  for (int k0 = 0; k0 < mp; k0 += kPanel) {
    double inv[kPanel];
    double corner[kPanel][kPanel];  // corner[c2][c] = L[k0 + c2][k0 + c], c < c2
    int t0 = k0;
    while (t0 < nrows) {
      if (t0 + 32 < nrows) {
        panel_pass<2>(a, rows, nrows, k0, t0, t0 == k0, inv, corner);
        t0 += 64;
      } else {
        panel_pass<1>(a, rows, nrows, k0, t0, t0 == k0, inv, corner);
        t0 += 32;
      }
    }
    __syncwarp();
  }
}

// The sum of x over the warp, the same in every lane (xor butterfly).
__device__ __forceinline__ double warp_total(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Kernel 1 for 32 < m <= kSmemM: F and r per (chain, site), one partial of
// sum log F and sum r^2/F per (block, chain) over the sites < n.
template <bool GENERAL, bool COORDS>
__global__ void __launch_bounds__(kTile * kMaxGroup)
suffstats_smem_kernel(const float* __restrict__ params, const float* __restrict__ tab_a,
                      const float* __restrict__ tab_b, const int* __restrict__ nn_idx,
                      const float* __restrict__ y_all, int y_stride,
                      const float* __restrict__ v, int n_pad, int m, int dim, int chains,
                      int family, float* __restrict__ f_out, float* __restrict__ r_out,
                      float* __restrict__ part) {
  extern __shared__ __align__(16) double systems[];
  const SmemGroup g = smem_group(systems, chains, m);
  const MaternSet* sets = group_matern_sets<GENERAL>(params, g);
  const GroupChains ch = group_chains(params, g, GENERAL ? kMaternGeneral : family, y_all,
                                      y_stride);
  const ClosedForm64 shape = GENERAL ? ClosedForm64{} : closed_form64(family, 1.0f);
  const bool mine = g.warp < g.active;
  const int chain = g.c0 + min(g.warp, g.active - 1);
  const float* pr = params + chain * kParams;
  const double alpha = pr[1];
  const int n = static_cast<int>(pr[3]);
  const int off = static_cast<int>(params[g.c0 * kParams + 5]);  // the shard's first site
  const float* y = y_all + static_cast<size_t>(chain) * y_stride;
  double* a = g.sys0 + g.warp * g.sys_doubles;
  double sum_logf = 0.0;
  double sum_q = 0.0;
  for (int site = blockIdx.x; site < n_pad; site += gridDim.x) {
    const int gsite = site + off;
    const GlobalDistances<COORDS> dist(tab_a, tab_b, dim, n_pad, site);
    smem_fill<GENERAL, COORDS, true>(g, ch, shape, sets, dist, nn_idx, v, n_pad, site,
                                     min(gsite, m));
    __syncthreads();
    if (mine) {
      smem_factor(a, g.mp, g.rows, g.rows);
      double uu = 0.0;
      double uw = 0.0;
      for (int j = g.lane; j < g.mp; j += 32) {
        const double* col = a + smem_col_start(j, g.rows) - j;
        uu += col[g.mp] * col[g.mp];
        uw += col[g.mp] * col[g.mp + 1];
      }
      uu = warp_total(uu);
      uw = warp_total(uw);
      const double ff = 1.0 + (v != nullptr ? alpha * v[gsite] : alpha) - uu;
      const bool valid = gsite < n;
      const double resid = (valid ? y[gsite] : 0.0) - uw;
      if (g.lane == 0) {
        f_out[static_cast<size_t>(chain) * n_pad + site] = static_cast<float>(ff);
        r_out[static_cast<size_t>(chain) * n_pad + site] = static_cast<float>(resid);
      }
      sum_logf += valid ? log(ff) : 0.0;
      sum_q += valid ? resid * resid / ff : 0.0;
    }
    __syncthreads();  // every warp is done with its system before the next fill
  }
  if (mine && g.lane == 0) {
    part[chain * gridDim.x + blockIdx.x] = static_cast<float>(sum_logf);
    part[(chains + chain) * gridDim.x + blockIdx.x] = static_cast<float>(sum_q);
  }
}

// Kernel 3 for 32 < m <= kSmemM: B (C, m, n_pad) and F (C, n_pad); padded
// sites B = 0, F = 1.
template <bool GENERAL, bool COORDS>
__global__ void __launch_bounds__(kTile * kMaxGroup)
bf_smem_kernel(const float* __restrict__ params, const float* __restrict__ tab_a,
               const float* __restrict__ tab_b, const int* __restrict__ nn_idx,
               const float* __restrict__ v, int n_pad, int m, int dim, int chains, int family,
               float* __restrict__ b_out, float* __restrict__ f_out) {
  extern __shared__ __align__(16) double systems[];
  const SmemGroup g = smem_group(systems, chains, m);
  const MaternSet* sets = group_matern_sets<GENERAL>(params, g);
  const GroupChains ch = group_chains(params, g, GENERAL ? kMaternGeneral : family, nullptr, 0);
  const ClosedForm64 shape = GENERAL ? ClosedForm64{} : closed_form64(family, 1.0f);
  const bool mine = g.warp < g.active;
  const int chain = g.c0 + min(g.warp, g.active - 1);
  const double alpha = params[chain * kParams + 1];
  const int n = static_cast<int>(params[g.c0 * kParams + 3]);
  const int off = static_cast<int>(params[g.c0 * kParams + 5]);  // the shard's first site
  double* a = g.sys0 + g.warp * g.sys_doubles;
  const int mp = g.mp;
  for (int site = blockIdx.x; site < n_pad; site += gridDim.x) {
    float* b_site = b_out + static_cast<size_t>(chain) * m * n_pad + site;  // m planes
    float* f_site = f_out + static_cast<size_t>(chain) * n_pad + site;
    const int gsite = site + off;
    if (gsite >= n) {  // the same for the whole block
      if (mine) {
        for (int i = g.lane; i < m; i += 32) b_site[static_cast<size_t>(i) * n_pad] = 0.0f;
        if (g.lane == 0) *f_site = 1.0f;
      }
      continue;
    }
    const GlobalDistances<COORDS> dist(tab_a, tab_b, dim, n_pad, site);
    smem_fill<GENERAL, COORDS, false>(g, ch, shape, sets, dist, nn_idx, v, n_pad, site,
                                      min(gsite, m));
    __syncthreads();
    if (mine) {
      smem_factor(a, mp, g.rows, mp + 1);
      double uu = 0.0;
      for (int j = g.lane; j < mp; j += 32) {
        const double u = a[smem_col_start(j, g.rows) - j + mp];
        uu += u * u;
      }
      uu = warp_total(uu);
      if (g.lane == 0) {
        *f_site = static_cast<float>(1.0 + (v != nullptr ? alpha * v[gsite] : alpha) - uu);
      }
      // B = L^-T u over row mp, four slots a step from the last (slots
      // >= m hold u = 0 and give B = 0): the 4 x 4 corner in every lane
      // from broadcast reads, then each lane's earlier slots
#pragma unroll 1
      for (int i0 = mp - kPanel; i0 >= 0; i0 -= kPanel) {
        double b[kPanel];
#pragma unroll
        for (int c = kPanel - 1; c >= 0; --c) {
          const double* ci = a + smem_col_start(i0 + c, g.rows) - (i0 + c);  // ci[r] = L[r][i0+c]
          double x = ci[mp];
#pragma unroll
          for (int c2 = c + 1; c2 < kPanel; ++c2) x -= ci[i0 + c2] * b[c2];
          b[c] = x * ci[i0 + c];  // times 1/L_ii
        }
        __syncwarp();  // every lane has read the step's x
        if (g.lane < kPanel) {
          a[smem_col_start(i0 + g.lane, g.rows) - (i0 + g.lane) + mp] =
              g.lane == 0 ? b[0] : g.lane == 1 ? b[1] : g.lane == 2 ? b[2] : b[3];
        }
        for (int j = g.lane; j < i0; j += 32) {
          double* cj = a + smem_col_start(j, g.rows) - j;
          cj[mp] -= cj[i0] * b[0] + cj[i0 + 1] * b[1] + cj[i0 + 2] * b[2] + cj[i0 + 3] * b[3];
        }
        __syncwarp();
      }
      for (int i = g.lane; i < m; i += 32) {
        b_site[static_cast<size_t>(i) * n_pad] =
            static_cast<float>(a[smem_col_start(i, g.rows) - i + mp]);
      }
    }
    __syncthreads();  // every warp is done with its system before the next fill
  }
}

// The launches (valid_smem checked by the caller); return cudaGetLastError().
template <bool GENERAL, bool COORDS>
int launch_suffstats_smem(const float* params, const float* tab_a, const float* tab_b,
                          const int* nn_idx, const float* y, int y_stride, const float* v,
                          int n_pad, int m, int dim, int chains, int family, int group,
                          int grid_x, int smem_bytes, float* f_out, float* r_out, float* part,
                          cudaStream_t st) {
  auto kern = suffstats_smem_kernel<GENERAL, COORDS>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<dim3(grid_x, (chains + group - 1) / group), kTile * group, smem_bytes, st>>>(
      params, tab_a, tab_b, nn_idx, y, y_stride, v, n_pad, m, dim, chains, family, f_out,
      r_out, part);
  return static_cast<int>(cudaGetLastError());
}

template <bool GENERAL, bool COORDS>
int launch_bf_smem(const float* params, const float* tab_a, const float* tab_b,
                   const int* nn_idx, const float* v, int n_pad, int m, int dim, int chains,
                   int family, int group, int grid_x, int smem_bytes, float* b_out,
                   float* f_out, cudaStream_t st) {
  auto kern = bf_smem_kernel<GENERAL, COORDS>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<dim3(grid_x, (chains + group - 1) / group), kTile * group, smem_bytes, st>>>(
      params, tab_a, tab_b, nn_idx, v, n_pad, m, dim, chains, family, b_out, f_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace vecchia
