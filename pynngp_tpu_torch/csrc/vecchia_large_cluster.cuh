// Kernels 1 and 3 for kSmemM < m <= kClusterM: each (site, chain) system
// factored by one thread-block cluster, its float64 factor spread over the
// shared memory of the cluster's blocks.  The launchers of
// vecchia_suffstats_body.cuh and vecchia_bf_body.cuh send such calls here,
// between the shared-memory body (vecchia_large_smem.cuh, one warp a system,
// up to kSmemM = 236) and the scratch body (vecchia_large_m.cuh, above
// kClusterM).  Kernel 2 runs on the same pieces above kSmemGradM
// (vecchia_grad_cluster.cuh).
//
// What bounded the scratch body above kSmemM (one thread a (site, chain),
// its factor in a per-thread slice of a device buffer): its left-looking
// Cholesky loads about m^3/3 float64 words a system from that buffer, far
// beyond the 50 MB L2, one dependent load a multiply-add; at m = 237 that
// is ~4.4 M words a system, waited for one at a time.  Here no state leaves
// the cluster.
//
// Design.  A cluster of k blocks (k the smallest of 2, 4, 8 whose blocks
// hold the system: cluster_blocks) takes one (chain, site) system at a time,
// walking the sites of its chain in a static stride (so each chain's
// partials have a fixed order).  The system is the shared-memory body's
// bordered one, m rounded up to kClusterPanel columns (mp) of rows = mp + 2
// rows: the correlation, then the border rows c and (kernel 1) y_N, so that
// the factor's last two rows are u = L^-1 c and w = L^-1 y_N.  Its columns
// go in panels of kClusterPanel (P) columns to the blocks in a snake order
// (0, 1, .., k-1, k-1, .., 0, 0, 1, ..: cluster_owner), which keeps the
// blocks' bytes and trailing work balanced; a block holds each of its
// panels column-major, P columns of rows - c0 words (c0 the panel's first
// column; the unused upper corner included).
//   1. Fill: each block builds its own columns from the tables (each
//      distance read or recomputed in float64 where its entry is written).
//   2. Factor, right-looking by panels.  The owner of panel j factors it
//      (every thread solves the P x P corner in registers, then the block
//      scales the rows below) and writes the rows below the corner to a
//      hand-off slot in device memory as it goes (its SM's, by j's parity);
//      a cluster barrier; every block copies them from L2 into a staging
//      buffer and subtracts their rank-P product from each of its own later
//      panels, a warp a chunk of kClusterChunk rows of a panel at a time,
//      with float64 FMAs (kClusterChunk / 32 rows a lane, P accumulators a
//      row; the float64 tensor cores, mma.sync m8n8k4, ran no faster: the
//      update is a few percent of the time, PERF.md).  Look-ahead: the
//      owner of panel j + 1 updates that panel first, in chunks of
//      kClusterAheadChunk rows so that every warp takes part, factors it and
//      arrives at the next barrier before updating the rest, so the barrier
//      waits for one panel's work, not for a block's whole update.  One
//      cluster barrier a panel.  The hand-off goes through L2 and not
//      distributed shared memory: copied from the owner's shared memory by
//      every block at once, a panel went through the owner's SM alone, and
//      the copies took ~5 us a panel at m = 600 (PERF.md).  Distributed
//      shared memory carries the small exchanges: each block's SM, kernel
//      1's sums and kernel 3's solved values.
//   3. Kernel 1: each block sums u.u and u.w over its own columns (a fixed
//      order), block rank 0 adds the blocks' sums in rank order through
//      distributed shared memory and writes F and r; its thread 0 keeps the
//      cluster's sums of log F and r^2/F over the sites < n in float64, one
//      partial a (cluster, chain), rounded once.
//   4. Kernel 3: B = L^-T u by back-substitution over row mp in reverse
//      panel order: the owner of panel j solves its P unknowns, a cluster
//      barrier, and every block reads the P solved values from the owner
//      and subtracts them from its own earlier columns' right-hand sides
//      (the owner of panel j - 1 first, as in the factor).  Padded sites
//      (gsite >= n) write B = 0 and F = 1 and factor nothing.
// Every remote read of a block (of another block's shared memory or of a
// slot) comes before its next arrival at a cluster barrier, and a block
// overwrites its shared memory (the next system's fill) only after the last
// barrier of the system, and a slot only two panels later, so no block
// reads a value that has moved; the kernel ends with a cluster barrier, so
// that no block exits while another may read its shared memory.  A site's
// outputs depend on its own system alone, so a sharded launch gives the
// unsharded launch's bits (chip_smoke.py path 27).
//
// Numbers: as the shared-memory body: float64 distances, closed forms
// (ClosedForm64), products, sums and factor; the general-nu rho from the
// float32 Bessel routines; pivots by rsqrt; B, F and r rounded to float32 as
// they are stored.  The update's sums over the earlier panels run in
// another order than the shared-memory body's column order.
#pragma once

#include <cstddef>
#include <cstdint>

#include "vecchia_large_smem.cuh"

namespace vecchia {
namespace {

constexpr int kClusterPanel = 8;      // P: columns a panel
constexpr int kClusterThreads = 256;  // threads a block
constexpr int kClusterChunk = 128;    // rows of a warp's chunk of the update
constexpr int kClusterAheadChunk = 32;  // the same for the look-ahead panel's update
constexpr int kClusterStageBatch = 8;   // 16-byte loads a thread keeps in flight in a copy
constexpr int kClusterSlotSms = 256;    // SMs the hand-off buffer has slots for
constexpr int kClusterMaxPanels = 128;  // bound of the panel-offset table (mp / P <= 76)

// m rounded up to kClusterPanel: the system's slots
__host__ __device__ constexpr int cluster_mp(int m) {
  return (m + kClusterPanel - 1) / kClusterPanel * kClusterPanel;
}

// The block of a k-block cluster that holds panel p: snake order.
__host__ __device__ constexpr int cluster_owner(int p, int k) {
  return (p / k) % 2 == 0 ? p % k : k - 1 - p % k;
}

// The a-th panel of block `rank` (each round of k panels holds one of each
// block's), or a value >= mp / P past its last.
__host__ __device__ constexpr int cluster_own_panel(int a, int k, int rank) {
  return a * k + (a % 2 == 0 ? rank : k - 1 - rank);
}

// The staging buffer: panel j's rows from (j + 1) P on, at most that of panel 0.
__host__ __device__ constexpr int cluster_stage_words(int m) {
  return kClusterPanel * (cluster_mp(m) + 2 - kClusterPanel);
}

// Dynamic shared bytes a block of a k-block cluster takes: the panels of
// its largest share (P columns of rows - c0 words each) and the staging
// buffer (every block of a launch takes the same).
__host__ __device__ constexpr int cluster_block_bytes(int m, int k) {
  const int mp = cluster_mp(m);
  int words[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int p = 0; p < mp / kClusterPanel; ++p) {
    words[cluster_owner(p, k)] += kClusterPanel * (mp + 2 - p * kClusterPanel);
  }
  int most = 0;
  for (int r = 0; r < k; ++r) most = words[r] > most ? words[r] : most;
  return 8 * (most + cluster_stage_words(m));
}

// The smallest portable cluster size (2, 4, 8) whose blocks hold the system
// of m > kSmemM neighbors, or 0 where none does.
__host__ __device__ constexpr int cluster_blocks(int m) {
  for (int k = 2; k <= 8; k *= 2) {
    if (cluster_block_bytes(m, k) <= kMaxRingBytes) return k;
  }
  return 0;
}

// The largest m an 8-block cluster holds (ops/geometry.py M_CLUSTER
// computes the same).
constexpr int cluster_max_m() {
  int m = kSmemM;
  while (cluster_blocks(m + 1) != 0) ++m;
  return m;
}
constexpr int kClusterM = cluster_max_m();
static_assert(kClusterM == 608, "ops/geometry.py M_CLUSTER takes the same value");
static_assert(cluster_mp(kClusterM) / kClusterPanel <= kClusterMaxPanels, "panel table");

// The fewest bytes a block of this body takes, over every m it runs: more
// than half an SM's shared memory, so that an SM holds one block at a time
// (the hand-off buffer has slots by SM).
constexpr int cluster_least_block_bytes() {
  int least = kMaxRingBytes;
  for (int m = kSmemM + 1; m <= kClusterM; ++m) {
    const int b = cluster_block_bytes(m, cluster_blocks(m));
    least = b < least ? b : least;
  }
  return least;
}
static_assert(2 * cluster_least_block_bytes() > 233472, "one block of this body an SM");

// Whether a call of kernel 1 or 3 runs this body.
__host__ inline bool cluster_launch(int m) { return m > kSmemM && m <= kClusterM; }

// The wrapper's geometry: group is the cluster size, grid_x the clusters a
// chain (walking the sites in a stride of grid_x), smem_bytes a block's
// dynamic bytes, scratch the hand-off buffer: two slots of
// cluster_stage_words(m) words for each of kClusterSlotSms SMs (a block of
// this body fills more than half an SM's shared memory, so an SM holds one
// block, of one cluster, at a time; ops/geometry.py cluster_slot_bytes).
__host__ inline bool valid_cluster(int n_pad, int m, int chains, int group, int grid_x,
                                   int smem_bytes, const double* scratch) {
  return group == cluster_blocks(m) && grid_x >= 1 && grid_x <= n_pad &&
         static_cast<long long>(grid_x) * chains * group <= 0x7fffffffLL &&
         smem_bytes == cluster_block_bytes(m, group) && scratch != nullptr;
}

// ---- the cluster's hardware: rank, barrier, distributed shared memory -------

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return static_cast<int>(n);
}

// Split cluster barrier: every thread of every block arrives (releasing its
// writes, to shared and to device memory, at cluster scope), then waits for
// all (acquiring the others').
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The address of the same shared variable in block `rank` of the cluster
// (a generic address, read with ordinary loads).
template <class T>
__device__ __forceinline__ T* cluster_map(T* p, int rank) {
  std::uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;"
               : "=l"(out)
               : "l"(reinterpret_cast<std::uint64_t>(p)), "r"(rank));
  return reinterpret_cast<T*>(out);
}

// ---- one block's share of the system ----------------------------------------

struct ClusterShare {
  int rank, k;
  int mp, rows, np;    // slots, layout rows (mp + 2), panels
  double* own;         // this block's panels
  double* stage;       // the staging buffer
  const int* off;      // off[p]: word offset of panel p in its owner's panels
  double* slots;       // the hand-off buffer in device memory
  const int* sm_of;    // sm_of[r]: the SM of block rank r
  int slot_words;      // words of one slot: cluster_stage_words(m)
};

// The hand-off slot of panel j: the owner's SM's, of j's parity (the next
// panel of the same owner goes to the other one while this one is read).
__device__ __forceinline__ double* cluster_slot(const ClusterShare& s, int j) {
  return s.slots +
         static_cast<size_t>(2 * s.sm_of[cluster_owner(j, s.k)] + (j & 1)) * s.slot_words;
}

// Panel p of the block `s` holds, or of the block the pointer was mapped to:
// column c at pan + c * (rows - p P).
__device__ __forceinline__ double* cluster_panel(const ClusterShare& s, int p) {
  return s.own + s.off[p];
}

// The block's share, the panel-offset table in static shared memory and
// every block's SM (each block publishes its own, read through distributed
// shared memory).  Every thread of the block must call it.
__device__ __forceinline__ ClusterShare cluster_share(double* smem, int m, double* slots) {
  __shared__ int offsets[kClusterMaxPanels];
  __shared__ int my_sm;
  __shared__ int sm_of[8];
  ClusterShare s;
  s.rank = cluster_rank();
  s.k = cluster_size();
  s.mp = cluster_mp(m);
  s.rows = s.mp + 2;
  s.np = s.mp / kClusterPanel;
  s.own = smem;
  s.stage = smem + cluster_block_bytes(m, s.k) / 8 - cluster_stage_words(m);
  if (threadIdx.x == 0) {
    int next[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int p = 0; p < s.np; ++p) {
      const int o = cluster_owner(p, s.k);
      offsets[p] = next[o];
      next[o] += kClusterPanel * (s.rows - p * kClusterPanel);
    }
  }
  if (threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    my_sm = static_cast<int>(sm);
  }
  cluster_sync();  // every block's SM is published
  if (threadIdx.x < s.k) sm_of[threadIdx.x] = *cluster_map(&my_sm, threadIdx.x);
  __syncthreads();
  s.off = offsets;
  s.slots = slots;
  s.sm_of = sm_of;
  s.slot_words = cluster_stage_words(m);
  return s;
}

// Step 1: this block's panels of the bordered system of `site` (lim =
// min(gsite, m): slot k is real iff lim > k), column-major; the unused upper
// corner of each panel holds 0, rows mp + 1 hold y_N with WITH_Y and 0
// without.
template <bool GENERAL, bool COORDS, bool WITH_Y>
__device__ void cluster_fill(const ClusterShare& s, const ClosedForm64& cf,
                             const MaternSet* set, const GlobalDistances<COORDS>& dist,
                             const int* __restrict__ nn_idx, const float* __restrict__ y,
                             const float* __restrict__ v, double alpha, double jitter,
                             int n_pad, int site, int lim) {
  for (int a = 0, p = s.rank; p < s.np; p = cluster_own_panel(++a, s.k, s.rank)) {
    const int c0 = p * kClusterPanel;
    const int len = s.rows - c0;
    double* pan = cluster_panel(s, p);
    for (int e = threadIdx.x; e < kClusterPanel * len; e += blockDim.x) {
      const int c = e / len;
      const int i = c0 + e - c * len;
      const int k = c0 + c;
      double val = 0.0;
      if (i == k) {
        const bool real = lim > k;
        const double vk = real && v != nullptr
                              ? static_cast<double>(v[nn_idx[static_cast<size_t>(k) * n_pad + site]])
                              : 1.0;
        val = real ? 1.0 + (alpha * vk + jitter) : 1.0;
      } else if (i > k && i < s.mp) {
        if (lim > i) val = large_rho<GENERAL>(cf, dist.pair(i, k), set);  // mask_i mask_k
      } else if (i == s.mp) {
        if (lim > k) val = large_rho<GENERAL>(cf, dist.in(k), set);
      } else if (i == s.mp + 1) {
        if (WITH_Y && lim > k) val = y[nn_idx[static_cast<size_t>(k) * n_pad + site]];
      }
      pan[e] = val;
    }
  }
}

// Factor panel p of this block in place (every earlier panel's update
// applied): rows p P .. rows - 1 of its P columns; L below the diagonal,
// 1/L_kk on it.  Every thread loads the P x P corner's lower triangle
// (broadcast reads) and factors it in registers, the same steps in the same
// order as a row of the loop below; then each thread scales its rows.
// Every thread of the block must call it.
__device__ void cluster_factor_panel(const ClusterShare& s, int p) {
  constexpr int P = kClusterPanel;
  const int len = s.rows - p * P;
  double* pan = cluster_panel(s, p);
  double* slot = p + 1 < s.np ? cluster_slot(s, p) : nullptr;  // the last is not staged
  double corner[P][P];  // corner[r][c] = L[c0 + r][c0 + c], c < r, once factored
#pragma unroll
  for (int r = 0; r < P; ++r) {
#pragma unroll
    for (int c = 0; c <= r; ++c) corner[r][c] = pan[c * len + r];
  }
  __syncthreads();  // every thread holds the corner before any row is written
  double inv[P];
#pragma unroll
  for (int c = 0; c < P; ++c) {
    inv[c] = rsqrt(corner[c][c]);
#pragma unroll
    for (int r = c + 1; r < P; ++r) corner[r][c] *= inv[c];
#pragma unroll
    for (int r = c + 1; r < P; ++r) {
#pragma unroll
      for (int c2 = c + 1; c2 <= r; ++c2) corner[r][c2] -= corner[r][c] * corner[c2][c];
    }
  }
  double t[P];
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
#pragma unroll
    for (int c = 0; c < P; ++c) t[c] = pan[c * len + i];
#pragma unroll
    for (int c = 0; c < P; ++c) {
      t[c] *= inv[c];
#pragma unroll
      for (int c2 = c + 1; c2 < P; ++c2) t[c2] -= t[c] * corner[c2][c];
    }
#pragma unroll
    for (int c = 0; c < P; ++c) {
      if (i > c) {
        pan[c * len + i] = t[c];
      } else if (i == c) {
        pan[c * len + i] = inv[c];
      }
    }
    if (slot != nullptr && i >= P) {  // rows (p + 1) P on, the staged layout
#pragma unroll
      for (int c = 0; c < P; ++c) __stcg(slot + c * (len - P) + i - P, t[c]);
    }
  }
}

// Copy panel j's rows (j + 1) P .. rows - 1 into the staging buffer,
// column-major with columns of rows - (j + 1) P words, from the hand-off
// slot its owner wrote them to as it factored it: one 16-byte load from L2
// (ld.global.cg) each, kClusterStageBatch of a thread in flight.  Read from
// the owner's shared memory instead, every block's copy went through the
// owner's SM, and the copies of one panel took ~5 us (k = 8, m = 600;
// PERF.md).  Every thread of the block must call it; a __syncthreads must
// follow before the stage is read.
__device__ __forceinline__ void cluster_stage(const ClusterShare& s, int j) {
  constexpr int B = kClusterStageBatch;
  const int total = kClusterPanel * (s.rows - (j + 1) * kClusterPanel) / 2;  // 16-byte words
  const double2* src = reinterpret_cast<const double2*>(cluster_slot(s, j));
  double2* dst = reinterpret_cast<double2*>(s.stage);
  for (int e0 = threadIdx.x; e0 < total; e0 += B * blockDim.x) {
    double2 val[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int e = e0 + b * blockDim.x;
      if (e < total) val[b] = __ldcg(src + e);
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int e = e0 + b * blockDim.x;
      if (e < total) dst[e] = val[b];
    }
  }
}

// Subtract the staged panel j's rank-P product from the rows base ..
// base + 32 R - 1 of this block's panel q > j (a warp's chunk), R rows a
// lane (base + lane + 32 r) and P accumulators a row, with float64 FMAs.
template <int R>
__device__ __forceinline__ void cluster_update_fma(const ClusterShare& s, int j, int q,
                                                   int base) {
  constexpr int P = kClusterPanel;
  const int lane = threadIdx.x & 31;
  const int c0 = q * P;
  const int len = s.rows - c0;
  const int s0 = (j + 1) * P;  // the stage's first row
  const int slen = s.rows - s0;
  double* pan = cluster_panel(s, q);
  int il[R];  // rows of the panel, clamped into it
  double acc[R][P];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    il[r] = min(base + lane + 32 * r, len - 1);
#pragma unroll
    for (int c = 0; c < P; ++c) acc[r][c] = pan[c * len + il[r]];
  }
  const double* st = s.stage + (c0 - s0);  // st[p * slen + i']: row c0 + i' of column p
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const double* sp = st + p * slen;
    double mult[P];  // L[c0 + c][j P + p], the same for every lane
#pragma unroll
    for (int c = 0; c < P; c += 2) {
      const double2 two = *reinterpret_cast<const double2*>(sp + c);
      mult[c] = two.x;
      mult[c + 1] = two.y;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const double x = sp[il[r]];
#pragma unroll
      for (int c = 0; c < P; ++c) acc[r][c] = fma(-x, mult[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (base + lane + 32 * r < len) {
#pragma unroll
      for (int c = 0; c < P; ++c) pan[c * len + il[r]] = acc[r][c];
    }
  }
}

// The staged panel j's update of this block's panels q > j: of panel `only`
// alone where only >= 0, else of every one but `skip`.  Chunks of CHUNK rows
// are dealt to the warps in turn.
template <int CHUNK>
__device__ void cluster_update(const ClusterShare& s, int j, int only, int skip) {
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int item = 0;
  for (int a = 0, q = s.rank; q < s.np; q = cluster_own_panel(++a, s.k, s.rank)) {
    if (q <= j || q == skip || (only >= 0 && q != only)) continue;
    const int len = s.rows - q * kClusterPanel;
    for (int base = 0; base < len; base += CHUNK, ++item) {
      if (item % warps == warp) cluster_update_fma<CHUNK / 32>(s, j, q, base);
    }
  }
}

// Step 2: the cluster factors the system in place.  Every thread of every
// block must call it; it ends after a cluster barrier.
__device__ void cluster_factor(const ClusterShare& s) {
  if (cluster_owner(0, s.k) == s.rank) cluster_factor_panel(s, 0);
  cluster_sync();  // panel 0 is factored
  for (int j = 0; j + 1 < s.np; ++j) {
    cluster_stage(s, j);
    __syncthreads();
    const int next = j + 1;
    const bool mine = cluster_owner(next, s.k) == s.rank;
    if (mine) {  // look-ahead: the next panel first
      cluster_update<kClusterAheadChunk>(s, j, next, -1);
      __syncthreads();
      cluster_factor_panel(s, next);
    }
    cluster_arrive();  // panel j + 1 is factored (its owner's part)
    cluster_update<kClusterChunk>(s, j, -1, mine ? next : -1);
    __syncthreads();  // the stage is free
    cluster_wait();
  }
}

// The block's sum of x over its threads, in a fixed order (each warp's xor
// tree, then the warps in turn), in every thread.  Every thread of the block
// must call it.
__device__ __forceinline__ double cluster_block_total(double x) {
  __shared__ double warp_sums[kClusterThreads / 32];
  x = warp_total(x);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  double total = 0.0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += warp_sums[w];
  __syncthreads();  // warp_sums may be written again
  return total;
}

// u.u and (WITH_Y) u.w over this block's columns, written to red[0], red[1].
template <bool WITH_Y>
__device__ __forceinline__ void cluster_border_sums(const ClusterShare& s, double* red) {
  double uu = 0.0;
  double uw = 0.0;
  // this block's columns in a stride of the block's threads: column c of
  // its a-th panel is its column a P + c
  for (int idx = threadIdx.x;; idx += blockDim.x) {
    const int p = cluster_own_panel(idx / kClusterPanel, s.k, s.rank);
    if (p >= s.np) break;
    const int len = s.rows - p * kClusterPanel;
    const double* col =
        cluster_panel(s, p) + (idx % kClusterPanel) * len - p * kClusterPanel;  // col[i]: row i
    uu += col[s.mp] * col[s.mp];
    if constexpr (WITH_Y) uw += col[s.mp] * col[s.mp + 1];
  }
  uu = cluster_block_total(uu);
  if constexpr (WITH_Y) uw = cluster_block_total(uw);
  if (threadIdx.x == 0) {
    red[0] = uu;
    red[1] = uw;
  }
}

// The cluster's sum of red[v] in rank order (block rank 0, after a cluster
// barrier that follows every block's cluster_border_sums).
__device__ __forceinline__ double cluster_total(const ClusterShare& s, double* red, int v) {
  double total = 0.0;
  for (int r = 0; r < s.k; ++r) total += cluster_map(red, r)[v];
  return total;
}

// The (chain, first site) of this block's cluster and the stride of its
// sites: clusters are numbered chain-fastest along gridDim.x.
struct ClusterWalk {
  int chain, first, stride;
};

__device__ __forceinline__ ClusterWalk cluster_walk(const ClusterShare& s, int chains) {
  const int cl = blockIdx.x / s.k;
  return {cl % chains, cl / chains, static_cast<int>(gridDim.x) / s.k / chains};
}

// Kernel 1 for kSmemM < m <= kClusterM: F and r per (chain, site), one
// partial of sum log F and sum r^2/F per (cluster, chain) over the sites < n.
template <bool GENERAL, bool COORDS>
__global__ void __launch_bounds__(kClusterThreads, 1)
suffstats_cluster_kernel(const float* __restrict__ params, const float* __restrict__ tab_a,
                         const float* __restrict__ tab_b, const int* __restrict__ nn_idx,
                         const float* __restrict__ y_all, int y_stride,
                         const float* __restrict__ v, int n_pad, int m, int dim, int chains,
                         int family, double* __restrict__ slots, float* __restrict__ f_out,
                         float* __restrict__ r_out, float* __restrict__ part) {
  extern __shared__ __align__(16) double smem[];
  __shared__ double red[2];
  const ClusterShare s = cluster_share(smem, m, slots);
  const ClusterWalk walk = cluster_walk(s, chains);
  const float* pr = params + walk.chain * kParams;
  const MaternSet* set = chain_matern_set<GENERAL>(pr, false);
  const ClosedForm64 cf = GENERAL ? ClosedForm64{} : closed_form64(family, pr[0]);
  const double alpha = pr[1];
  const double jitter = pr[2];
  const int n = static_cast<int>(pr[3]);
  const int off = static_cast<int>(pr[5]);  // the shard's first site
  const float* y = y_all + static_cast<size_t>(walk.chain) * y_stride;
  double sum_logf = 0.0;
  double sum_q = 0.0;
  for (int site = walk.first; site < n_pad; site += walk.stride) {
    const int gsite = site + off;
    const GlobalDistances<COORDS> dist(tab_a, tab_b, dim, n_pad, site);
    cluster_fill<GENERAL, COORDS, true>(s, cf, set, dist, nn_idx, y, v, alpha, jitter, n_pad,
                                        site, min(gsite, m));
    __syncthreads();
    cluster_factor(s);
    cluster_border_sums<true>(s, red);
    cluster_sync();  // every block's sums are in
    if (s.rank == 0 && threadIdx.x == 0) {
      const double uu = cluster_total(s, red, 0);
      const double uw = cluster_total(s, red, 1);
      const double ff = 1.0 + (v != nullptr ? alpha * v[gsite] : alpha) - uu;
      const bool valid = gsite < n;
      const double resid = (valid ? y[gsite] : 0.0) - uw;
      f_out[static_cast<size_t>(walk.chain) * n_pad + site] = static_cast<float>(ff);
      r_out[static_cast<size_t>(walk.chain) * n_pad + site] = static_cast<float>(resid);
      sum_logf += valid ? log(ff) : 0.0;
      sum_q += valid ? resid * resid / ff : 0.0;
    }
    // red is written again only after the next system's first barrier, which
    // rank 0 passes after reading it
  }
  if (s.rank == 0 && threadIdx.x == 0) {
    const int g = walk.chain * walk.stride + walk.first;
    part[g] = static_cast<float>(sum_logf);
    part[chains * walk.stride + g] = static_cast<float>(sum_q);
  }
  cluster_sync();  // no block exits while rank 0 may read its shared memory
}

// Back-substitution step: panel p's P unknowns from the right-hand sides
// over its row mp + t (their later panels' terms already subtracted), in
// place, last first, by thread t < ROWS (kernel 3: row mp, B; kernel 2:
// rows mp and mp + 1, p and q, the corner's reads the same in both threads).
template <int ROWS = 1>
__device__ __forceinline__ void cluster_solve_panel(const ClusterShare& s, int p) {
  if (threadIdx.x >= ROWS) return;
  const int row = s.mp + threadIdx.x;
  const int c0 = p * kClusterPanel;
  const int len = s.rows - c0;
  const double* pan = cluster_panel(s, p);
  double x[kClusterPanel];
#pragma unroll
  for (int c = kClusterPanel - 1; c >= 0; --c) {
    const double* col = pan + c * len - c0;  // col[i]: row i of column c0 + c
    double b = col[row];
#pragma unroll
    for (int c2 = c + 1; c2 < kClusterPanel; ++c2) b -= col[c0 + c2] * x[c2];
    x[c] = b * col[c0 + c];  // times 1/L_kk
  }
#pragma unroll
  for (int c = 0; c < kClusterPanel; ++c) {
    cluster_panel(s, p)[c * len + row - c0] = x[c];
  }
}

// Subtract panel j's solved unknowns from the right-hand sides (rows mp ..
// mp + ROWS - 1) of this block's columns before panel j: those of panel
// `only` where only >= 0, else every one but panel `skip`'s; xs[t xs_stride
// + q] is the q-th of row mp + t.  A thread a column.
template <int ROWS = 1>
__device__ __forceinline__ void cluster_back_update(const ClusterShare& s, int j,
                                                    const double* xs, int only, int skip,
                                                    int xs_stride = 0) {
  const int r0 = j * kClusterPanel;
  for (int idx = threadIdx.x;; idx += blockDim.x) {
    const int p = cluster_own_panel(idx / kClusterPanel, s.k, s.rank);
    if (p >= j) break;
    if (p == skip || (only >= 0 && p != only)) continue;
    const int len = s.rows - p * kClusterPanel;
    double* col =
        cluster_panel(s, p) + (idx % kClusterPanel) * len - p * kClusterPanel;  // col[i]: row i
    double b[ROWS];
#pragma unroll
    for (int t = 0; t < ROWS; ++t) b[t] = col[s.mp + t];
#pragma unroll
    for (int q = 0; q < kClusterPanel; ++q) {
      const double l = col[r0 + q];
#pragma unroll
      for (int t = 0; t < ROWS; ++t) b[t] -= l * xs[t * xs_stride + q];
    }
#pragma unroll
    for (int t = 0; t < ROWS; ++t) col[s.mp + t] = b[t];
  }
}

// Kernel 3 for kSmemM < m <= kClusterM: B (C, m, n_pad) and F (C, n_pad);
// padded sites B = 0, F = 1.
template <bool GENERAL, bool COORDS>
__global__ void __launch_bounds__(kClusterThreads, 1)
bf_cluster_kernel(const float* __restrict__ params, const float* __restrict__ tab_a,
                  const float* __restrict__ tab_b, const int* __restrict__ nn_idx,
                  const float* __restrict__ v, int n_pad, int m, int dim, int chains,
                  int family, double* __restrict__ slots, float* __restrict__ b_out,
                  float* __restrict__ f_out) {
  extern __shared__ __align__(16) double smem[];
  __shared__ double red[2];
  __shared__ double xs[kClusterPanel];
  const ClusterShare s = cluster_share(smem, m, slots);
  const ClusterWalk walk = cluster_walk(s, chains);
  const float* pr = params + walk.chain * kParams;
  const MaternSet* set = chain_matern_set<GENERAL>(pr, false);
  const ClosedForm64 cf = GENERAL ? ClosedForm64{} : closed_form64(family, pr[0]);
  const double alpha = pr[1];
  const double jitter = pr[2];
  const int n = static_cast<int>(pr[3]);
  const int off = static_cast<int>(pr[5]);  // the shard's first site
  for (int site = walk.first; site < n_pad; site += walk.stride) {
    float* b_site = b_out + static_cast<size_t>(walk.chain) * m * n_pad + site;  // m planes
    const int gsite = site + off;
    if (gsite >= n) {  // the same for the whole cluster: no barrier
      for (int i = s.rank * kClusterThreads + threadIdx.x; i < m; i += s.k * kClusterThreads) {
        b_site[static_cast<size_t>(i) * n_pad] = 0.0f;
      }
      if (s.rank == 0 && threadIdx.x == 0) f_out[static_cast<size_t>(walk.chain) * n_pad + site] = 1.0f;
      continue;
    }
    const GlobalDistances<COORDS> dist(tab_a, tab_b, dim, n_pad, site);
    cluster_fill<GENERAL, COORDS, false>(s, cf, set, dist, nn_idx, nullptr, v, alpha, jitter,
                                         n_pad, site, min(gsite, m));
    __syncthreads();
    cluster_factor(s);
    cluster_border_sums<false>(s, red);  // u.u before the back-substitution overwrites u
    // B = L^-T u over row mp, panels last first
    const int last = s.np - 1;
    if (cluster_owner(last, s.k) == s.rank) cluster_solve_panel(s, last);
    cluster_sync();
    for (int j = last; j > 0; --j) {
      if (threadIdx.x < kClusterPanel) {
        const int len = s.rows - j * kClusterPanel;
        const double* pan = cluster_map(cluster_panel(s, j), cluster_owner(j, s.k));
        xs[threadIdx.x] = pan[threadIdx.x * len + s.mp - j * kClusterPanel];
      }
      __syncthreads();
      const bool mine = cluster_owner(j - 1, s.k) == s.rank;
      if (mine) {  // look-ahead: the next panel first
        cluster_back_update(s, j, xs, j - 1, -1);
        __syncthreads();
        cluster_solve_panel(s, j - 1);
      }
      cluster_arrive();  // panel j - 1 is solved (its owner's part)
      cluster_back_update(s, j, xs, -1, mine ? j - 1 : -1);
      __syncthreads();  // xs is free
      cluster_wait();
    }
    for (int idx = threadIdx.x;; idx += blockDim.x) {  // this block's B
      const int p = cluster_own_panel(idx / kClusterPanel, s.k, s.rank);
      const int i = p * kClusterPanel + idx % kClusterPanel;
      if (i >= m) break;  // the panels rise with idx
      const int len = s.rows - p * kClusterPanel;
      b_site[static_cast<size_t>(i) * n_pad] =
          static_cast<float>(cluster_panel(s, p)[(idx % kClusterPanel) * len + s.mp - p * kClusterPanel]);
    }
    if (s.rank == 0 && threadIdx.x == 0) {
      const double uu = cluster_total(s, red, 0);
      f_out[static_cast<size_t>(walk.chain) * n_pad + site] =
          static_cast<float>(1.0 + (v != nullptr ? alpha * v[gsite] : alpha) - uu);
    }
  }
  cluster_sync();  // no block exits while rank 0 may read its shared memory
}

// Launch `kern` on clusters of `group` blocks, grid_x clusters a chain:
// refused where the card has more SMs than the hand-off buffer has slots
// for; dynamic shared memory raised to smem_bytes, then refused unless the
// card can hold one such cluster at a time.  Returns the CUDA error.
template <class... Params, class... Args>
int cluster_launch_kernel(void (*kern)(Params...), int group, int grid_x, int chains,
                          int smem_bytes, cudaStream_t st, Args... args) {
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sms > kClusterSlotSms) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(group * grid_x * chains, 1, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = group;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kern), &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The launches (valid_cluster checked by the caller); return the CUDA error.
template <bool GENERAL, bool COORDS>
int launch_suffstats_cluster(const float* params, const float* tab_a, const float* tab_b,
                             const int* nn_idx, const float* y, int y_stride, const float* v,
                             int n_pad, int m, int dim, int chains, int family, int group,
                             int grid_x, int smem_bytes, double* slots, float* f_out,
                             float* r_out, float* part, cudaStream_t st) {
  return cluster_launch_kernel(suffstats_cluster_kernel<GENERAL, COORDS>, group, grid_x,
                               chains, smem_bytes, st, params, tab_a, tab_b, nn_idx, y,
                               y_stride, v, n_pad, m, dim, chains, family, slots, f_out, r_out,
                               part);
}

template <bool GENERAL, bool COORDS>
int launch_bf_cluster(const float* params, const float* tab_a, const float* tab_b,
                      const int* nn_idx, const float* v, int n_pad, int m, int dim, int chains,
                      int family, int group, int grid_x, int smem_bytes, double* slots,
                      float* b_out, float* f_out, cudaStream_t st) {
  return cluster_launch_kernel(bf_cluster_kernel<GENERAL, COORDS>, group, grid_x, chains,
                               smem_bytes, st, params, tab_a, tab_b, nn_idx, v, n_pad, m, dim,
                               chains, family, slots, b_out, f_out);
}

}  // namespace
}  // namespace vecchia
