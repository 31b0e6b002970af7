// The site-tile ring of the three kernels (vecchia_suffstats_body.cuh,
// vecchia_grad_body.cuh, vecchia_bf_body.cuh) for m <= kRolledM: a block is
// a group of chains, one warp a chain, and its warps share one tile of kTile
// consecutive sites at a time.  The block copies the tile's tables (the
// distance or coordinate planes and nn_idx) into shared memory with
// cp.async, 16 bytes a copy, then gathers y (shared by the chains, or one row
// per warp; none for kernel 3) and the noise weights v at the tile's
// neighbors through the staged nn_idx with 4-byte cp.async copies.  The
// warps then read every distance, y_N and v_N of the factorization from
// shared memory.  The ring has two stages: the next tile's tables are in
// flight while the warps factor this one.  Each block walks the tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... (static: the sums' order is fixed) and, in
// kernels 1 and 2, keeps per-lane sums across them.
//
// A stage, in planes of kTile words (plane p of the tile's sites at
// [p * kTile, (p + 1) * kTile)):
//   dist:   [0, ml) d_in, then tri(ml, 0) pair planes by tri(i, k);
//   coords: [0, d) the sites' own coordinates, then ml d neighbor planes,
//           k d + a for coordinate a of slot k;
//   then ml nn_idx planes, ycopies x ml y_N planes (ycopies 1 for a shared
//   y, the group's chain count for one row a chain, 0 in kernel 3) and, with
//   noise weights, ml v_N planes.  A stage without y and v (kernel 3 under
//   homogeneous noise) holds no nn_idx planes: nothing is gathered.
// ml is the instance's M, or the call's m in the rolled instance.  The call's
// tables have m slots: only their planes are copied, and the ring is zeroed
// once, so a slot at or past m reads a zero distance, coordinate and y, and
// is masked as before (slot k is real iff min(gsite, m) > k, gsite the
// global site index: vecchia_common.cuh).
// pynngp_tpu_torch/ops/geometry.py computes the same plane count for the
// wrapper, which passes the bytes; the launcher refuses bytes that differ.
#pragma once

#include <cstddef>

#include "vecchia_common.cuh"

namespace vecchia {

constexpr int kTile = 32;     // sites of a tile: the lanes of a warp
constexpr int kMaxGroup = 4;  // chains (warps) of a block at most
constexpr int kStages = 2;    // tiles in the ring
// dynamic shared memory a block may take: the card's 232,448 bytes less the
// static MaternSet of each warp (GENERAL) and a margin
constexpr int kMaxRingBytes = 232448 - 2048;

struct TileShape {
  int rows_a;   // planes of the call's tab_a: m (dist) or d (coords)
  int rows_b;   // planes of the call's tab_b: m(m-1)/2 or m d
  int rows_nn;  // m
  int off_b;    // first plane of table b in the stage
  int off_nn;
  int off_y;
  int off_v;
  int planes;   // planes of one stage
};

// `gathers`: whether the stage holds nn_idx planes, for y or v; kernels 1
// and 2 always gather y (the default), kernel 3 only v.  A constant at every
// call: computed from a runtime ycopies inside kernels 1 and 2, it moved
// their register allocation (2-EMIT_Y coords at M = 15 from 128 to 168
// registers, 13% slower on the H100).
__host__ __device__ __forceinline__ TileShape tile_shape(int m, int ml, int dim, bool coords,
                                                         int ycopies, bool hetero,
                                                         bool gathers = true) {
  TileShape s;
  s.rows_a = coords ? dim : m;
  s.rows_b = coords ? m * dim : m * (m - 1) / 2;
  s.rows_nn = gathers ? m : 0;
  s.off_b = coords ? dim : ml;
  s.off_nn = s.off_b + (coords ? ml * dim : ml * (ml - 1) / 2);
  s.off_y = s.off_nn + (gathers ? ml : 0);
  s.off_v = s.off_y + ycopies * ml;
  s.planes = s.off_v + (hetero ? ml : 0);
  return s;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, global to shared, cached in L2 only (the tables are read once a
// group of chains)
__device__ __forceinline__ void cp_async16(float* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// 4 bytes, global to shared (the gathers of y and v: L1 may hold them)
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A shared-memory float read that the compiler neither merges with another
// read of the same address nor hoists: the coords layout's neighbor
// coordinates, which would otherwise stay live in registers through the
// factorization (m d of them).
__device__ __forceinline__ float lds_where_used(const float* at) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(smem_addr(at)));
  return v;
}

// sqrt(d2) as d2 rsqrt(d2), exactly 0 at d2 = 0: two instructions where the
// correctly rounded sqrtf takes a dozen, within 2 ulp.
__device__ __forceinline__ float tile_sqrt(float d2) { return d2 > 0.0f ? d2 * rsqrtf(d2) : 0.0f; }

// One lane's distances in a staged tile: from its site to slot k, and
// between slots i and k (i > k), read from the stage's distance planes or
// recomputed from its coordinate planes.  Up to kMaxDim coordinates the
// site's own are held in registers and the neighbors' re-read where used;
// the rolled instance (ROLLED) loops over any d.
template <bool COORDS, bool ROLLED>
struct TileDistances {
  const float* sa;  // d_in planes, or the sites' own coordinates
  const float* sb;  // pair planes, or the neighbors' coordinates
  int dim;
  float own[COORDS && !ROLLED ? kMaxDim : 1];

  __device__ __forceinline__ TileDistances(const float* st, const TileShape& s, int dim_)
      : sa(st + (threadIdx.x & 31)), sb(st + s.off_b * kTile + (threadIdx.x & 31)), dim(dim_) {
    if constexpr (COORDS && !ROLLED) {
#pragma unroll
      for (int a = 0; a < kMaxDim; ++a) own[a] = a < dim ? sa[a * kTile] : 0.0f;
    }
  }

  __device__ __forceinline__ float in(int k) const {
    if constexpr (!COORDS) {
      return sa[k * kTile];
    } else if constexpr (ROLLED) {
      float acc = 0.0f;
#pragma unroll 1
      for (int a = 0; a < dim; ++a) {
        const float diff = sa[a * kTile] - sb[(k * dim + a) * kTile];
        acc += diff * diff;
      }
      return tile_sqrt(acc);
    } else {
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < kMaxDim; ++a) {
        if (a < dim) {
          const float diff = own[a] - lds_where_used(sb + (k * dim + a) * kTile);
          acc += diff * diff;
        }
      }
      return tile_sqrt(acc);
    }
  }

  __device__ __forceinline__ float pair(int i, int k) const {
    if constexpr (!COORDS) {
      return sb[tri(i, k) * kTile];
    } else if constexpr (ROLLED) {
      float acc = 0.0f;
#pragma unroll 1
      for (int a = 0; a < dim; ++a) {
        const float diff = sb[(i * dim + a) * kTile] - sb[(k * dim + a) * kTile];
        acc += diff * diff;
      }
      return tile_sqrt(acc);
    } else {
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < kMaxDim; ++a) {
        if (a < dim) {
          const float diff = lds_where_used(sb + (i * dim + a) * kTile) -
                             lds_where_used(sb + (k * dim + a) * kTile);
          acc += diff * diff;
        }
      }
      return tile_sqrt(acc);
    }
  }
};

// Every thread of the block: start the copies of tile `tile`'s table and
// nn_idx planes into `stage` (not committed).
__device__ __forceinline__ void issue_tables(float* stage, const TileShape& s,
                                             const float* __restrict__ tab_a,
                                             const float* __restrict__ tab_b,
                                             const int* __restrict__ nn_idx, int n_pad,
                                             int tile) {
  const int total = (s.rows_a + s.rows_b + s.rows_nn) * (kTile / 4);
  const size_t col = static_cast<size_t>(tile) * kTile;
  for (int c = threadIdx.x; c < total; c += blockDim.x) {
    const int part = (c & (kTile / 4 - 1)) * 4;
    int row = c / (kTile / 4);
    const void* src;
    int plane;
    if (row < s.rows_a) {
      src = tab_a + static_cast<size_t>(row) * n_pad + col + part;
      plane = row;
    } else if ((row -= s.rows_a) < s.rows_b) {
      src = tab_b + static_cast<size_t>(row) * n_pad + col + part;
      plane = s.off_b + row;
    } else {
      row -= s.rows_b;
      src = nn_idx + static_cast<size_t>(row) * n_pad + col + part;
      plane = s.off_nn + row;
    }
    cp_async16(stage + plane * kTile + part, src);
  }
}

// Every thread of the block, once the stage's nn_idx planes are visible:
// start the gathers of y at the m neighbors (ycopies rows: chain c0 + c for
// c < ycopies with one y row a chain, y_stride = n; the shared y once with
// y_stride = 0) and of v with noise weights (not committed).  A ragged
// group's spare rows repeat its last chain.
__device__ __forceinline__ void issue_gathers(float* stage, const TileShape& s, int ml,
                                              const float* __restrict__ y_all, int y_stride,
                                              int ycopies, int c0, int chains,
                                              const float* __restrict__ v) {
  const int* snn = reinterpret_cast<const int*>(stage + s.off_nn * kTile);
  const int per = s.rows_nn * kTile;  // (slot, lane) pairs of one row
  for (int e = threadIdx.x; e < ycopies * per; e += blockDim.x) {
    const int c = e / per;
    const int r = e - c * per;
    const float* y = y_all + static_cast<size_t>(min(c0 + c, chains - 1)) * y_stride;
    cp_async4(stage + (s.off_y + c * ml) * kTile + r, y + snn[r]);
  }
  if (v != nullptr) {
    for (int e = threadIdx.x; e < per; e += blockDim.x) {
      cp_async4(stage + s.off_v * kTile + e, v + snn[e]);
    }
  }
}

// Sums each of vals[0..NV) over the warp and writes the v-th sum to
// out[v * out_stride + out_index] from lane 0: shuffles in a fixed order, so
// the result is deterministic.
template <int NV>
__device__ __forceinline__ void warp_sum_store(const float (&vals)[NV], float* out,
                                               int out_stride, int out_index) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    float s = vals[v];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if ((threadIdx.x & 31) == 0) out[v * out_stride + out_index] = s;
  }
}

// The warp's MaternSet from its chain's parameter row (GENERAL), or null:
// lane 0 builds it into shared memory, one set a warp.  Every lane of the
// warp must call it.
template <bool GENERAL>
__device__ __forceinline__ const MaternSet* warp_matern_set(const float* pr, bool with_nu) {
  if constexpr (GENERAL) {
    __shared__ MaternSet sets[kMaxGroup];
    MaternSet* set = &sets[threadIdx.x >> 5];
    if ((threadIdx.x & 31) == 0) make_matern_set(pr[0], pr[4], with_nu, set);
    __syncwarp();
    return set;
  } else {
    return nullptr;
  }
}

// rho and d rho / d phi of the closed-form families as one branch-free
// formula of t = min(scale d, t_max):
//   rho = (1 + c1 t + c2 t^2 + c3 t^3) exp(-(e1 t + e2 t^2)),
//   d rho / d phi = (d1 t + d2 t^2 + d3 t^3) exp(-(e1 t + e2 t^2)),
// the closed forms of the reference's _rho_fn and _drho_fn (pallas_bf.py:312,
// 656), with 1/phi taken once a chain instead of a division a correlation,
// and no branch on the family inside the unrolled factorization (a branch
// there splits the straight-line code that the scheduler interleaves).
struct ClosedForm {
  float scale, t_max, c1, c2, c3, e1, e2, d1, d2, d3;

  __device__ __forceinline__ float arg(float d) const { return fminf(scale * d, t_max); }
  __device__ __forceinline__ float decay(float t) const { return expf(-(t * (e1 + e2 * t))); }
  __device__ __forceinline__ float rho(float d) const {
    const float t = arg(d);
    return (1.0f + t * (c1 + t * (c2 + t * c3))) * decay(t);
  }
  __device__ __forceinline__ float drho(float d) const {
    const float t = arg(d);
    return t * (d1 + t * (d2 + t * d3)) * decay(t);
  }
  // (rho, d rho / d phi) on one exponential
  __device__ __forceinline__ float2 rho_drho(float d) const {
    const float t = arg(d);
    const float e = decay(t);
    return make_float2((1.0f + t * (c1 + t * (c2 + t * c3))) * e, t * (d1 + t * (d2 + t * d3)) * e);
  }
};

__device__ __forceinline__ ClosedForm closed_form(int family, float phi) {
  const float inv = 1.0f / phi;
  const float inf = __int_as_float(0x7f800000);
  switch (family) {
    case kSqExp:  // exp(-t^2); 2 t^2 / phi
      return {inv, inf, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 2.0f * inv, 0.0f};
    case kSpherical:  // 1 - 1.5 t + 0.5 t^3 up to t = 1; 1.5 t (1 - t^2) / phi
      return {inv, 1.0f, -1.5f, 0.0f, 0.5f, 0.0f, 0.0f, 1.5f * inv, 0.0f, -1.5f * inv};
    case kMatern32:  // (1 + t) exp(-t), t = sqrt(3) d / phi; t^2 exp(-t) / phi
      return {1.7320508075688772f * inv, inf, 1.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, inv, 0.0f};
    case kMatern52:  // (1 + t + t^2/3) exp(-t), t = sqrt(5) d / phi; t^2 (1 + t) exp(-t) / (3 phi)
      return {2.23606797749979f * inv, inf, 1.0f, 1.0f / 3.0f, 0.0f, 1.0f, 0.0f, 0.0f,
              inv / 3.0f, inv / 3.0f};
    default:  // kExponential, kMatern12: exp(-t); t exp(-t) / phi
      return {inv, inf, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, inv, 0.0f, 0.0f};
  }
}

// rho of either set of instances: the closed form, or the general-nu
// Matern through the warp's MaternSet.
template <bool GENERAL>
__device__ __forceinline__ float tile_rho(const ClosedForm& cf, float d, const MaternSet* set) {
  if constexpr (GENERAL) {
    return rho_general(d, &set->at);
  } else {
    return cf.rho(d);
  }
}

// The instance a call runs: the ring's slot count ml (M, or the call's m in
// the rolled instance), and whether the rolled instance (arrays for
// kRolledM, loops to m) runs: for 20 < m <= 32, or coords with d > kMaxDim.
__host__ __forceinline__ bool rolled_launch(int m, bool coords, int dim) {
  return launch_m(m) == kRolledM || (coords && dim > kMaxDim);
}

// Launch-shape checks of the tile kernels beside valid_launch: the group and
// grid the wrapper chose, and the ring bytes it computed for them.
__host__ inline bool valid_tiles(const TileShape& s, int group, int grid_x, int smem_bytes) {
  return group >= 1 && group <= kMaxGroup && grid_x >= 1 &&
         smem_bytes == kStages * s.planes * kTile * 4 && smem_bytes <= kMaxRingBytes;
}

// The same for the large-m instances (vecchia_large_m.cuh): one chain a
// block (group 1), no ring, grid_x blocks of kBlock sites along the sites
// at most, and a scratch buffer.
__host__ inline bool valid_large(int n_pad, int group, int grid_x, int smem_bytes,
                                 const double* scratch) {
  return group == 1 && smem_bytes == 0 && grid_x >= 1 && grid_x <= n_pad / kBlock &&
         scratch != nullptr;
}

}  // namespace vecchia
