// Shared device helpers of the fused Vecchia kernels (vecchia_suffstats_body.cuh,
// vecchia_grad_body.cuh, vecchia_bf_body.cuh): the packed-triangle index, the
// instance choice by m, and, as kernel 3 uses them, the correlation families
// (counterpart of _rho_fn in pynngp_tpu/ops/pallas_bf.py:312) and the
// distance accessors of the two table layouts on global memory
// (_dist_access, l.377).  Kernels 1 and 2 read the distances from a
// shared-memory tile and take the closed forms with their phi-derivatives
// (_drho_fn, l.656) from vecchia_tile.cuh.
//
// Layout (pynngp_tpu_torch/ops/site_tables.py): plane-major tables of n_pad
// sites, n_pad a multiple of kBlock, in one of two layouts, a compile-time
// parameter COORDS of every body beside M:
//   dist   (COORDS = false): tab_a (m, n_pad) site -> neighbor distances,
//          tab_b (m(m-1)/2, n_pad) neighbor-pair distances by tri(i, k);
//   coords (COORDS = true, Euclidean only): tab_a (d, n_pad) the site's own
//          centred coordinates, tab_b (m d, n_pad) its neighbors', plane
//          k d + a for coordinate a of slot k; every distance is recomputed
//          as sqrt(sum_a (x_a - x'_a)^2), d >= 1 a launch argument.
// m, the call's neighbor count, is a launch argument too: a call runs on the
// smallest built instance M >= m (launch_m) for m <= 20, and slots k >= m
// are identity rows; 20 < m <= kRolledM runs the rolled instance (arrays for
// kRolledM, loops to m).  The tables of an m-call have m (or m(m-1)/2, or
// m d) planes, the leading planes of the M layout: tri(i, k) for i < m and
// k d + a for k < m do not depend on M.
//
// Heterogeneous noise.  Every body takes `v`, the per-site noise weights in
// ordered site space padded to n_pad with 1 (the reference's _noise_planes,
// pallas_bf.py:510-518), or null for homogeneous noise; the branch on it is
// the same for every thread of a launch.  With v, the relative nugget of
// neighbor slot k is alpha v[nn_idx[k]] and the site's own alpha v[site]
// (reference vecchia.py:140-143).
// Per-chain parameters as a (C, 6) float32
// array [phi, alpha, jitter, n, nu, off], mirroring _params_vec
// (pallas_bf.py:496).  nu is read by the general-nu Matern instances alone
// (GENERAL = true; vecchia_bessel.cuh); off is read by none and stays in the
// row for the site-sharded variants.
//
// Loop structure.  The bodies unroll their loops over M and nvcc keeps the
// factor in registers, except kernel 2, whose loops nested in a slot loop
// stay rolled (its factor in local memory: faster there, PERF.md), and
// the rolled instance of each source, whose loops run to the call's m and
// whose arrays live in local memory.
//
// GENERAL is a template parameter of every body beside M.  The closed-form
// instances (GENERAL = false) take rho and d rho / d phi from the switch
// below on the runtime `family`; the general-nu instances ignore `family`
// and call the Bessel routines.  The two sets live in separate translation
// units, so the closed-form instances compile as they did without them.
#pragma once

#include <cuda_runtime.h>

#include "vecchia_bessel.cuh"

namespace vecchia {

constexpr int kBlock = 128;  // threads per block along sites (site_tables.BLOCK)
constexpr int kParams = 6;   // floats per chain in the params array

enum Family : int {
  kSqExp = 0,
  kExponential = 1,
  kSpherical = 2,
  kMatern12 = 3,
  kMatern32 = 4,
  kMatern52 = 5,
  kMaternGeneral = 6,  // any nu through K_nu: the GENERAL instances
};

// Packed strict-lower-triangle index of the (i, k), i > k neighbor pair
// (pallas_bf.py:87); the same order as the d_tri planes.
__host__ __device__ constexpr int tri(int i, int k) { return i * (i - 1) / 2 + k; }

// rho(d; phi).  `family` is the same for every thread of a launch, so the
// switch never diverges inside a warp.
__device__ __forceinline__ float rho(int family, float d, float phi) {
  switch (family) {
    case kSqExp: {
      const float t = d / phi;
      return expf(-(t * t));
    }
    case kExponential:
      return expf(-d / phi);
    case kSpherical: {
      const float t = fminf(d / phi, 1.0f);
      return 1.0f - 1.5f * t + 0.5f * t * t * t;
    }
    case kMatern12:
      return expf(-(d / phi));
    case kMatern32: {
      const float t = 1.7320508075688772f * d / phi;
      return (1.0f + t) * expf(-t);
    }
    default: {  // kMatern52
      const float t = 2.23606797749979f * d / phi;
      return (1.0f + t + t * t / 3.0f) * expf(-t);
    }
  }
}

// Coordinate dimensions held in registers for the site's own coordinates in
// the coords layout; up to kMaxDim coordinates the accessors below are
// straight-line code.  A launch with d > kMaxDim runs the rolled instance
// (ROLLED, one a source: see kRolledM), which reads every coordinate from the
// fourth on where it uses it, in a loop, and keeps every loop rolled.
// Holding more coordinates would cost every coords instance registers, and a
// loop in the common instances cost them 12-15% of their time (measured on
// the H100: every distance became a branch in a body that is otherwise one
// straight-line block).
constexpr int kMaxDim = 3;

// The rolled instance: arrays for the largest m the kernels take, and loops
// that run to the call's m, which nvcc cannot unroll, so that it compiles in
// seconds.  It runs every launch with 20 < m <= kRolledM, and coords launches
// with d > kMaxDim.  State per (site, chain) grows as m^2 (the factor alone
// is m(m-1)/2 floats), so no larger m is taken.
constexpr int kRolledM = 32;

// The site's own first kMaxDim coordinates (coords layout), loaded once per
// thread; the dist layout has none.  Unused entries (a >= dim) are 0.
template <bool COORDS>
struct OwnCoords {
  float x[COORDS ? kMaxDim : 1];
};

template <bool COORDS>
__device__ __forceinline__ OwnCoords<COORDS> load_own(const float* __restrict__ tab_a,
                                                      int n_pad, int site, int dim) {
  OwnCoords<COORDS> own{};
  if constexpr (COORDS) {
#pragma unroll
    for (int a = 0; a < kMaxDim; ++a) {
      if (a < dim) own.x[a] = tab_a[static_cast<size_t>(a) * n_pad + site];
    }
  }
  return own;
}

// A float32 load that the compiler neither merges with another read of the
// same address nor hoists: a volatile asm statement.
__device__ __forceinline__ float load_where_used(const float* at) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(at));
  return v;
}

// Coordinate a of neighbor slot k, read where it is used.  Merged, the m d
// neighbor coordinates would stay live in registers through the whole
// factorization, in bodies that already spill at m = 15 (the reference's
// note at pallas_bf.py:388-391 found the same on the TPU, where hoisting them
// blew its fast memory).  A re-read is an L1 hit: a block's neighbor planes
// are m d * 512 bytes.
__device__ __forceinline__ float nbr_coord(const float* __restrict__ tab_b, int k, int a,
                                           int dim, int n_pad, int site) {
  return load_where_used(tab_b + static_cast<size_t>(k * dim + a) * n_pad + site);
}

// The m guard.  A call with m < M neighbors runs the M instance; its tables
// have only m planes (m(m-1)/2 pair planes, m d coordinate planes), so a slot
// or pair at or past m reads slot 0's planes instead (a select on the index:
// no branch around the load, which cost kernels 1 and 3 6-10%) and is masked
// by the caller: slot k is a real neighbor iff min(site, m) > k.  Exact calls
// (m = M) run the same code with one select an index.  Kernel 2, whose
// registers a select on every load pushed past 255, branches around the
// loads instead.
struct Guard {
  int lim;  // min(site, m): slot k is valid iff lim > k
  int m;
  __device__ __forceinline__ Guard(int site, int m_) : lim(min(site, m_)), m(m_) {}
  __device__ __forceinline__ float mask(int k) const { return lim > k ? 1.0f : 0.0f; }
  __device__ __forceinline__ int at(int k) const { return k < m ? k : 0; }
};

// Distance from the site to its neighbor slot k.
template <bool COORDS, bool ROLLED>
__device__ __forceinline__ float dist_in(const float* __restrict__ tab_a,
                                         const float* __restrict__ tab_b,
                                         const OwnCoords<COORDS>& own, const Guard& g, int k,
                                         int dim, int n_pad, int site) {
  k = g.at(k);
  if constexpr (COORDS) {
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < kMaxDim; ++a) {
      if (a < dim) {
        const float diff = own.x[a] - nbr_coord(tab_b, k, a, dim, n_pad, site);
        acc += diff * diff;
      }
    }
    if constexpr (ROLLED) {
#pragma unroll 1
      for (int a = kMaxDim; a < dim; ++a) {
        const float diff = load_where_used(tab_a + static_cast<size_t>(a) * n_pad + site) -
                           nbr_coord(tab_b, k, a, dim, n_pad, site);
        acc += diff * diff;
      }
    }
    return sqrtf(acc);
  } else {
    return tab_a[static_cast<size_t>(k) * n_pad + site];
  }
}

// Distance between neighbor slots i and k, i > k.
template <bool COORDS, bool ROLLED>
__device__ __forceinline__ float dist_pair(const float* __restrict__ tab_b, const Guard& g,
                                           int i, int k, int dim, int n_pad, int site) {
  if constexpr (COORDS) {
    i = g.at(i);
    k = g.at(k);
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < kMaxDim; ++a) {
      if (a < dim) {
        const float diff = nbr_coord(tab_b, i, a, dim, n_pad, site) -
                           nbr_coord(tab_b, k, a, dim, n_pad, site);
        acc += diff * diff;
      }
    }
    if constexpr (ROLLED) {
#pragma unroll 1
      for (int a = kMaxDim; a < dim; ++a) {
        const float diff = nbr_coord(tab_b, i, a, dim, n_pad, site) -
                           nbr_coord(tab_b, k, a, dim, n_pad, site);
        acc += diff * diff;
      }
    }
    return sqrtf(acc);
  } else {
    return tab_b[static_cast<size_t>(i < g.m ? tri(i, k) : 0) * n_pad + site];
  }
}

// The site's own relative nugget: alpha, or alpha v[site].
__device__ __forceinline__ float own_nugget(float alpha, const float* __restrict__ v,
                                            int site) {
  return v != nullptr ? alpha * v[site] : alpha;
}

// The built instance M a call with m neighbors runs on: the smallest of
// 7, 10, 15, 20 at or above m, kRolledM (the rolled instance) for
// 20 < m <= kRolledM, or 0 (refused) above kRolledM or below 1.  The m = 20
// value-and-gradient instances already hold 255 registers, so larger m run
// rolled.
__host__ inline int launch_m(int m) {
  if (m < 1) return 0;
  if (m <= 7) return 7;
  if (m <= 10) return 10;
  if (m <= 15) return 15;
  if (m <= 20) return 20;
  if (m <= kRolledM) return kRolledM;
  return 0;
}

// Launch-shape checks shared by the three launchers.
template <bool COORDS>
__host__ inline bool valid_launch(int n_pad, int chains, int dim) {
  return n_pad > 0 && n_pad % kBlock == 0 && chains > 0 && chains <= 65535 &&
         (!COORDS || dim >= 1);
}

// rho of either set of instances.  `set` is the block's MaternSet (GENERAL)
// or null.
template <bool GENERAL>
__device__ __forceinline__ float corr(int family, float d, float phi, const MaternSet* set) {
  if constexpr (GENERAL) {
    return rho_general(d, &set->at);
  } else {
    return rho(family, d, phi);
  }
}

// The block's MaternSet from the chain's parameter row (GENERAL), or null.
// Every thread of the block must call it.
template <bool GENERAL>
__device__ __forceinline__ const MaternSet* chain_matern_set(const float* pr, bool with_nu) {
  if constexpr (GENERAL) {
    return block_matern_set(pr[0], pr[4], with_nu);
  } else {
    return nullptr;
  }
}

}  // namespace vecchia
