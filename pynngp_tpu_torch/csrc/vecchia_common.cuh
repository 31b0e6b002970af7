// Shared device helpers of the fused Vecchia kernels (vecchia_suffstats_body.cuh,
// vecchia_grad_body.cuh, vecchia_bf_body.cuh): the correlation families and their
// phi-derivatives (counterparts of _rho_fn and _drho_fn in
// pynngp_tpu/ops/pallas_bf.py:312,656), the packed-triangle index, the
// distance accessors of the two table layouts (_dist_access, l.377), and the
// deterministic block reduction.
//
// Layout (pynngp_tpu_torch/ops/site_tables.py): plane-major tables of n_pad
// sites, n_pad a multiple of kBlock, in one of two layouts, a compile-time
// parameter COORDS of every body beside M:
//   dist   (COORDS = false): tab_a (m, n_pad) site -> neighbor distances,
//          tab_b (m(m-1)/2, n_pad) neighbor-pair distances by tri(i, k);
//   coords (COORDS = true, Euclidean only): tab_a (d, n_pad) the site's own
//          centred coordinates, tab_b (m d, n_pad) its neighbors', plane
//          k d + a for coordinate a of slot k; every distance is recomputed
//          as sqrt(sum_a (x_a - x'_a)^2), d a launch argument in [1, 3].
// Per-chain parameters as a (C, 6) float32
// array [phi, alpha, jitter, n, nu, off], mirroring _params_vec
// (pallas_bf.py:496).  nu is read by the general-nu Matern instances alone
// (GENERAL = true; vecchia_bessel.cuh); off is read by none and stays in the
// row for the site-sharded variants.
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

// d rho / d phi.  Zero at d = 0 for every family, so dC/dphi has no diagonal.
__device__ __forceinline__ float drho_dphi(int family, float d, float phi) {
  switch (family) {
    case kSqExp: {
      const float t = d / phi;
      return expf(-(t * t)) * 2.0f * d * d / (phi * phi * phi);
    }
    case kExponential:
      return expf(-d / phi) * d / (phi * phi);
    case kSpherical: {
      const float t = d / phi;
      return t < 1.0f ? 1.5f * t * (1.0f - t * t) / phi : 0.0f;
    }
    case kMatern12: {
      const float t = d / phi;
      return expf(-t) * t / phi;
    }
    case kMatern32: {
      const float t = 1.7320508075688772f * d / phi;
      return expf(-t) * t * t / phi;
    }
    default: {  // kMatern52
      const float t = 2.23606797749979f * d / phi;
      return expf(-t) * t * t * (1.0f + t) / (3.0f * phi);
    }
  }
}

constexpr int kMaxDim = 3;  // coordinate dimensions the coords layout takes

// The site's own coordinates (coords layout), loaded once per thread; the
// dist layout has none.  Unused entries (a >= dim) are 0.
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

// Coordinate a of neighbor slot k, read where it is used.  The load is a
// volatile asm statement so that the compiler neither merges the reads of one
// coordinate nor hoists them: merged, the m d neighbor coordinates would stay
// live in registers through the whole factorization, in bodies that already
// spill at m = 15 (the reference's note at pallas_bf.py:388-391 found the same
// on the TPU, where hoisting them blew its fast memory).  A re-read is an L1
// hit: a block's neighbor planes are m d * 512 bytes.
__device__ __forceinline__ float nbr_coord(const float* __restrict__ tab_b, int k, int a,
                                           int dim, int n_pad, int site) {
  const float* at = tab_b + static_cast<size_t>(k * dim + a) * n_pad + site;
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(at));
  return v;
}

// Distance from the site to its neighbor slot k.
template <bool COORDS>
__device__ __forceinline__ float dist_in(const float* __restrict__ tab_a,
                                         const float* __restrict__ tab_b,
                                         const OwnCoords<COORDS>& own, int k, int dim,
                                         int n_pad, int site) {
  if constexpr (COORDS) {
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < kMaxDim; ++a) {
      if (a < dim) {
        const float diff = own.x[a] - nbr_coord(tab_b, k, a, dim, n_pad, site);
        acc += diff * diff;
      }
    }
    return sqrtf(acc);
  } else {
    return tab_a[static_cast<size_t>(k) * n_pad + site];
  }
}

// Distance between neighbor slots i and k, i > k.
template <bool COORDS>
__device__ __forceinline__ float dist_pair(const float* __restrict__ tab_b, int i, int k,
                                           int dim, int n_pad, int site) {
  if constexpr (COORDS) {
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < kMaxDim; ++a) {
      if (a < dim) {
        const float diff = nbr_coord(tab_b, i, a, dim, n_pad, site) -
                           nbr_coord(tab_b, k, a, dim, n_pad, site);
        acc += diff * diff;
      }
    }
    return sqrtf(acc);
  } else {
    return tab_b[static_cast<size_t>(tri(i, k)) * n_pad + site];
  }
}

// Launch-shape checks shared by the three launchers.
template <bool COORDS>
__host__ inline bool valid_launch(int n_pad, int chains, int dim) {
  return n_pad > 0 && n_pad % kBlock == 0 && chains > 0 && chains <= 65535 &&
         (!COORDS || (dim >= 1 && dim <= kMaxDim));
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

// Sums each of vals[0..NV) over the block and writes the v-th sum to
// out[v * out_stride + out_index].  Warp shuffles, then one shared-memory
// pass over the warps: a fixed order, so the result is deterministic.
template <int NV>
__device__ __forceinline__ void block_sum_store(const float (&vals)[NV], float* out,
                                                int out_stride, int out_index) {
  __shared__ float partial[NV][kBlock / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    float s = vals[v];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) partial[v][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kBlock / 32; ++w) s += partial[threadIdx.x][w];
    out[threadIdx.x * out_stride + out_index] = s;
  }
}

}  // namespace vecchia
