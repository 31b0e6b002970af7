// Shared device helpers of the fused Vecchia kernels (vecchia_suffstats_body.cuh,
// vecchia_grad_body.cuh, vecchia_bf_body.cuh, vecchia_large_m.cuh): the
// packed-triangle index, the instance choice by m, and, as the large-m
// instances use them, the correlation families (counterpart of _rho_fn in
// pynngp_tpu/ops/pallas_bf.py:312) and the distance accessors of the two
// table layouts on global memory (_dist_access, l.377).  The tile instances
// read the distances from a shared-memory tile and take the closed forms
// with their phi-derivatives (_drho_fn, l.656) from vecchia_tile.cuh.
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
// kRolledM, loops to m); m > kRolledM the large-m instances (kernels 1 and 3
// up to kSmemM: vecchia_large_smem.cuh, kernel 2 up to kSmemGradM:
// vecchia_grad_smem.cuh, a warp a (site, chain) system in shared memory;
// above, up to kClusterM (kernel 2: kClusterGradM), a thread-block cluster a
// system: vecchia_large_cluster.cuh, vecchia_grad_cluster.cuh; above:
// vecchia_large_m.cuh, one thread a (site, chain), its state in a device
// scratch buffer; loops to m).  The tables of an m-call have m (or
// m(m-1)/2, or m d) planes, the leading planes of the M layout: tri(i, k)
// for i < m and k d + a for k < m do not depend on M.
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
// (GENERAL = true; vecchia_bessel.cuh).
//
// Shards.  off is the global index of a launch's first site: a launch over
// one shard of the sites (ops/site_tables.shard_site_tables; reference
// _site_idx, pallas_bf.py:357) takes that shard's tables, n_pad sites wide,
// and n, the global count.  Every body keeps two indices apart: `site`
// indexes the shard's tables, the tile ring and every output row (f, r, r/F,
// B); `gsite = site + off` decides the slot masks (min(gsite, m) > k), the
// validity (gsite < n) and every read of a vector held whole on each shard:
// the own y[gsite] and v[gsite].  Neighbor gathers go through the global
// nn_idx.  n and off ride in float32 and are exact below 2^24, which the
// wrappers check.  off = 0 is the unsharded launch.
//
// Loop structure.  The tile bodies unroll their loops over M and nvcc keeps
// the factor in registers, except kernel 2, whose loops nested in a slot
// loop stay rolled (its factor in local memory: faster there, PERF.md), and
// the rolled instance of each source, whose loops run to the call's m and
// whose arrays live in local memory.
//
// GENERAL is a template parameter of every body beside M.  The closed-form
// instances (GENERAL = false) take rho from ClosedForm (vecchia_tile.cuh);
// the general-nu instances ignore `family` and call the Bessel routines.
// The two sets live in separate translation units.
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

// The rolled instance: arrays for kRolledM slots, and loops that run to the
// call's m, which nvcc cannot unroll, so that it compiles in seconds.  It
// runs every launch with 20 < m <= kRolledM, and coords launches with
// d > kMaxDim.  State per (site, chain) grows as m^2 (the factor alone is
// m(m-1)/2 floats) and the tile ring as m(m+1)/2 planes, so a larger m runs
// a large-m instance, its state in shared memory or a device scratch buffer.
constexpr int kRolledM = 32;

// The site's own relative nugget: alpha, or alpha v[gsite] (global index).
__device__ __forceinline__ float own_nugget(float alpha, const float* __restrict__ v,
                                            int gsite) {
  return v != nullptr ? alpha * v[gsite] : alpha;
}

// The built instance M a call with m neighbors runs on: the smallest of
// 7, 10, 15, 20 at or above m, kRolledM (the rolled instance) for
// 20 < m <= kRolledM, m itself above kRolledM (the large-m instance, whose
// state is sized by m at run time), or 0 (refused) below 1.  The m = 20
// value-and-gradient instances already hold 255 registers, so larger m run
// rolled.
__host__ inline int launch_m(int m) {
  if (m < 1) return 0;
  if (m <= 7) return 7;
  if (m <= 10) return 10;
  if (m <= 15) return 15;
  if (m <= 20) return 20;
  if (m <= kRolledM) return kRolledM;
  return m;
}

// Whether a call runs the large-m instance (vecchia_large_m.cuh).
__host__ inline bool large_launch(int m) { return m > kRolledM; }

// Launch-shape checks shared by the three launchers.
template <bool COORDS>
__host__ inline bool valid_launch(int n_pad, int chains, int dim) {
  return n_pad > 0 && n_pad % kBlock == 0 && chains > 0 && chains <= 65535 &&
         (!COORDS || dim >= 1);
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
