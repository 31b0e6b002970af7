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
// contracts them with dC/dphi (from drho_dphi) and dC/dalpha (the masked
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
// What bounds it.  The same reads as kernel 1, about (m^2/2 + 2m) * 4 bytes
// per thread plus a second read of the pair distances for the dC contraction (L2-resident
// for the block), against ~m^3/6 + m^2 dependent FMAs: latency- and
// register-bound on the serial recurrence.  At m = 15 the factor alone is
// about 120 floats per thread (105 off-diagonal + 15 inverse diagonal), and
// p, q, u, w and dc add 75 more: in registers they spilled, so they live in
// local memory ("Loop structure", vecchia_common.cuh); ptxas -v reports the
// stack.  With noise weights a thread also gathers v at its neighbors twice
// (the diagonal, the alpha sums) and at itself: (2m + 1) * 4 bytes more.
// EMIT_Y adds (m + 1) * 4 bytes of stores per thread.  In the coords layout
// every pair distance is recomputed twice, in the factorization and in the
// contractions (d subtractions and multiply-adds and a sqrt each time, from
// coordinates read where they are used), in the place of two plane reads.
#pragma once

#include <cstddef>

#include "vecchia_common.cuh"

namespace vecchia {
namespace {

template <int M, bool EMIT_Y, bool GENERAL, bool COORDS, bool ANY_D = false>
__global__ void __launch_bounds__(kBlock)
grad_kernel(const float* __restrict__ params, const float* __restrict__ tab_a,
            const float* __restrict__ tab_b, const int* __restrict__ nn_idx,
            const float* __restrict__ y_all, int y_stride, const float* __restrict__ v,
            int n_pad, int m, int dim, int family, float* __restrict__ part,
            float* __restrict__ b_out, float* __restrict__ rof_out, bool with_nu) {
  // the loops over the slots run to M, unrolled; in the ANY_D instance to
  // the call's m, which keeps them rolled
  const int top = ANY_D ? m : M;
  const int chain = blockIdx.y;
  const int site = blockIdx.x * kBlock + threadIdx.x;
  const float* pr = params + chain * kParams;
  const float* y = y_all + static_cast<size_t>(chain) * y_stride;
  const float phi = pr[0];
  const float alpha = pr[1];
  const float jitter = pr[2];
  const int n = static_cast<int>(pr[3]);
  const MaternSet* set = chain_matern_set<GENERAL>(pr, with_nu);
  const OwnCoords<COORDS> own = load_own<COORDS>(tab_a, n_pad, site, dim);
  const Guard g(site, m);

  float low[tri(M, 0)];  // strict lower triangle of L, packed by tri(i, k)
  float inv_diag[M];
  float u[M];   // L^-1 c
  float w[M];   // L^-1 y_N
  float dc[M];  // dc/dphi (masked)
  [[maybe_unused]] float dcn[GENERAL ? M : 1];  // dc/dnu (masked), GENERAL only

#pragma unroll
  for (int k = 0; k < top; ++k) {
    // slot k is a real neighbor iff k < m and site > k (identity row
    // otherwise; one past m reads the last slot's planes, Guard)
    const float mk = g.mask(k);
    float nugget = alpha;
    float au = 0.0f;
    float aw = 0.0f;
    dc[k] = 0.0f;
    if constexpr (GENERAL) dcn[k] = 0.0f;
    if (k < m) {  // a branch, not a select: kernel 2 holds too many registers
      const int nb = nn_idx[static_cast<size_t>(k) * n_pad + site];
      nugget = slot_nugget(alpha, v, nb);
      const float dk = dist_in<COORDS, ANY_D>(tab_a, tab_b, own, g, k, dim, n_pad, site);
      if constexpr (GENERAL) {
        const float2 rd = rho_drho_general(dk, &set->at);
        dc[k] = rd.y * mk;
        dcn[k] = with_nu ? drho_dnu_general(dk, set) * mk : 0.0f;
        au = rd.x * mk;
      } else {
        dc[k] = drho_dphi(family, dk, phi) * mk;
        au = rho(family, dk, phi) * mk;
      }
      aw = y[nb] * mk;
    }
    float acc = 1.0f + mk * (nugget + jitter);
#pragma unroll
    for (int j = 0; j < k; ++j) acc -= low[tri(k, j)] * low[tri(k, j)];
    const float inv = 1.0f / sqrtf(acc);
    inv_diag[k] = inv;
#pragma unroll
    for (int j = 0; j < k; ++j) {
      au -= low[tri(k, j)] * u[j];
      aw -= low[tri(k, j)] * w[j];
    }
    u[k] = au * inv;
    w[k] = aw * inv;
#pragma unroll
    for (int i = k + 1; i < top; ++i) {
      const float mi = g.mask(i);  // mask_i * mask_k, as i > k
      float a = 0.0f;
      if (i < m) {
        a = corr<GENERAL>(family, dist_pair<COORDS, ANY_D>(tab_b, g, i, k, dim, n_pad, site),
                          phi, set) *
            mi;
      }
#pragma unroll
      for (int j = 0; j < k; ++j) a -= low[tri(i, j)] * low[tri(k, j)];
      low[tri(i, k)] = a * inv;
    }
  }

  const bool valid = site < n;
  float ff = 1.0f + own_nugget(alpha, v, site);
  float r = valid ? y[site] : 0.0f;
#pragma unroll
  for (int k = 0; k < top; ++k) {
    ff -= u[k] * u[k];
    r -= u[k] * w[k];
  }

  // back-substitution p = L^-T u, q = L^-T w (exactly zero on invalid
  // slots).  dC/dalpha is the masked identity, diag(v) at the neighbors with
  // v: pp = p' dC/dalpha p and pq = p' dC/dalpha q, v re-gathered where used
  float p[M];
  float q[M];
  float pp = 0.0f;
  float pq = 0.0f;
#pragma unroll
  for (int i = top - 1; i >= 0; --i) {
    float ap = u[i];
    float aq = w[i];
#pragma unroll
    for (int k = i + 1; k < top; ++k) {
      ap -= low[tri(k, i)] * p[k];
      aq -= low[tri(k, i)] * q[k];
    }
    p[i] = ap * inv_diag[i];
    q[i] = aq * inv_diag[i];
    if (v != nullptr) {  // p = 0 past the call's m: any in-bounds weight will do
      const float vi = v[nn_idx[static_cast<size_t>(g.at(i)) * n_pad + site]];
      pp += vi * p[i] * p[i];
      pq += vi * p[i] * q[i];
    } else {
      pp += p[i] * p[i];
      pq += p[i] * q[i];
    }
  }
  if constexpr (EMIT_Y) {
    float* b_site = b_out + static_cast<size_t>(chain) * m * n_pad + site;  // m planes
#pragma unroll
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
#pragma unroll
  for (int i = 0; i < top; ++i) {
    df_phi -= 2.0f * p[i] * dc[i];
    dr_phi -= dc[i] * q[i];
    if constexpr (GENERAL) {
      df_nu -= 2.0f * p[i] * dcn[i];
      dr_nu -= dcn[i] * q[i];
    }
  }
#pragma unroll
  for (int i = 0; i < top; ++i) {
#pragma unroll
    for (int j = i + 1; j < top; ++j) {
      if (j >= m) continue;
      const float mj = g.mask(j);  // mask_i * mask_j, as j > i
      if constexpr (GENERAL) {
        const float dij = dist_pair<COORDS, ANY_D>(tab_b, g, j, i, dim, n_pad, site);
        const float dcij = rho_drho_general(dij, &set->at).y * mj;
        df_phi += 2.0f * p[i] * p[j] * dcij;
        dr_phi += (p[i] * q[j] + p[j] * q[i]) * dcij;
        if (with_nu) {
          const float dcnij = drho_dnu_general(dij, set) * mj;
          df_nu += 2.0f * p[i] * p[j] * dcnij;
          dr_nu += (p[i] * q[j] + p[j] * q[i]) * dcnij;
        }
      } else {
        const float dcij =
            drho_dphi(family, dist_pair<COORDS, ANY_D>(tab_b, g, j, i, dim, n_pad, site), phi) *
            mj;
        df_phi += 2.0f * p[i] * p[j] * dcij;
        dr_phi += (p[i] * q[j] + p[j] * q[i]) * dcij;
      }
    }
  }
  const float df_a = (v != nullptr ? v[site] : 1.0f) + pp;
  const float dr_a = pq;

  const float inv_f = valid ? 1.0f / ff : 0.0f;
  const float r_over_f = r * inv_f;
  const float ratio2 = r_over_f * r_over_f;
  if constexpr (EMIT_Y) {
    rof_out[static_cast<size_t>(chain) * n_pad + site] = valid ? r_over_f : 0.0f;
  }
  // d(r^2/F) = 2 r dr / F - (r/F)^2 dF; r_over_f carries the validity mask
  if constexpr (GENERAL) {
    const float sums[8] = {
        valid ? logf(ff) : 0.0f,
        r * r_over_f,
        df_phi * inv_f,
        2.0f * r_over_f * dr_phi - ratio2 * df_phi,
        df_a * inv_f,
        2.0f * r_over_f * dr_a - ratio2 * df_a,
        df_nu * inv_f,
        2.0f * r_over_f * dr_nu - ratio2 * df_nu,
    };
    block_sum_store<8>(sums, part, gridDim.y * gridDim.x, chain * gridDim.x + blockIdx.x);
  } else {
    const float sums[6] = {
        valid ? logf(ff) : 0.0f,
        r * r_over_f,
        df_phi * inv_f,
        2.0f * r_over_f * dr_phi - ratio2 * df_phi,
        df_a * inv_f,
        2.0f * r_over_f * dr_a - ratio2 * df_a,
    };
    block_sum_store<6>(sums, part, gridDim.y * gridDim.x, chain * gridDim.x + blockIdx.x);
  }
}

// Validates the launch shape, picks the instance (M >= m, or the ANY_D one
// for coords with d > kMaxDim) and launches on `stream` without
// synchronising; returns cudaGetLastError().
template <bool EMIT_Y, bool GENERAL, bool COORDS>
int launch_grad(const float* params, const float* tab_a, const float* tab_b, const int* nn_idx,
                const float* y, int y_stride, const float* v, int n_pad, int m, int dim,
                int chains, int family, bool with_nu, float* part, float* b_out,
                float* rof_out, void* stream) {
  if (!valid_launch<COORDS>(n_pad, chains, dim) || y_stride < 0 || launch_m(m) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_pad / kBlock, chains);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VECCHIA_GRAD_LAUNCH(MM, ANY)                                                      \
  grad_kernel<MM, EMIT_Y, GENERAL, COORDS, ANY><<<grid, kBlock, 0, s>>>(                  \
      params, tab_a, tab_b, nn_idx, y, y_stride, v, n_pad, m, dim, family, part, b_out,   \
      rof_out, with_nu)
  if (COORDS && dim > kMaxDim) {
    VECCHIA_GRAD_LAUNCH(kAnyDimM, COORDS);
    return static_cast<int>(cudaGetLastError());
  }
  switch (launch_m(m)) {
    case 7: VECCHIA_GRAD_LAUNCH(7, false); break;
    case 10: VECCHIA_GRAD_LAUNCH(10, false); break;
    case 15: VECCHIA_GRAD_LAUNCH(15, false); break;
    case 20: VECCHIA_GRAD_LAUNCH(20, false); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VECCHIA_GRAD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace vecchia
