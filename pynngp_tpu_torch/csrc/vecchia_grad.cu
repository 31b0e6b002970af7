// Kernel 2: fused Vecchia value + gradient pass.
//
// Replaces the Pallas kernel _grad_kernel (pynngp_tpu/ops/pallas_bf.py:727,
// driven by _run_grad l.867) for closed-form kernels, without sampled nu and
// without the emit_y outputs.  For every (site, chain) it makes the same
// factorization as kernel 1, back-substitutes p = L^-T u and q = L^-T v
// (p = C^-1 c, q = C^-1 y_N), and contracts them with dC/dphi (from
// drho_dphi) and dC/dalpha (the masked identity):
//   dF/dphi = -2 p.dc + p' dC p,   dr/dphi = -dc.q + p' dC q,
//   dF/dalpha = 1 + p.p,           dr/dalpha = p.q.
// It writes, per (block, chain), partials of logdet, quad, dlogdet/dphi,
// dquad/dphi, dlogdet/dalpha and dquad/dalpha over the sites < n; the
// wrapper (ops/diff_suffstats.py) sums them in float64.  One pass over the
// tables gives the value and the gradient.
//
// What bounds it.  The same reads as kernel 1, about (m^2/2 + 2m) * 4 bytes
// per thread plus a second read of d_tri for the dC contraction (L2-resident
// for the block), against ~m^3/6 + m^2 dependent FMAs: latency- and
// register-bound on the serial recurrence.  At m = 15 the factor alone is
// about 120 live floats per thread (105 off-diagonal + 15 inverse diagonal),
// and p, q, u, v and dc add 75 more, so expect spills; ptxas -v reports them.
#include <cstddef>

#include "vecchia_common.cuh"

namespace vecchia {
namespace {

template <int M>
__global__ void __launch_bounds__(kBlock)
grad_kernel(const float* __restrict__ params, const float* __restrict__ d_in,
            const float* __restrict__ d_tri, const int* __restrict__ nn_idx,
            const float* __restrict__ y, int n_pad, int family, float* __restrict__ part) {
  const int chain = blockIdx.y;
  const int site = blockIdx.x * kBlock + threadIdx.x;
  const float* pr = params + chain * kParams;
  const float phi = pr[0];
  const float alpha = pr[1];
  const float jitter = pr[2];
  const int n = static_cast<int>(pr[3]);

  float low[tri(M, 0)];  // strict lower triangle of L, packed by tri(i, k)
  float inv_diag[M];
  float u[M];   // L^-1 c
  float v[M];   // L^-1 y_N
  float dc[M];  // dc/dphi (masked)

#pragma unroll
  for (int k = 0; k < M; ++k) {
    const float mk = site > k ? 1.0f : 0.0f;
    float acc = 1.0f + mk * (alpha + jitter);
#pragma unroll
    for (int j = 0; j < k; ++j) acc -= low[tri(k, j)] * low[tri(k, j)];
    const float inv = 1.0f / sqrtf(acc);
    inv_diag[k] = inv;
    const size_t at = static_cast<size_t>(k) * n_pad + site;
    const float dk = d_in[at];
    dc[k] = drho_dphi(family, dk, phi) * mk;
    float au = rho(family, dk, phi) * mk;
    float av = y[nn_idx[at]] * mk;
#pragma unroll
    for (int j = 0; j < k; ++j) {
      au -= low[tri(k, j)] * u[j];
      av -= low[tri(k, j)] * v[j];
    }
    u[k] = au * inv;
    v[k] = av * inv;
#pragma unroll
    for (int i = k + 1; i < M; ++i) {
      const float mi = site > i ? 1.0f : 0.0f;  // mask_i * mask_k, as i > k
      float a = rho(family, d_tri[static_cast<size_t>(tri(i, k)) * n_pad + site], phi) * mi;
#pragma unroll
      for (int j = 0; j < k; ++j) a -= low[tri(i, j)] * low[tri(k, j)];
      low[tri(i, k)] = a * inv;
    }
  }

  const bool valid = site < n;
  float ff = 1.0f + alpha;
  float r = valid ? y[site] : 0.0f;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    ff -= u[k] * u[k];
    r -= u[k] * v[k];
  }

  // back-substitution p = L^-T u, q = L^-T v (zero on invalid slots)
  float p[M];
  float q[M];
  float pp = 0.0f;
  float pq = 0.0f;
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    float ap = u[i];
    float aq = v[i];
#pragma unroll
    for (int k = i + 1; k < M; ++k) {
      ap -= low[tri(k, i)] * p[k];
      aq -= low[tri(k, i)] * q[k];
    }
    p[i] = ap * inv_diag[i];
    q[i] = aq * inv_diag[i];
    pp += p[i] * p[i];
    pq += p[i] * q[i];
  }

  // contractions with dC/dphi (diagonal-free: drho(0) = 0)
  float df_phi = 0.0f;
  float dr_phi = 0.0f;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    df_phi -= 2.0f * p[i] * dc[i];
    dr_phi -= dc[i] * q[i];
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = i + 1; j < M; ++j) {
      const float mj = site > j ? 1.0f : 0.0f;  // mask_i * mask_j, as j > i
      const float dcij =
          drho_dphi(family, d_tri[static_cast<size_t>(tri(j, i)) * n_pad + site], phi) * mj;
      df_phi += 2.0f * p[i] * p[j] * dcij;
      dr_phi += (p[i] * q[j] + p[j] * q[i]) * dcij;
    }
  }
  const float df_a = 1.0f + pp;
  const float dr_a = pq;

  const float inv_f = valid ? 1.0f / ff : 0.0f;
  const float r_over_f = r * inv_f;
  const float ratio2 = r_over_f * r_over_f;
  // d(r^2/F) = 2 r dr / F - (r/F)^2 dF; r_over_f carries the validity mask
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

template <int M>
void launch(dim3 grid, cudaStream_t stream, const float* params, const float* d_in,
            const float* d_tri, const int* nn_idx, const float* y, int n_pad, int family,
            float* part) {
  grad_kernel<M><<<grid, kBlock, 0, stream>>>(params, d_in, d_tri, nn_idx, y, n_pad, family,
                                              part);
}

}  // namespace
}  // namespace vecchia

// C interface, bound with ctypes by pynngp_tpu_torch/ops/_build.py.
//   params (C, 6); d_in (m, n_pad); d_tri (m(m-1)/2, n_pad); nn_idx (m, n_pad)
//   int32; y (n,); part (6, C, n_pad / 128) in the order logdet, quad,
//   dlogdet/dphi, dquad/dphi, dlogdet/dalpha, dquad/dalpha.
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int vecchia_grad_f32(const float* params, const float* d_in, const float* d_tri,
                                const int* nn_idx, const float* y, int n_pad, int m,
                                int chains, int family, float* part, void* stream) {
  using namespace vecchia;
  if (n_pad <= 0 || n_pad % kBlock != 0 || chains <= 0 || chains > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_pad / kBlock, chains);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 7: launch<7>(grid, s, params, d_in, d_tri, nn_idx, y, n_pad, family, part); break;
    case 10: launch<10>(grid, s, params, d_in, d_tri, nn_idx, y, n_pad, family, part); break;
    case 15: launch<15>(grid, s, params, d_in, d_tri, nn_idx, y, n_pad, family, part); break;
    case 20: launch<20>(grid, s, params, d_in, d_tri, nn_idx, y, n_pad, family, part); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
