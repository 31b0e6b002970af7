// The general-nu Matern correlation for the fused Vecchia kernels: float32
// e^x K_nu(x) in device code, and from it rho(d; phi, nu), d rho / d phi and
// d rho / d nu.  It computes what _matern_rho_general (pynngp_tpu/ops/
// pallas_bf.py:293), the general branch of _drho_fn (l.683) and _drho_nu_fn
// (l.704) compute, on pynngp_tpu/bessel.py's method: Temme's series for
// x <= 2, Steed's continued fraction CF2 for x > 2, nu split at the nearest
// integer (mu in [-1/2, 1/2]) and the upward recurrence.  The plain version is
// pynngp_tpu_torch/bessel.py with kernels.Matern.fused_correlation,
// dcorrelation_dphi and dcorrelation_dnu: the same floor of t (1e-8), the same
// difference step in nu (1e-2, lower point clamped to 1e-3).
//
// What differs from the TPU code, which evaluates both branches on every
// lane for fixed iteration counts.  A thread takes only the branch its x
// selects, leaves the series and the continued fraction when they have
// converged to float32, and runs the recurrence k - 1 times.  One evaluation
// yields K_nu and K_{nu-1} together (rho and d rho / d phi); below nu = 1/2
// it is the evaluation at order 1 - nu that does, as K_{1-nu} and K_{-nu} =
// K_nu.  Everything that depends
// on (phi, nu) alone, Temme's gamma factors among it, is computed once per
// block in double precision by one thread and read from shared memory
// (MaternSet).  The routines that hold the loops are __noinline__: the
// factorization bodies are unrolled over m + m(m-1)/2 correlations, and
// inlining a series at each would multiply their code and ptxas time.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace vecchia {

constexpr int kTemmeTerms = 40;  // at most; float32 converges in fewer than 15
constexpr int kCf2Steps = 64;    // at most; converges in 3 to 25
constexpr float kTFloor = 1e-8f;
constexpr float kNuStep = 1e-2f;
constexpr float kNuMin = 1e-3f;
constexpr float kBesselEps = FLT_EPSILON;

// What Temme's series needs of the order nu = mu + k alone.
struct BesselOrder {
  float mu;         // nu minus its nearest integer
  int k;            // the nearest integer
  float gam1;       // [1/Gamma(1-mu) - 1/Gamma(1+mu)] / (2 mu)
  float gam2;       // [1/Gamma(1-mu) + 1/Gamma(1+mu)] / 2
  float rgampl;     // 1/Gamma(1+mu)
  float rgammi;     // 1/Gamma(1-mu)
  float sin_ratio;  // pi mu / sin(pi mu)
};

// One smoothness of one chain.
struct MaternNu {
  float nu;
  float scale;     // sqrt(2 nu) / phi, so t = scale * d
  float log_norm;  // (1 - nu) log 2 - log Gamma(nu)
  float inv_phi;
  BesselOrder ord;    // order nu
  BesselOrder below;  // order 1 - nu, read only when ord.k == 0
};

// The chain's smoothness and the two ends of the central difference in nu.
struct MaternSet {
  MaternNu at;
  MaternNu hi;      // nu + h
  MaternNu lo;      // max(nu - h, 1e-3)
  float inv_width;  // 1 / (hi.nu - lo.nu)
};

// Runs once per block: double precision keeps the difference quotient gam1
// (which loses eps / (2 mu) in float32) and log Gamma exact to float32.
__device__ inline BesselOrder make_order(double nu) {
  nu = fabs(nu);  // K_{-nu} = K_nu
  const double kf = floor(nu + 0.5);
  const double mu = nu - kf;
  const double rgampl = exp(-lgamma(1.0 + mu));  // |mu| <= 1/2: argument >= 1/2
  const double rgammi = exp(-lgamma(1.0 - mu));
  const double mu2 = mu * mu;
  double gam1, gam2;
  if (fabs(mu) < 0.01) {  // Taylor series of 1/Gamma(1 + x), truncation < 1e-14
    gam1 = -(0.5772156649015329 + mu2 * (-0.0420026350340952 + mu2 * -0.0421977345555443));
    gam2 = 1.0 + mu2 * (-0.6558780715202538 + mu2 * 0.1665386113822915);
  } else {
    gam1 = (rgammi - rgampl) / (2.0 * mu);
    gam2 = 0.5 * (rgammi + rgampl);
  }
  const double pimu = 3.141592653589793 * mu;
  BesselOrder o;
  o.mu = static_cast<float>(mu);
  o.k = static_cast<int>(kf);
  o.gam1 = static_cast<float>(gam1);
  o.gam2 = static_cast<float>(gam2);
  o.rgampl = static_cast<float>(rgampl);
  o.rgammi = static_cast<float>(rgammi);
  o.sin_ratio = static_cast<float>(fabs(pimu) < 1e-6 ? 1.0 + pimu * pimu / 6.0 : pimu / sin(pimu));
  return o;
}

__device__ inline MaternNu make_matern(double phi, double nu) {
  MaternNu m;
  m.nu = static_cast<float>(nu);
  m.scale = static_cast<float>(sqrt(2.0 * nu) / phi);
  m.log_norm = static_cast<float>((1.0 - nu) * 0.6931471805599453 - lgamma(nu));
  m.inv_phi = static_cast<float>(1.0 / phi);
  m.ord = make_order(nu);
  m.below = make_order(1.0 - nu);
  return m;
}

// hi and lo are float32 sums of the float32 nu, as the plain version forms
// them from its nu, so that the two differences have the same width.
__device__ inline void make_matern_set(float phi, float nu, bool with_nu, MaternSet* set) {
  set->at = make_matern(phi, nu);
  if (with_nu) {
    const float hi = nu + kNuStep;
    const float lo = fmaxf(nu - kNuStep, kNuMin);
    set->hi = make_matern(phi, hi);
    set->lo = make_matern(phi, lo);
    set->inv_width = 1.0f / (hi - lo);
  }
}

// (e^x K_nu(x), e^x K_{nu-1}(x)) for the order o, x > 0; the second value is
// meaningful only when o.k >= 1.
static __device__ __noinline__ float2 kve_order(float x, const BesselOrder* o) {
  const float mu = o->mu;
  float km, kp;  // e^x K_mu, e^x K_{mu+1}
  if (x <= 2.0f) {
    // Temme's series
    x = fmaxf(x, FLT_MIN);
    const float d = -logf(0.5f * x);
    const float e = mu * d;
    const float ee = expf(e);
    const float e2 = e * e;
    // sinh(e)/e from its series where the quotient would cancel in float32
    const float sinh_ratio =
        fabsf(e) < 0.05f ? 1.0f + e2 / 6.0f + e2 * e2 / 120.0f : sinhf(e) / e;
    const float cosh_e = 0.5f * (ee + 1.0f / ee);
    float ff = o->sin_ratio * (o->gam1 * cosh_e + o->gam2 * sinh_ratio * d);
    float p = 0.5f * ee / o->rgampl;    // 0.5 e^{mu d} Gamma(1 + mu)
    float q = 0.5f / (ee * o->rgammi);  // 0.5 e^{-mu d} Gamma(1 - mu)
    float c = 1.0f;
    const float dd = 0.25f * x * x;
    const float mu2 = mu * mu;
    float ksum = ff;
    float ksum1 = p;
    for (int i = 1; i <= kTemmeTerms; ++i) {
      const float fi = static_cast<float>(i);
      ff = (fi * ff + p + q) / (fi * fi - mu2);
      c *= dd / fi;
      p /= fi - mu;
      q /= fi + mu;
      const float del = c * ff;
      const float del1 = c * (p - fi * ff);
      ksum += del;
      ksum1 += del1;
      if (fabsf(del) < kBesselEps * fabsf(ksum) && fabsf(del1) < kBesselEps * fabsf(ksum1)) break;
    }
    const float scale = expf(x);  // x <= 2: no overflow
    km = ksum * scale;
    kp = ksum1 * (2.0f / x) * scale;
  } else {
    // Steed's CF2.  Its auxiliary sequences q and c grow about 2^i once the
    // sum has converged and overflow float32: the loop must end there.
    float b = 2.0f * (1.0f + x);
    float d = 1.0f / b;
    float h = d;
    float delh = d;
    const float a1 = 0.25f - mu * mu;
    float q1 = 0.0f;
    float q2 = 1.0f;
    float a = -a1;
    float q = a1;
    float c = a1;
    float s = 1.0f + q * delh;
    for (int i = 2; i < kCf2Steps + 2; ++i) {
      const float fi = static_cast<float>(i);
      a -= 2.0f * (fi - 1.0f);
      c = -a * c / fi;
      const float qnew = (q1 - b * q2) / a;
      q1 = q2;
      q2 = qnew;
      q += c * qnew;
      b += 2.0f;
      d = 1.0f / (b + a * d);
      delh = (b * d - 1.0f) * delh;
      h += delh;
      const float dels = q * delh;
      s += dels;
      if (fabsf(dels) <= kBesselEps * fabsf(s)) break;  // s converges last
    }
    km = sqrtf(1.5707963267948966f / x) / s;  // e^x K_mu = sqrt(pi / 2x) / s
    kp = km * (mu + x + 0.5f - a1 * h) / x;
  }
  // upward recurrence: after j advances (km, kp) = (K_{mu+j}, K_{mu+j+1})
  for (int j = 1; j < o->k; ++j) {
    const float knext = km + (2.0f * (mu + static_cast<float>(j)) / x) * kp;
    km = kp;
    kp = knext;
  }
  return o->k == 0 ? make_float2(km, kp) : make_float2(kp, km);
}

// rho(d) = 2^(1-nu)/Gamma(nu) t^nu K_nu(t), t = sqrt(2 nu) d / phi, in log
// space; exactly 1 below the floor of t.  Far out e^-t underflows to 0.
static __device__ __noinline__ float rho_general(float d, const MaternNu* m) {
  const float t = m->scale * d;
  if (t < kTFloor) return 1.0f;
  const float kv = kve_order(t, &m->ord).x;
  return expf(m->log_norm + m->nu * logf(t) + logf(kv) - t);
}

// (rho, d rho / d phi), the derivative as
// 2^(1-nu)/Gamma(nu) t^(nu+1) K_{|nu-1|}(t) / phi; (1, 0) below the floor.
static __device__ __noinline__ float2 rho_drho_general(float d, const MaternNu* m) {
  const float t = m->scale * d;
  if (t < kTFloor) return make_float2(1.0f, 0.0f);
  float2 kk;
  if (m->ord.k == 0) {
    // nu < 1/2: the order 1 - nu splits as mu = -nu, k = 1, so its one
    // evaluation gives (K_{1-nu}, K_{-nu}), and K_{-nu} = K_nu
    const float2 b = kve_order(t, &m->below);
    kk = make_float2(b.y, b.x);
  } else {
    kk = kve_order(t, &m->ord);
  }
  const float log_t = logf(t);
  const float base = m->log_norm + m->nu * log_t - t;
  return make_float2(expf(base + logf(kk.x)), expf(base + log_t + logf(kk.y)) * m->inv_phi);
}

// d rho / d nu: the central difference of rho over [lo.nu, hi.nu].
__device__ __forceinline__ float drho_dnu_general(float d, const MaternSet* set) {
  return (rho_general(d, &set->hi) - rho_general(d, &set->lo)) * set->inv_width;
}

// The chain's MaternSet, built by the block's first thread into shared
// memory.  Every thread of the block must call it (it synchronises).
__device__ __forceinline__ const MaternSet* block_matern_set(float phi, float nu, bool with_nu) {
  __shared__ MaternSet set;
  if (threadIdx.x == 0) make_matern_set(phi, nu, with_nu, &set);
  __syncthreads();
  return &set;
}

}  // namespace vecchia
