"""Modified Bessel function of the second kind K_nu in plain PyTorch
(counterpart of ``pynngp_tpu.bessel``): ``kve``, ``kv`` and ``log_kve`` on
tensors of any shape and device, float32 or float64, real nu, x > 0.

``torch.special`` offers only K_0 and K_1; the general-nu Matern kernel needs
K_nu for any smoothness.  The evaluation:

- x <= 2: Temme's series for K_mu, K_{mu+1} (40 terms at most; it ends once
  every element's terms are below a quarter of its rounding);
- x > 2: Steed's continued fraction CF2 for e^x K_mu, K_{mu+1}, each element
  frozen once it has converged (the auxiliary sequences keep growing about
  2^i and overflow float32 when iterated past convergence);
- nu = mu + k splits at the NEAREST integer, mu in [-1/2, 1/2]: as mu -> 1
  the series' sin(pi mu) prefactor blows up and float32 cancels;
- the forward recurrence K_{nu+1} = K_{nu-1} + (2 nu / x) K_nu, stable
  upwards, run k - 1 times.

Each branch is evaluated on the elements whose x selects it (the reference
evaluates both on every element and selects; the CUDA kernels,
``csrc/vecchia_bessel.cuh``, branch per thread).  This module is their plain
version and the oracle of the CPU tests.

Float32 safeguards (about float32, not about any device): 1/Gamma(1 +- mu)
differences from their Taylor series for |mu| < 0.01, sinh(e)/e from its
series for |e| < 0.05, pi mu / sin(pi mu) from its series for |pi mu| < 1e-6.

Derivatives: ``kve`` is a ``torch.autograd.Function``; d/dx is exact through
K_{nu+1}, d/dnu is a central difference with h = 1e-4 (a documented
approximation: only gradient-based moves on nu use it).
"""

from __future__ import annotations

import math

import torch

__all__ = ["kv", "kve", "log_kve", "series_terms"]

_TEMME_ITERS = 40  # series terms for x <= 2 (float64-clean at x = 2)
_CF2_ITERS = 64  # continued-fraction steps for x > 2 at most
_MAX_RECUR = 32  # bounds supported nu at _MAX_RECUR + 0.5

# Taylor coefficients of 1/Gamma(1+x) = 1 + b1 x + b2 x^2 + ...: gam1 =
# [f(-mu) - f(mu)] / (2 mu) = -(b1 + b3 mu^2 + b5 mu^4) and gam2 =
# [f(-mu) + f(mu)] / 2 = 1 + b2 mu^2 + b4 mu^4.
_INVGAMMA_B = (0.5772156649015329, -0.6558780715202538, -0.0420026350340952,
               0.1665386113822915, -0.0421977345555443)


def _temme_gam(mu):
    """gam1 = [1/G(1-mu) - 1/G(1+mu)] / (2 mu), gam2 = their mean, and the
    two reciprocal gammas.  For |mu| < 0.01 the difference quotient cancels
    in float32, so both come from the Taylor series (truncation < 1e-14)."""
    b1, b2, b3, b4, b5 = _INVGAMMA_B
    gampl = torch.exp(-torch.lgamma(1.0 + mu))  # |mu| <= 1/2: argument >= 1/2
    gammi = torch.exp(-torch.lgamma(1.0 - mu))
    mu2 = mu * mu
    small = mu.abs() < 0.01
    safe_mu = torch.where(small, torch.ones_like(mu), mu)
    gam1 = torch.where(small, -(b1 + mu2 * (b3 + mu2 * b5)),
                       (gammi - gampl) / (2.0 * safe_mu))
    gam2 = torch.where(small, 1.0 + mu2 * (b2 + mu2 * b4), 0.5 * (gammi + gampl))
    return gam1, gam2, gampl, gammi


def _kv_temme_small(x, mu, count_eps=None):
    """Scaled e^x (K_mu, K_{mu+1}) by Temme's series; valid for x <= 2.  With
    ``count_eps`` it returns instead, per element, the number of terms after
    which both sums move by less than ``count_eps`` relative."""
    x = torch.clamp(x, min=torch.finfo(x.dtype).tiny)
    pimu = math.pi * mu
    safe_pimu = torch.where(pimu == 0, torch.ones_like(pimu), pimu)
    sin_ratio = torch.where(pimu.abs() < 1e-6, 1.0 + pimu * pimu / 6.0,
                            safe_pimu / torch.sin(safe_pimu))
    d = -torch.log(x / 2.0)
    e = mu * d
    ee = torch.exp(e)
    e2 = e * e
    safe_e = torch.where(e == 0, torch.ones_like(e), e)
    sinh_ratio = torch.where(e.abs() < 0.05, 1.0 + e2 / 6.0 + e2 * e2 / 120.0,
                             torch.sinh(safe_e) / safe_e)
    gam1, gam2, gampl, gammi = _temme_gam(mu)
    ff = sin_ratio * (gam1 * torch.cosh(e) + gam2 * sinh_ratio * d)
    p = 0.5 * ee / gampl  # 0.5 e^{mu d} Gamma(1 + mu)
    q = 0.5 / (ee * gammi)  # 0.5 e^{-mu d} Gamma(1 - mu)
    c = torch.ones_like(x)
    dd = 0.25 * x * x
    ksum, ksum1 = ff, p
    terms = torch.zeros_like(x)
    running = torch.ones_like(x, dtype=torch.bool)
    tiny = 0.25 * torch.finfo(x.dtype).eps
    for i in range(1, _TEMME_ITERS + 1):
        ff = (i * ff + p + q) / (i * i - mu * mu)
        c = c * dd / i
        p = p / (i - mu)
        q = q / (i + mu)
        delta, delta1 = c * ff, c * (p - i * ff)
        ksum = ksum + delta
        ksum1 = ksum1 + delta1
        if count_eps is not None:
            terms = terms + running
            running = running & ~((delta.abs() < count_eps * ksum.abs())
                                  & (delta1.abs() < count_eps * ksum1.abs()))
        elif bool(((delta.abs() <= tiny * ksum.abs())
                   & (delta1.abs() <= tiny * ksum1.abs())).all()):
            break  # every element's terms have fallen below its rounding
    if count_eps is not None:
        return terms
    scale = torch.exp(x)  # x <= 2: no overflow
    return ksum * scale, ksum1 * (2.0 / x) * scale


def _kv_cf2_large(x, mu, count_eps=None):
    """Scaled e^x (K_mu, K_{mu+1}) by Steed's CF2; valid for x >= 2.  With
    ``count_eps`` it returns instead the steps each element runs until it
    converges to ``count_eps``."""
    x = torch.clamp(x, min=2.0)
    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    h = d
    delh = d
    a1 = (0.25 - mu * mu) + torch.zeros_like(x)
    q1 = torch.zeros_like(x)
    q2 = torch.ones_like(x)
    a = -a1
    q = a1
    c = a1
    s = 1.0 + q * delh
    eps = torch.finfo(x.dtype).eps if count_eps is None else count_eps
    done = torch.zeros_like(x, dtype=torch.bool)
    steps = torch.zeros_like(x)
    for i in range(2, _CF2_ITERS + 2):
        steps = steps + ~done
        a_n = a - 2.0 * (i - 1.0)
        c_n = -a_n * c / i
        qnew = (q1 - b * q2) / a_n
        q_n = q + c_n * qnew
        b_n = b + 2.0
        d_n = 1.0 / (b_n + a_n * d)
        delh_n = (b_n * d_n - 1.0) * delh
        h_n = h + delh_n
        s_n = s + q_n * delh_n
        # converge on s (increments q delh): it converges last, and the
        # result is sqrt(pi / 2x) / s
        conv = (q_n * delh_n).abs() <= eps * s_n.abs()
        keep = lambda new, old: torch.where(done, old, new)
        b, d, h, delh = keep(b_n, b), keep(d_n, d), keep(h_n, h), keep(delh_n, delh)
        q1, q2 = keep(q2, q1), keep(qnew, q2)
        a, q, c, s = keep(a_n, a), keep(q_n, q), keep(c_n, c), keep(s_n, s)
        done = done | conv
        if bool(done.all()):
            break
    if count_eps is not None:
        return steps
    h = a1 * h
    kmu = torch.sqrt(math.pi / (2.0 * x)) / s  # e^x K_mu(x)
    kmu1 = kmu * (mu + x + 0.5 - h) / x
    return kmu, kmu1


def _split(nu):
    """(|nu|'s nearest-integer part k as int64, mu = |nu| - k)."""
    nu = nu.abs()  # K_{-nu} = K_nu
    k_steps = torch.floor(nu + 0.5)
    return k_steps.to(torch.int64), nu - k_steps


def _kve_raw(x, nu):
    """Scaled e^x K_nu(x) for broadcast x > 0 and real nu."""
    k_steps, mu = _split(nu)
    small = x <= 2.0
    km, kp = torch.empty_like(x), torch.empty_like(x)
    for pick, branch in ((small, _kv_temme_small), (~small, _kv_cf2_large)):
        if bool(pick.any()):
            km[pick], kp[pick] = branch(x[pick], mu[pick])
    kmu = km
    # after j advances (km, kp) = (K_{mu+j}, K_{mu+j+1}); K_{mu+k} for k >= 1
    # is kp after k - 1 advances
    top = min(int(k_steps.max()) if k_steps.numel() else 0, _MAX_RECUR + 1)
    for i in range(1, top):
        knext = km + (2.0 * (mu + i) / x) * kp
        take = i < k_steps
        km, kp = torch.where(take, kp, km), torch.where(take, knext, kp)
    return torch.where(k_steps == 0, kmu, kp)


def _broadcast(x, nu):
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    nu = torch.as_tensor(nu, dtype=x.dtype, device=x.device)
    return torch.broadcast_tensors(x, nu)


class _Kve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, nu):
        out = _kve_raw(x, nu)
        ctx.save_for_backward(x, nu, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, nu, out = ctx.saved_tensors
        gx = gnu = None
        if ctx.needs_input_grad[0]:
            # d/dx [e^x K_nu] = e^x K_nu - e^x (K_{nu-1} + K_{nu+1}) / 2, with
            # K_{nu-1} = K_{nu+1} - (2 nu / x) K_nu
            kp1 = _kve_raw(x, nu + 1.0)
            gx = g * (out - (kp1 - (nu / x) * out))
        if ctx.needs_input_grad[1]:
            h = 1e-4
            gnu = g * (_kve_raw(x, nu + h)
                       - _kve_raw(x, torch.clamp(nu - h, min=0.0))) / (2.0 * h)
        return gx, gnu


def kve(x, nu):
    """Exponentially scaled modified Bessel K: e^x K_nu(x), elementwise."""
    x, nu = _broadcast(x, nu)
    return _Kve.apply(x, nu)


def kv(x, nu):
    """Modified Bessel function of the second kind K_nu(x), elementwise."""
    x, nu = _broadcast(x, nu)
    return _Kve.apply(x, nu) * torch.exp(-x)


def log_kve(x, nu):
    """log(e^x K_nu(x)), for a log-space Matern evaluation."""
    return torch.log(kve(x, nu))


def series_terms(x, nu, eps: float = 2.0**-23):
    """Per element, the Temme terms (x <= 2) or CF2 steps (x > 2) that one
    evaluation of e^x (K_mu, K_{mu+1}) runs until it has converged to ``eps``
    (float32's by default), and whether it took the series: the loop counts
    of ``csrc/vecchia_bessel.cuh``, which leaves both loops at convergence.
    Returns (count, small)."""
    x, nu = _broadcast(x, nu)
    _, mu = _split(nu)
    small = x <= 2.0
    terms = _kv_temme_small(torch.clamp(x, max=2.0), mu, count_eps=eps)
    steps = _kv_cf2_large(torch.clamp(x, min=2.0), mu, count_eps=eps)
    return torch.where(small, terms, steps), small
