"""Sequential Monte Carlo with likelihood tempering (counterpart of
``pynngp_tpu.samplers.smc``).

Adaptive tempered SMC: particles start from the prior at inverse
temperature beta = 0; each stage picks the next beta by bisection so that
the effective sample size of the incremental weights stays near a target
fraction, reweights, resamples systematically when the ESS drops, and
rejuvenates with a few random-walk Metropolis moves targeting
prior(u) lik(u)^beta, their proposal covariance estimated from the weighted
cloud (scale 2.38^2/d, adapted towards 0.3 acceptance).  At beta = 1 the
weighted cloud targets the posterior and the accumulated log-normalizers
give the evidence log Z.

Where the work runs.  ``loglik_fn`` and ``logprior_fn`` take a batch of
particles (N, k) and return (N,): with a model on the card the initial
evaluation and each move are one launch of kernel 1 for all N particles
(the (N, 6) parameter rows go to the card, the (N,) sums come back).
Everything else, the particles, weights, bisection, resampling and the
(k, k) Cholesky of the cloud's covariance, is a few numbers per particle
and stays on the host, in the particles' dtype, with a host generator.
:func:`smc_sample` runs under ``torch.no_grad()``: a differentiated call of
the model's likelihood would run kernel 2.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["SMCState", "make_smc_stage", "smc_sample", "systematic_resample"]


class SMCState(NamedTuple):
    u: torch.Tensor  # (N, k) particles (unconstrained)
    loglik: torch.Tensor  # (N,) log-likelihood at u
    logprior: torch.Tensor  # (N,)
    logw: torch.Tensor  # (N,) unnormalized log-weights
    beta: torch.Tensor  # scalar inverse temperature
    log_z: torch.Tensor  # accumulated log-evidence
    scale: torch.Tensor  # RW move scale factor


def _ess(logw):
    lw = logw - torch.logsumexp(logw, 0)
    return torch.exp(-torch.logsumexp(2.0 * lw, 0))


def systematic_resample(uniform, logw, n: int):
    """Systematic resampling: (n,) ancestor indices for one uniform draw in
    [0, 1).  Where the float cumulative sum of the weights ends short of 1
    the last points fall past it; they take the last particle, as the
    reference's clamped gather does."""
    lw = logw - torch.logsumexp(logw, 0)
    cum = torch.cumsum(torch.exp(lw), 0)
    pts = (uniform + torch.arange(n, dtype=logw.dtype, device=logw.device)) / n
    idx = torch.searchsorted(cum, pts)
    return torch.clamp(idx, max=logw.shape[0] - 1)


def _find_next_beta(loglik, logw, beta, target_ess_frac, n_bisect=30):
    """Largest delta with ESS(logw + delta loglik) >= target (bisection)."""
    target = target_ess_frac * loglik.shape[0]
    hi0 = 1.0 - beta
    if _ess(logw + hi0 * loglik) >= target:
        delta = hi0
    else:
        lo, hi = torch.zeros_like(hi0), hi0
        for _ in range(n_bisect):
            mid = 0.5 * (lo + hi)
            if _ess(logw + mid * loglik) >= target:
                lo = mid
            else:
                hi = mid
        delta = lo
    return torch.maximum(delta, 1e-6 * hi0)  # always make progress


def make_smc_stage(logprior_fn: Callable, loglik_fn: Callable, n_move: int = 5,
                   target_ess_frac: float = 0.5, resample_ess_frac: float = 0.5):
    """The per-stage transition ``stage(gen, state, draws=None) -> (state,
    info)``.  ``draws`` replaces the stage's random numbers: (the resampling
    uniform (), the moves' normals (n_move, N, k), their uniforms
    (n_move, N)); otherwise they come from ``gen`` in that order."""

    def stage(gen, state: SMCState, draws=None):
        u, loglik, logprior = state.u, state.loglik, state.logprior
        n, k = u.shape
        if draws is None:
            like = dict(dtype=u.dtype, device=u.device, generator=gen)
            draws = (torch.rand((), **like),
                     torch.randn((n_move, n, k), **like),
                     torch.rand((n_move, n), **like))
        res_uniform, normals, uniforms = draws
        delta = _find_next_beta(loglik, state.logw, state.beta, target_ess_frac)
        beta = state.beta + delta
        logw = state.logw + delta * loglik
        # evidence increment: log mean of the incremental weights under the
        # previous normalized weights
        lw_prev = state.logw - torch.logsumexp(state.logw, 0)
        log_z = state.log_z + torch.logsumexp(lw_prev + delta * loglik, 0)
        # resample when depleted (with target_ess_frac == resample_ess_frac
        # this fires on every full-size stage and the weights reset)
        do_resample = bool(_ess(logw) <= resample_ess_frac * n + 1e-6 * n)
        if do_resample:
            idx = systematic_resample(res_uniform, logw, n)
            u, loglik, logprior = u[idx], loglik[idx], logprior[idx]
            logw = torch.zeros_like(logw)

        # rejuvenation: adaptive RW Metropolis on the tempered target
        w_now = torch.exp(logw - torch.logsumexp(logw, 0))
        mean = torch.sum(w_now[:, None] * u, 0)
        cent = u - mean
        eye = torch.eye(k, dtype=u.dtype, device=u.device)
        cov = (cent * w_now[:, None]).T @ cent + 1e-8 * eye
        chol = torch.linalg.cholesky(cov)
        base_scale = 2.38 / math.sqrt(k)
        scale, acc_rate = state.scale, torch.zeros((), dtype=u.dtype)
        for i in range(n_move):
            prop = u + scale * base_scale * (normals[i] @ chol.T)
            lp_prop = logprior_fn(prop)
            ll_prop = loglik_fn(prop)
            log_ratio = (lp_prop + beta * ll_prop) - (logprior + beta * loglik)
            acc = torch.log(uniforms[i]) < log_ratio
            u = torch.where(acc[:, None], prop, u)
            loglik = torch.where(acc, ll_prop, loglik)
            logprior = torch.where(acc, lp_prop, logprior)
            acc_rate = torch.mean(acc.to(u.dtype))
            # gentle scale adaptation toward 0.3 acceptance
            scale = scale * torch.exp(0.5 * (acc_rate - 0.3))
        new_state = SMCState(u=u, loglik=loglik, logprior=logprior, logw=logw,
                             beta=beta, log_z=log_z, scale=scale)
        info = {"beta": beta, "ess": _ess(logw),
                "resampled": torch.tensor(do_resample), "accept": acc_rate}
        return new_state, info

    return stage


def smc_sample(logprior_fn: Callable, loglik_fn: Callable,
               prior_sample_fn: Callable, gen: torch.Generator,
               n_particles: int = 1024, n_move: int = 5,
               target_ess_frac: float = 0.5, resample_ess_frac: float = 0.5,
               max_stages: int = 200, verbose: bool = False):
    """Run adaptive tempered SMC to beta = 1.  ``prior_sample_fn(gen, n)``
    draws the (n, k) initial particles on the host.

    Returns (final SMCState, list of per-stage info dicts of numpy values).
    The final particles with weights ``state.logw`` target the posterior;
    ``state.log_z`` is the log-evidence estimate."""
    with torch.no_grad():
        u0 = prior_sample_fn(gen, n_particles)
        zeros = torch.zeros((), dtype=u0.dtype)
        state = SMCState(u=u0, loglik=loglik_fn(u0), logprior=logprior_fn(u0),
                         logw=torch.zeros((n_particles,), dtype=u0.dtype),
                         beta=zeros, log_z=zeros, scale=torch.ones((), dtype=u0.dtype))
        stage = make_smc_stage(logprior_fn, loglik_fn, n_move, target_ess_frac,
                               resample_ess_frac)
        infos = []
        for s in range(max_stages):
            state, info = stage(gen, state)
            info = {key: np.asarray(val) for key, val in info.items()}
            infos.append(info)
            if verbose:
                print(f"stage {s}: beta={float(info['beta']):.4f} "
                      f"ess={float(info['ess']):.0f} acc={float(info['accept']):.2f}")
            if float(info["beta"]) >= 1.0 - 1e-9:
                break
    return state, infos
