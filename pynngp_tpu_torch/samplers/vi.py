"""Variational inference: ADVI, a Gaussian on the unconstrained parameters
(mean-field, or full rank through a Cholesky factor), over the same
differentiable log-posterior the gradient samplers drive (counterpart of
``pynngp_tpu.samplers.vi``).

The reparameterized ELBO gradient with optax's Adam (``mapfit.adam_step``).
One step evaluates ``logpost_fn`` at its ``n_mc`` points in one batch: with
a model on the card that is one launch of kernel 2 for all of them, and
autograd carries the gradient to (mu, log_sd, chol).  The variational
parameters, a few numbers, stay on the host with the generator.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from pynngp_tpu_torch.samplers.mapfit import adam_step

__all__ = ["ADVIResult", "advi_fit", "advi_sample"]


class ADVIResult(NamedTuple):
    mu: torch.Tensor  # (k,)
    log_sd: torch.Tensor  # (k,) log of the scale's diagonal
    chol_factor: torch.Tensor  # (k, k) strictly lower part used (full rank), else zeros
    elbo_trace: torch.Tensor  # (n_steps,)
    full_rank: bool


def _q_sample(params, eps, full_rank: bool):
    """Points of q for standard normals ``eps`` (n, k)."""
    mu, log_sd, chol = params
    if full_rank:
        scale_tril = torch.tril(chol, -1) + torch.diag(torch.exp(log_sd))
        return mu + eps @ scale_tril.T
    return mu + eps * torch.exp(log_sd)


def _q_entropy(params, full_rank: bool):
    """Entropy of N(mu, S): 0.5 log det(2 pi e S), log det S = 2 sum log_sd
    (the diagonal of the scale is exp(log_sd) in both forms)."""
    mu, log_sd, _ = params
    k = mu.shape[0]
    return 0.5 * k * (1.0 + math.log(2.0 * math.pi)) + torch.sum(log_sd)


def advi_fit(logpost_fn: Callable, dim: int, gen: torch.Generator,
             n_steps: int = 2000, n_mc: int = 8, learning_rate: float = 1e-2,
             full_rank: bool = False, init_mu=None, init_log_sd=None,
             dtype=torch.float32, eps=None) -> ADVIResult:
    """Maximize ELBO(q) = E_q[logpost] + H(q) by stochastic gradient ascent.

    ``logpost_fn`` maps (n_mc, dim) points to (n_mc,) values.  Each step
    draws (n_mc, dim) standard normals from ``gen``, or takes step i's from
    ``eps`` (n_steps, n_mc, dim) when given."""
    dev = gen.device if eps is None else eps.device
    like = dict(dtype=dtype, device=dev)
    mu = (torch.as_tensor(init_mu, **like).clone() if init_mu is not None
          else torch.zeros((dim,), **like))
    log_sd = (torch.as_tensor(init_log_sd, **like).clone() if init_log_sd is not None
              else torch.full((dim,), -1.0, **like))
    params = [mu, log_sd, torch.zeros((dim, dim), **like)]
    # the mean-field ELBO does not depend on chol: its gradient is zero, and
    # Adam leaves it where it is
    fitted = 3 if full_rank else 2
    moments = [(torch.zeros_like(p), torch.zeros_like(p)) for p in params]
    elbos = []
    for i in range(n_steps):
        e = eps[i] if eps is not None else torch.randn((n_mc, dim), generator=gen, **like)
        leaves = [p.detach().requires_grad_(j < fitted) for j, p in enumerate(params)]
        with torch.enable_grad():
            z = _q_sample(leaves, e, full_rank)
            loss = -(torch.mean(logpost_fn(z)) + _q_entropy(leaves, full_rank))
            grads = torch.autograd.grad(loss, leaves[:fitted])
        for j, g in enumerate(grads):
            params[j], m1, m2 = adam_step(params[j], g, *moments[j], i + 1,
                                          learning_rate)
            moments[j] = (m1, m2)
        elbos.append(-loss.detach())
    mu, log_sd, chol = params
    return ADVIResult(mu=mu, log_sd=log_sd, chol_factor=chol,
                      elbo_trace=torch.stack(elbos) if elbos else torch.zeros(0, **like),
                      full_rank=full_rank)


def advi_sample(result: ADVIResult, gen: torch.Generator, n: int):
    """Draw n points (n, k) from the fitted variational posterior."""
    eps = torch.randn((n, result.mu.shape[0]), generator=gen, dtype=result.mu.dtype,
                      device=result.mu.device)
    return _q_sample((result.mu, result.log_sd, result.chol_factor), eps,
                     result.full_rank)
