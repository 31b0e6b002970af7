"""MAP optimization + Laplace approximation on the unconstrained posterior
(counterpart of ``pynngp_tpu.samplers.mapfit``).

Adam is written out with optax's defaults (b1 0.9, b2 0.999, eps 1e-8 added
outside the square root, bias-corrected moments), so that the traces agree
with the reference's.  ``logpost_fn`` maps (B, k) points to (B,) values; a
batch of points is one batch of chains in the fused kernels, so the 2k
finite-difference gradients of the Laplace Hessian cost one launch per pass.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["MAPResult", "adam_step", "map_fit", "laplace_moments",
           "laplace_variance", "value_and_grad"]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


class MAPResult(NamedTuple):
    u: torch.Tensor  # (k,) MAP point, unconstrained coordinates
    value: torch.Tensor  # log-posterior at u
    laplace_var: torch.Tensor  # (k,) diagonal posterior variance estimate
    laplace_cov: torch.Tensor  # (k, k) dense posterior covariance estimate
    converged: torch.Tensor  # |grad|_inf below tolerance at the end
    trace: torch.Tensor  # (n_steps,) log-posterior trace


def adam_step(param, grad, mu, nu, step: int, learning_rate: float):
    """Step ``step`` (from 1) of ``optax.adam(learning_rate)`` on one tensor,
    descending ``grad``: returns (param, first moment, second moment), each
    operation in optax's order (``scale_by_adam``, then the update scaled by
    -learning_rate and added)."""
    mu = (1.0 - _B1) * grad + _B1 * mu
    nu = (1.0 - _B2) * (grad * grad) + _B2 * nu
    mu_hat = mu / (1.0 - _B1**step)
    nu_hat = nu / (1.0 - _B2**step)
    return param - learning_rate * (mu_hat / (torch.sqrt(nu_hat) + _EPS)), mu, nu


def value_and_grad(logpost_fn: Callable, u):
    """(values (B,), gradients (B, k)) at a batch of points u (B, k)."""
    u = u.detach().requires_grad_(True)
    with torch.enable_grad():
        v = logpost_fn(u)
        (g,) = torch.autograd.grad(v.sum(), u)
    return v.detach(), g


def map_fit(logpost_fn: Callable, u0, n_steps: int = 300,
            learning_rate: float = 5e-2, grad_tol: float = 1e-2) -> MAPResult:
    """Adam ascent on ``logpost_fn`` from ``u0`` (k,); returns the best
    iterate (not the last: Adam can overshoot on stiff posteriors) and the
    Laplace moments there.  Cost: ``n_steps`` value-and-gradient evaluations,
    each one fused kernel-2 pass on the GPU."""
    u = torch.as_tensor(u0).detach().clone()
    mu = torch.zeros_like(u)
    nu = torch.zeros_like(u)
    best_u = u.clone()
    best_v = torch.full((), -torch.inf, dtype=u.dtype, device=u.device)
    trace = []
    for step in range(1, n_steps + 1):
        v, g = value_and_grad(logpost_fn, u[None])
        v, g = v[0], -g[0]  # minimize the negated log-posterior, as optax
        u_new, mu, nu = adam_step(u, g, mu, nu, step, learning_rate)
        better = v > best_v
        best_u = torch.where(better, u, best_u)
        best_v = torch.where(better, v, best_v)
        trace.append(v)
        u = u_new
    # prefer the final iterate when it improves on the running best
    v_last, _ = value_and_grad(logpost_fn, u[None])
    better = v_last[0] > best_v
    u_map = torch.where(better, u, best_u)
    v_map = torch.where(better, v_last[0], best_v)
    _, g_map = value_and_grad(logpost_fn, u_map[None])
    converged = g_map.abs().max() < grad_tol
    var, cov = laplace_moments(logpost_fn, u_map)
    return MAPResult(u=u_map, value=v_map, laplace_var=var, laplace_cov=cov,
                     converged=converged, trace=torch.stack(trace))


def laplace_moments(logpost_fn: Callable, u_map, rel_floor: float = 1e-8,
                    fd_step: float = 1e-3):
    """(diagonal variance, dense covariance) of the Laplace approximation
    H^-1 with H = -hessian(logpost) at the MAP.

    The Hessian is a central finite difference of the exact gradient, in two
    passes: pass 1 with h = ``fd_step`` gets rough scales, pass 2
    re-differences with h_i = 0.5 sd_i (clamped to [fd_step, 1]) so that
    float32 gradient noise stays small against the curvature.  The inverse
    is SoftAbs-style: eigenvalue magnitudes are clamped away from zero, at
    ``rel_floor`` times the largest, and a non-finite result falls back to
    identity.  The k x k eigendecomposition runs on the host."""
    u_map = torch.as_tensor(u_map).detach()
    k = u_map.shape[0]
    eye = torch.eye(k, dtype=u_map.dtype, device=u_map.device)

    def moments(steps):
        shift = steps[:, None] * eye
        pts = torch.cat([u_map + shift, u_map - shift])  # (2k, k)
        _, g = value_and_grad(logpost_fn, pts)
        h_rows = (g[:k] - g[k:]) / (2.0 * steps[:, None])  # row i = d grad/d u_i
        h = (-0.5 * (h_rows + h_rows.T)).cpu()
        evals, evecs = torch.linalg.eigh(h)
        floor = torch.clamp(evals.abs().max() * rel_floor, min=1e-30)
        safe = torch.maximum(evals.abs(), floor)
        hinv = (evecs / safe[None, :]) @ evecs.T
        var = torch.diagonal(hinv)
        if not bool(torch.isfinite(var).all()):
            var, hinv = torch.ones(k, dtype=h.dtype), torch.eye(k, dtype=h.dtype)
        return var.to(u_map.device), hinv.to(u_map.device)

    var1, _ = moments(torch.full((k,), fd_step, dtype=u_map.dtype,
                                 device=u_map.device))
    steps = torch.clamp(0.5 * torch.sqrt(var1), fd_step, 1.0)
    return moments(steps)


def laplace_variance(logpost_fn: Callable, u_map, rel_floor: float = 1e-8,
                     fd_step: float = 1e-3):
    """Diagonal of :func:`laplace_moments`."""
    return laplace_moments(logpost_fn, u_map, rel_floor, fd_step)[0]
