"""Metropolis-within-Gibbs primitives, batched over chains (counterpart of
``pynngp_tpu.samplers.mwg``).

The reference vmaps one chain's pure function over a chain axis; here every
array carries that axis explicitly: ``theta_u`` is (C, k), ``value`` (C,),
each aux entry (C, ...), ``log_steps`` (C, k).  Random numbers come from an
explicit ``torch.Generator`` on the chains' device, so a chain's stream is
not the reference's: compare the two by posterior moments.

``logpost_fn(theta_u (C, k)) -> (value (C,), aux dict of (C, ...))`` includes
priors and Jacobians; every proposal costs one call, i.e. one fused suffstats
launch for all chains.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = [
    "sample_inverse_gamma",
    "sample_gaussian_precision",
    "rw_sweep",
    "rw_joint",
    "rw_joint_corr",
    "mh_indep_mix",
    "adapt_log_step",
]


def sample_inverse_gamma(gen, a, b):
    """Draw from IG(shape=a, scale=b) per chain: 1/X with X ~ Gamma(a, rate=b).
    ``a`` and ``b`` broadcast to the chain axis; the draw takes b's dtype."""
    b = torch.as_tensor(b)
    a = torch.as_tensor(a, dtype=b.dtype, device=b.device).expand_as(b)
    return b / torch._standard_gamma(a.contiguous(), generator=gen)


def sample_gaussian_precision(prec, rhs, eps):
    """beta = mean + L^-T eps with prec = L L^T and mean = prec^-1 rhs, per
    chain: a draw from N(prec^-1 rhs, prec^-1) for standard normal ``eps``.
    ``prec`` is (C, p, p), ``rhs`` and ``eps`` (C, p), p the handful of fixed
    effects.  Returns (beta, mean, L)."""
    chol = torch.linalg.cholesky(prec)
    mean = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
    dev = torch.linalg.solve_triangular(chol.mT, eps[..., None], upper=True)
    return mean + dev[..., 0], mean, chol


def _normal(gen, shape, like):
    return torch.randn(shape, generator=gen, dtype=like.dtype, device=like.device)


def _uniform(gen, shape, like):
    return torch.rand(shape, generator=gen, dtype=like.dtype, device=like.device)


def _mh_accept(gen, log_ratio):
    """(accept, acceptance probability) per chain.  A NaN ratio (a proposal
    whose factorization broke down in float32) is a rejection with
    probability 0.

    This departs from the reference on purpose.  There
    (pynngp_tpu/samplers/mwg.py:43-44) the proposal is rejected as here, since
    ``log(u) < nan`` is false, but ``jnp.minimum`` hands the NaN on as the
    acceptance probability, and ``adapt_log_step`` (l.189) adds it to that
    chain's log step: every later proposal of the chain is NaN and the chain
    stands still for the rest of the run without an error.  On finite ratios
    the two agree exactly."""
    u = _uniform(gen, log_ratio.shape, log_ratio)
    accept = torch.log(u) < log_ratio
    accept_prob = torch.clamp(torch.exp(torch.clamp(log_ratio, max=0.0)), max=1.0)
    return accept, torch.nan_to_num(accept_prob, nan=0.0)


def _select(accept, prop, cur):
    """Per-chain choice between two (C, ...) tensors."""
    return torch.where(accept.reshape(accept.shape + (1,) * (cur.ndim - 1)),
                       prop, cur)


def _select_all(accept, prop_theta, theta, prop_value, value, prop_aux, aux):
    theta = _select(accept, prop_theta, theta)
    value = torch.where(accept, prop_value, value)
    aux = {k: _select(accept, prop_aux[k], aux[k]) for k in aux}
    return theta, value, aux


def _matvec(mat, x):
    """mat @ x per chain for a small (k, k) matrix and x of shape (C, k),
    written out elementwise (k is 2 or 3)."""
    return (mat[None, :, :] * x[:, None, :]).sum(-1)


def _lower_solve(chol, x):
    """z = chol^-1 x per chain by forward substitution (chol (k, k) lower,
    x (C, k))."""
    cols = []
    for i in range(chol.shape[0]):
        acc = x[:, i]
        for j in range(i):
            acc = acc - chol[i, j] * cols[j]
        cols.append(acc / chol[i, i])
    return torch.stack(cols, dim=1)


def rw_sweep(gen, theta_u, value, aux, logpost_fn: Callable, log_steps):
    """One componentwise random-walk Metropolis sweep over the k components
    (reference semantics: k sequential sub-updates, one evaluation each).
    Returns (theta_u, value, aux, accept_probs (C, k))."""
    k = theta_u.shape[1]
    accept_probs = []
    for i in range(k):
        eps = _normal(gen, value.shape, theta_u)
        prop = theta_u.clone()
        prop[:, i] = prop[:, i] + torch.exp(log_steps[:, i]) * eps
        prop_value, prop_aux = logpost_fn(prop)
        accept, aprob = _mh_accept(gen, prop_value - value)
        theta_u, value, aux = _select_all(accept, prop, theta_u, prop_value,
                                          value, prop_aux, aux)
        accept_probs.append(aprob)
    return theta_u, value, aux, torch.stack(accept_probs, dim=1)


def rw_joint(gen, theta_u, value, aux, logpost_fn: Callable, log_steps):
    """Joint random-walk Metropolis update (one evaluation per iteration)."""
    eps = _normal(gen, theta_u.shape, theta_u)
    prop = theta_u + torch.exp(log_steps) * eps
    prop_value, prop_aux = logpost_fn(prop)
    accept, aprob = _mh_accept(gen, prop_value - value)
    theta_u, value, aux = _select_all(accept, prop, theta_u, prop_value, value,
                                      prop_aux, aux)
    return theta_u, value, aux, aprob[:, None].expand_as(theta_u)


def rw_joint_corr(gen, theta_u, value, aux, logpost_fn: Callable, log_scale,
                  chol_cov):
    """Joint random-walk Metropolis with a correlated proposal
    prop = theta + exp(log_scale) * L eps, L = chol(proposal covariance):
    walks along a ridge-shaped theta block.  ``log_scale`` is (C,)."""
    eps = _normal(gen, theta_u.shape, theta_u)
    prop = theta_u + torch.exp(log_scale)[:, None] * _matvec(chol_cov, eps)
    prop_value, prop_aux = logpost_fn(prop)
    accept, aprob = _mh_accept(gen, prop_value - value)
    theta_u, value, aux = _select_all(accept, prop, theta_u, prop_value, value,
                                      prop_aux, aux)
    return theta_u, value, aux, aprob[:, None].expand_as(theta_u)


def mh_indep_mix(gen, theta_u, value, aux, logpost_fn: Callable, center,
                 chol_cov, log_scale, df: float = 7.0, p_indep: float = 0.8,
                 target: float = 0.44):
    """Mixture Metropolis kernel: independence proposals from a fitted
    multivariate t (probability ``p_indep``) plus correlated random-walk moves.

    q = t_df(center, chol_cov) fitted from a pilot run draws near-iid theta
    when it matches the posterior; the RW moves keep the kernel exploring
    where it does not.  Both components are valid MH kernels for the same
    target, so the mixture is too.  One evaluation per step: the proposal
    point and its q-correction are chosen before evaluating.  The adaptation
    vector reports ``target`` on independence steps, so the RW scale adapts
    from its own moves only."""
    chains, d = theta_u.shape
    dt = theta_u.dtype

    def t_logq(u):
        z = _lower_solve(chol_cov, u - center)
        return -0.5 * (df + d) * torch.log1p((z * z).sum(-1) / df)

    eps = _normal(gen, theta_u.shape, theta_u)
    half_df = torch.full((chains,), df / 2.0, dtype=dt, device=theta_u.device)
    chi2 = 2.0 * torch._standard_gamma(half_df, generator=gen)
    l_eps = _matvec(chol_cov, eps)
    prop_ind = center + l_eps * torch.sqrt(df / chi2)[:, None]
    prop_rw = theta_u + torch.exp(log_scale)[:, None] * l_eps
    use_ind = _uniform(gen, (chains,), theta_u) < p_indep
    prop = _select(use_ind, prop_ind, prop_rw)
    corr = torch.where(use_ind, t_logq(theta_u) - t_logq(prop),
                       torch.zeros_like(value))
    prop_value, prop_aux = logpost_fn(prop)
    accept, aprob = _mh_accept(gen, prop_value - value + corr)
    theta_u, value, aux = _select_all(accept, prop, theta_u, prop_value, value,
                                      prop_aux, aux)
    aprob_adapt = torch.where(use_ind, torch.full_like(aprob, target), aprob)
    return theta_u, value, aux, aprob_adapt[:, None].expand(chains, d)


def adapt_log_step(log_steps, accept_probs, iteration, n_adapt, target=0.44):
    """Diminishing Robbins-Monro adaptation of RW step sizes during burn-in.
    ``iteration`` is (C,); ``log_steps`` and ``accept_probs`` (C, k)."""
    it = iteration.to(log_steps.dtype)[:, None]
    gamma = (it + 1.0) ** -0.6
    adapting = (iteration < n_adapt).to(log_steps.dtype)[:, None]
    return log_steps + adapting * gamma * (accept_probs - target)
