"""Hamiltonian Monte Carlo on the unconstrained NNGP hyperparameters
(counterpart of ``pynngp_tpu.samplers.hmc``).

Components: the leapfrog integrator, the HMC step with multivariate-normal
momentum and the Metropolis correction, Nesterov dual averaging for the step
size (Stan's scheme), and a Welford accumulator for the diagonal inverse
metric adapted during burn-in.

The reference writes one chain and lets ``vmap`` batch it.  Here the batch is
written out: every array carries a leading chain axis C, ``value_and_grad_fn``
maps (C, d) points to ((C,) values, (C, d) gradients) in one call (one fused
kernel launch for all chains on the GPU), and a condition that the reference
branches on becomes a ``torch.where`` over the chains.  Randomness comes from
an explicit ``torch.Generator``.  Everything runs on the device of the state
it is given, which may be the host while ``value_and_grad_fn`` works on a GPU.

The inverse metric is (C, d), a diagonal per chain, or (C, d, d), dense.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

__all__ = [
    "DualAveraging",
    "da_init",
    "da_update",
    "Welford",
    "welford_init",
    "welford_update",
    "welford_variance",
    "mass_velocity",
    "kinetic",
    "draw_momentum",
    "leapfrog",
    "hmc_step",
    "HMCInfo",
    "HMCState",
    "make_hmc_kernel",
    "hmc_sample",
    "find_reasonable_step_size",
    "select",
    "warmup_schedule",
    "schedule_tensors",
    "initial_inverse_metric",
    "is_dense",
    "adapt",
]


def select(cond, new, old):
    """Per chain, ``new`` where ``cond`` (C,) holds and ``old`` elsewhere, for
    a tensor with a leading chain axis or a NamedTuple of such tensors."""
    if isinstance(new, tuple):
        return type(new)(*(select(cond, n, o) for n, o in zip(new, old)))
    return torch.where(cond.reshape(cond.shape + (1,) * (new.dim() - 1)), new, old)


class DualAveraging(NamedTuple):
    log_step: torch.Tensor  # (C,)
    log_step_avg: torch.Tensor
    h_avg: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor


def da_init(step_size0) -> DualAveraging:
    ls = torch.log(step_size0)
    return DualAveraging(log_step=ls, log_step_avg=ls, h_avg=torch.zeros_like(ls),
                         mu=ls + math.log(10.0), count=torch.zeros_like(ls))


def da_update(da: DualAveraging, accept_prob, target=0.8, gamma=0.05, t0=10.0,
              kappa=0.75) -> DualAveraging:
    count = da.count + 1.0
    eta_h = 1.0 / (count + t0)
    h_avg = (1.0 - eta_h) * da.h_avg + eta_h * (target - accept_prob)
    log_step = da.mu - torch.sqrt(count) / gamma * h_avg
    eta = count**-kappa
    log_step_avg = eta * log_step + (1.0 - eta) * da.log_step_avg
    return DualAveraging(log_step, log_step_avg, h_avg, da.mu, count)


class Welford(NamedTuple):
    mean: torch.Tensor  # (C, d)
    m2: torch.Tensor  # (C, d)
    count: torch.Tensor  # (C,)


def welford_init(n_chains, dim, dtype=torch.float32, device=None) -> Welford:
    zeros = torch.zeros((n_chains, dim), dtype=dtype, device=device)
    return Welford(mean=zeros, m2=zeros.clone(),
                   count=torch.zeros(n_chains, dtype=dtype, device=device))


def welford_update(w: Welford, x) -> Welford:
    count = w.count + 1.0
    delta = x - w.mean
    mean = w.mean + delta / count[:, None]
    m2 = w.m2 + delta * (x - mean)
    return Welford(mean, m2, count)


def welford_variance(w: Welford, regularize=True):
    var = w.m2 / torch.clamp(w.count - 1.0, min=1.0)[:, None]
    if regularize:  # Stan's shrinkage toward the unit metric
        c = w.count[:, None]
        var = (c / (c + 5.0)) * var + 1e-3 * (5.0 / (c + 5.0))
    return var


def mass_velocity(inv_mass, r):
    """M^-1 r for r (C, d).  ``inv_mass`` is a (C, d) diagonal or a
    (C, d, d) dense inverse metric (e.g. the Laplace posterior covariance:
    the dense form is what lets NUTS move along the correlated (sigma2, phi)
    ridge of smooth-kernel NNGP posteriors)."""
    if inv_mass.dim() == 3:
        return (inv_mass @ r[..., None])[..., 0]
    return inv_mass * r


def kinetic(r, inv_mass):
    return 0.5 * (r * mass_velocity(inv_mass, r)).sum(-1)


def draw_momentum(gen, inv_mass):
    """r ~ N(0, M) per chain for a diagonal or dense inverse metric
    M^-1 = V: with V = L L^T, r = L^-T xi has covariance L^-T L^-1 = M."""
    shape = inv_mass.shape[:2]
    xi = torch.randn(shape, generator=gen, dtype=inv_mass.dtype,
                     device=inv_mass.device)
    if inv_mass.dim() == 3:
        # cholesky_ex: no error check, so no wait for the device
        lv = torch.linalg.cholesky_ex(inv_mass).L
        return torch.linalg.solve_triangular(lv.mT, xi[..., None], upper=True)[..., 0]
    return xi / torch.sqrt(inv_mass)


def _leapfrog_step(value_and_grad_fn, z, r, grad, eps, inv_mass):
    """One leapfrog step with per-chain step eps (C, 1)."""
    r_half = r + 0.5 * eps * grad
    z_new = z + eps * mass_velocity(inv_mass, r_half)
    value, grad_new = value_and_grad_fn(z_new)
    return z_new, r_half + 0.5 * eps * grad_new, grad_new, value


def leapfrog(value_and_grad_fn: Callable, z, r, grad, eps, inv_mass, n_steps):
    """n_steps of leapfrog with step eps (C,) or a float; returns (z, r,
    grad, value) at the end."""
    eps = torch.as_tensor(eps, dtype=z.dtype, device=z.device).expand(z.shape[0])
    value = None
    for _ in range(n_steps):
        z, r, grad, value = _leapfrog_step(value_and_grad_fn, z, r, grad,
                                           eps[:, None], inv_mass)
    return z, r, grad, value


class HMCInfo(NamedTuple):
    accept_prob: torch.Tensor  # (C,)
    accepted: torch.Tensor  # (C,) bool
    energy: torch.Tensor  # (C,)
    diverging: torch.Tensor  # (C,) bool


def _nan_to_neg_inf(delta):
    return torch.where(torch.isnan(delta), torch.full_like(delta, -torch.inf), delta)


def hmc_step(gen, z, value, grad, value_and_grad_fn, step_size, inv_mass,
             n_leapfrog, jitter_steps: bool = True):
    """One HMC transition of every chain.  ``value_and_grad_fn`` returns
    (logpost (C,), grad (C, d)).

    With ``jitter_steps`` each chain's trajectory length is uniform on
    [1, n_leapfrog], to avoid resonances; the loop runs to the longest and a
    chain that has arrived keeps its state."""
    n_chains = z.shape[0]
    r0 = draw_momentum(gen, inv_mass)
    energy0 = -value + kinetic(r0, inv_mass)
    if jitter_steps:
        n_run = torch.randint(1, n_leapfrog + 1, (n_chains,), generator=gen,
                              device=z.device)
        n_max = int(n_run.max())
    else:
        n_run = torch.full((n_chains,), n_leapfrog, device=z.device)
        n_max = n_leapfrog
    eps = step_size[:, None]
    z_new, r_new, grad_new, value_new = z, r0, grad, value
    for i in range(n_max):
        stepped = _leapfrog_step(value_and_grad_fn, z_new, r_new, grad_new, eps,
                                 inv_mass)
        z_new, r_new, grad_new, value_new = [
            select(i < n_run, new, old) for new, old in
            zip(stepped, (z_new, r_new, grad_new, value_new))]
    energy1 = -value_new + kinetic(r_new, inv_mass)
    delta = _nan_to_neg_inf(energy0 - energy1)
    accept_prob = torch.exp(torch.clamp(delta, max=0.0))
    uniform = torch.rand(n_chains, generator=gen, dtype=z.dtype, device=z.device)
    accept = torch.log(uniform) < delta
    info = HMCInfo(accept_prob=accept_prob, accepted=accept, energy=energy1,
                   diverging=delta < -1000.0)
    return (select(accept, z_new, z), select(accept, value_new, value),
            select(accept, grad_new, grad), info)


class HMCState(NamedTuple):
    """Batched HMC state.  Warmup is driven by the iteration counter, so one
    step function serves burn-in and sampling (see nuts.NUTSState)."""

    z: torch.Tensor  # (C, d)
    value: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, d)
    da: DualAveraging
    wf: Welford
    inv_mass: torch.Tensor  # (C, d) or (C, d, d)
    iteration: torch.Tensor  # (C,) int32
    info: HMCInfo


def warmup_schedule(n_burn):
    """Stan-style windows: 15% step-only, doubling metric windows, 10% tail.
    Returns (adapt_metric (n,), reset_at (n,)) numpy bool arrays."""
    import numpy as np

    init_buf = max(int(0.15 * n_burn), 1)
    term_buf = max(int(0.10 * n_burn), 1)
    adapt_metric = np.zeros(n_burn, bool)
    reset_at = np.zeros(n_burn, bool)
    lo, hi = init_buf, n_burn - term_buf
    if hi > lo:
        adapt_metric[lo:hi] = True
        # doubling windows: 25, 50, 100, ... closing at hi
        w = 25
        pos = lo
        closes = []
        while pos + w < hi:
            pos += w
            closes.append(pos)
            w *= 2
        closes.append(hi)
        for cpos in closes:
            reset_at[min(cpos, n_burn - 1)] = True
    return adapt_metric, reset_at


def initial_inverse_metric(init_inv_mass, z0):
    """(C, d) ones, or ``init_inv_mass`` ((d,) or (d, d)) repeated per chain."""
    n_chains, dim = z0.shape
    if init_inv_mass is None:
        return torch.ones((n_chains, dim), dtype=z0.dtype, device=z0.device)
    im = torch.as_tensor(init_inv_mass, dtype=z0.dtype, device=z0.device)
    return im.expand((n_chains,) + tuple(im.shape)).contiguous()


def adapt(state, z, accept_prob, n_burn, schedule, target_accept, dense,
          clamp=lambda ls: ls):
    """The warmup bookkeeping shared by the HMC and NUTS step functions:
    dual averaging while ``iteration < n_burn``, Welford accumulation inside
    the metric windows, and at a window's close the new diagonal metric (a
    dense one stays frozen) with dual averaging and Welford restarted.
    Returns (da, wf, inv_mass)."""
    adapt_metric, reset_at = schedule
    warm = state.iteration < n_burn
    i_clip = torch.clamp(state.iteration, 0, max(n_burn, 1) - 1).long()
    da_new = da_update(state.da, accept_prob, target=target_accept)
    da_new = da_new._replace(log_step=clamp(da_new.log_step),
                             log_step_avg=clamp(da_new.log_step_avg))
    da = select(warm, da_new, state.da)
    wf = select(warm & adapt_metric[i_clip], welford_update(state.wf, z), state.wf)
    do_reset = warm & reset_at[i_clip]
    inv_mass = state.inv_mass
    if not dense:
        inv_mass = select(do_reset & (wf.count > 2), welford_variance(wf), inv_mass)
    da = select(do_reset, da_init(torch.exp(da.log_step_avg)), da)
    wf = select(do_reset, welford_init(*z.shape, z.dtype, z.device), wf)
    return da, wf, inv_mass


def schedule_tensors(n_burn, device):
    """:func:`warmup_schedule` as bool tensors on ``device``."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in warmup_schedule(max(n_burn, 1)))


class _Schedule:
    """A kernel's warmup schedule, built once on the device of its state."""

    def __init__(self, n_burn):
        self.n_burn, self._at = n_burn, None

    def on(self, device):
        if self._at is None or self._at[0].device != device:
            self._at = schedule_tensors(self.n_burn, device)
        return self._at


def is_dense(init_inv_mass) -> bool:
    return init_inv_mass is not None and torch.as_tensor(init_inv_mass).dim() == 2


def make_hmc_kernel(value_and_grad_fn: Callable, n_burn: int, n_leapfrog: int = 32,
                    target_accept: float = 0.8, init_inv_mass=None):
    """Build (init_fn(gen, z0 (C, d)), step_fn(gen, state)) for
    ``run_chains_chunked``.

    ``init_inv_mass``: optional starting inverse metric — a (d,) diagonal
    that warmup's Welford windows refine, or a dense (d, d) matrix (e.g. a
    Laplace covariance), which stays frozen through warmup: the Welford
    adaptation is diagonal-only and would discard the off-diagonal
    structure."""
    dense = is_dense(init_inv_mass)
    schedule = _Schedule(n_burn)

    def init_fn(gen, z0):
        n_chains = z0.shape[0]
        value0, grad0 = value_and_grad_fn(z0)
        inv_mass0 = initial_inverse_metric(init_inv_mass, z0)
        eps0 = find_reasonable_step_size(value_and_grad_fn, z0, inv_mass0, gen)
        zeros = torch.zeros(n_chains, dtype=z0.dtype, device=z0.device)
        false = torch.zeros(n_chains, dtype=torch.bool, device=z0.device)
        info0 = HMCInfo(accept_prob=zeros, accepted=false, energy=zeros,
                        diverging=false)
        return HMCState(
            z=z0, value=value0, grad=grad0, da=da_init(eps0),
            wf=welford_init(*z0.shape, z0.dtype, z0.device), inv_mass=inv_mass0,
            iteration=torch.zeros(n_chains, dtype=torch.int32, device=z0.device),
            info=info0)

    def step_fn(gen, state: HMCState):
        warm = state.iteration < n_burn
        step_size = torch.exp(torch.where(warm, state.da.log_step,
                                          state.da.log_step_avg))
        z, value, grad, info = hmc_step(gen, state.z, state.value, state.grad,
                                        value_and_grad_fn, step_size,
                                        state.inv_mass, n_leapfrog)
        da, wf, inv_mass = adapt(state, z, info.accept_prob, n_burn,
                                 schedule.on(z.device), target_accept, dense)
        return HMCState(z=z, value=value, grad=grad, da=da, wf=wf,
                        inv_mass=inv_mass, iteration=state.iteration + 1,
                        info=info)

    return init_fn, step_fn


def _sample_one_chain(make_kernel, value_and_grad_fn: Callable, z0, gen,
                     n_samples: int, n_burn: int, collect_fn: Callable, thin: int):
    """The reference's single-chain run (its ``hmc_sample`` / ``nuts_sample``)
    on a batched kernel with a chain axis of one.

    ``make_kernel(batched_value_and_grad)`` builds (init_fn, step_fn);
    ``value_and_grad_fn`` maps one point (d,) to (value, (d,) gradient), as
    the reference's does.  Runs on ``z0``'s device through
    ``models.base.run_mcmc``.  ``collect_fn(z, value, info) -> tree`` is
    recorded per draw (default: z).  Returns (draws stacked along
    (n_samples,), {"step_size", "inv_mass"} after warmup)."""
    from pynngp_tpu_torch.models.base import run_mcmc

    def batched(z):
        value, grad = value_and_grad_fn(z[0])
        return value.reshape(1), grad.reshape(1, -1)

    init_fn, step_fn = make_kernel(batched)
    state0 = init_fn(gen, torch.as_tensor(z0)[None])
    collect = collect_fn or (lambda z, value, info: z)
    state, draws = run_mcmc(
        gen, state0, step_fn,
        lambda s: collect(s.z[0], s.value[0], type(s.info)(*(t[0] for t in s.info))),
        n_samples, n_burn, thin)
    return draws, {"step_size": torch.exp(state.da.log_step_avg[0]),
                   "inv_mass": state.inv_mass[0]}


def hmc_sample(value_and_grad_fn: Callable, z0, gen: torch.Generator,
               n_samples: int, n_burn: int = 500, n_leapfrog: int = 32,
               target_accept: float = 0.8, collect_fn: Callable = None,
               thin: int = 1):
    """Single-chain HMC run (the reference's ``hmc_sample``): see
    :func:`_sample_one_chain`.  The models' ``sample_hmc`` runs many chains
    with checkpoints."""
    return _sample_one_chain(
        lambda vg: make_hmc_kernel(vg, n_burn, n_leapfrog, target_accept),
        value_and_grad_fn, z0, gen, n_samples, n_burn, collect_fn, thin)


def find_reasonable_step_size(value_and_grad_fn, z, inv_mass, gen, init=1.0,
                              max_iters=30):
    """Stan's heuristic per chain: double or halve until the one-step accept
    probability crosses 0.5 (a fixed number of iterations, no branch)."""
    value0, grad0 = value_and_grad_fn(z)
    r0 = draw_momentum(gen, inv_mass)
    energy0 = -value0 + kinetic(r0, inv_mass)

    def accept_prob(eps):
        _, r1, _, v1 = _leapfrog_step(value_and_grad_fn, z, r0, grad0,
                                      eps[:, None], inv_mass)
        delta = _nan_to_neg_inf(energy0 - (-v1 + kinetic(r1, inv_mass)))
        return torch.exp(torch.clamp(delta, max=0.0))

    eps = torch.full((z.shape[0],), init, dtype=z.dtype, device=z.device)
    up = accept_prob(eps) > 0.5
    factor = torch.where(up, 2.0, 0.5).to(z.dtype)
    done = torch.zeros_like(up)
    for _ in range(max_iters):
        ap = accept_prob(eps)
        done = done | torch.where(up, ap <= 0.5, ap >= 0.5)
        eps = torch.where(done, eps, eps * factor)
    return eps
