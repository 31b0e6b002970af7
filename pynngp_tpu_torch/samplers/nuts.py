"""No-U-Turn Sampler, iterative multinomial variant with biased progressive
sampling (counterpart of ``pynngp_tpu.samplers.nuts``).

The trajectory tree of depth d is built by at most 2^d leapfrog steps; the
U-turn checks inside a subtree use a checkpoint stack of max_depth + 1 slots
indexed by the trailing-zero count of the leaf index: at leaf i, every
power-of-two block [i+1-2^l, i] that has just been completed is checked
against the momentum stored when its left boundary leaf was entered (the
iterative scheme of Phan & Pradhan).

The reference writes one chain with two nested ``lax.while_loop``s and lets
``vmap`` batch it.  Here the batch is written out.  All chains that are
still running share the tree depth and the leaf index, so both are Python
integers and the loops are Python loops that run while any chain is
unfinished; each iteration is ONE ``value_and_grad_fn`` call for all chains
(one fused kernel launch on the GPU), and a chain that has turned, diverged
or finished keeps its state through ``torch.where``, which is what ``vmap``
makes of a ``while_loop``.  The price is one read of a flag per leapfrog
step, from the device if the state lives there.  The state may live on the
host while ``value_and_grad_fn`` does its heavy work on a GPU: it is a few
numbers per chain, and the models' entry points keep it there.

Frame convention: trajectory endpoints store momenta in the trajectory
frame (pointing rightward along the trajectory).  Extending leftward
integrates forward from (z_l, -r_l) with a negative step and negates the end
momentum back; the U-turn checks inside a subtree are sign-invariant, so
they use the integrated frame directly.

Warmup follows Stan's windowed scheme (simplified): step-size dual averaging
throughout burn-in, a diagonal metric estimated by Welford accumulation over
doubling windows, metric and step size reset at window closes.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from pynngp_tpu_torch.samplers.hmc import (
    DualAveraging,
    Welford,
    adapt,
    da_init,
    draw_momentum,
    find_reasonable_step_size,
    initial_inverse_metric,
    is_dense,
    kinetic,
    mass_velocity,
    _sample_one_chain,
    _Schedule,
    select,
    warmup_schedule,
    welford_init,
)

__all__ = ["nuts_step", "nuts_sample", "make_nuts_kernel", "NUTSInfo", "NUTSState"]

_MAX_DELTA_ENERGY = 1000.0
_warmup_schedule = warmup_schedule


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor  # (C,) mean leapfrog accept prob (dual averaging)
    diverging: torch.Tensor  # (C,) bool
    depth: torch.Tensor  # (C,) int32
    n_leapfrog: torch.Tensor  # (C,) int32
    energy: torch.Tensor  # (C,)


def _is_turning(inv_mass, r_left, r_right, rho):
    v_l = mass_velocity(inv_mass, r_left)
    v_r = mass_velocity(inv_mass, r_right)
    return ((rho * v_l).sum(-1) <= 0.0) | ((rho * v_r).sum(-1) <= 0.0)


def _trailing_zeros(i: int, max_bits: int) -> int:
    """Number of trailing zero bits of i, at most max_bits (i = 0 gives
    max_bits)."""
    return sum(i % 2 ** (b + 1) == 0 for b in range(max_bits))


class _Subtree(NamedTuple):
    """Per-chain state of a subtree under construction; every field (C, ...)."""

    z: torch.Tensor
    r: torch.Tensor
    g: torch.Tensor
    v: torch.Tensor
    z_prop: torch.Tensor
    v_prop: torch.Tensor
    g_prop: torch.Tensor
    log_sum_w: torch.Tensor
    rho: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_ap: torch.Tensor
    n_leapfrog: torch.Tensor


def _build_subtree(gen, vg_fn, z0, r0, g0, depth: int, eps, h0, inv_mass,
                   max_depth: int, active) -> _Subtree:
    """For every chain of ``active``, a subtree of 2^depth leaves by forward
    integration with step eps (C,) from (z0, r0); a chain stops early on a
    U-turn or a divergence.  Chains outside ``active`` are left at their
    start with no leaf and weight -inf."""
    n_chains, dim = z0.shape
    dtype, dev = z0.dtype, z0.device
    zeros = torch.zeros(n_chains, dtype=dtype, device=dev)
    neg_inf = torch.full((n_chains,), -torch.inf, dtype=dtype, device=dev)
    false = torch.zeros(n_chains, dtype=torch.bool, device=dev)
    c = _Subtree(z=z0, r=r0, g=g0, v=zeros, z_prop=z0, v_prop=neg_inf, g_prop=g0,
                 log_sum_w=neg_inf, rho=torch.zeros_like(z0), turning=false,
                 diverging=false, sum_ap=zeros,
                 n_leapfrog=torch.zeros(n_chains, dtype=torch.int32, device=dev))
    # checkpoints feed only the U-turn flags, which a stopped chain no longer
    # takes, so they need no per-chain guard
    ckpt_r = [None] * (max_depth + 1)
    ckpt_rho = [None] * (max_depth + 1)
    eps_col = eps[:, None]
    for i in range(2**depth):
        run = active & ~c.turning & ~c.diverging
        if not bool(run.any()):  # the one host read per leapfrog step
            break
        slot = _trailing_zeros(i, max_depth)
        ckpt_r[slot], ckpt_rho[slot] = c.r, c.rho
        # one leapfrog step
        r_half = c.r + 0.5 * eps_col * c.g
        z = c.z + eps_col * mass_velocity(inv_mass, r_half)
        v, g = vg_fn(z)
        r = r_half + 0.5 * eps_col * g
        h = -v + kinetic(r, inv_mass)
        delta = h0 - h  # log weight
        delta = torch.where(torch.isnan(delta), neg_inf, delta)
        diverging = ((h - h0) > _MAX_DELTA_ENERGY) | torch.isinf(delta)
        log_sum_w = torch.logaddexp(c.log_sum_w, delta)
        uniform = torch.rand(n_chains, generator=gen, dtype=dtype, device=dev)
        take = torch.log(uniform) < delta - log_sum_w
        rho = c.rho + r
        # U-turn checks for every power-of-two block that this leaf completes
        turning = c.turning
        for level in range(1, max_depth + 1):
            blk = 2**level
            if (i + 1) % blk:
                break  # a larger block cannot end here either
            slot_k = _trailing_zeros(i + 1 - blk, max_depth)
            turning = turning | _is_turning(inv_mass, ckpt_r[slot_k], r,
                                            rho - ckpt_rho[slot_k])
        stepped = _Subtree(
            z=z, r=r, g=g, v=v,
            z_prop=select(take, z, c.z_prop), v_prop=select(take, v, c.v_prop),
            g_prop=select(take, g, c.g_prop), log_sum_w=log_sum_w, rho=rho,
            turning=turning, diverging=diverging,
            sum_ap=c.sum_ap + torch.exp(torch.clamp(delta, max=0.0)),
            n_leapfrog=c.n_leapfrog + 1)
        c = select(run, stepped, c)
    return c


def nuts_step(gen, z, value, grad, value_and_grad_fn, step_size, inv_mass,
              max_depth: int = 8):
    """One multinomial-NUTS transition of every chain; returns (z, value,
    grad, NUTSInfo).  ``step_size`` is (C,)."""
    n_chains = z.shape[0]
    dtype, dev = z.dtype, z.device
    r0 = draw_momentum(gen, inv_mass)
    h0 = -value + kinetic(r0, inv_mass)
    false = torch.zeros(n_chains, dtype=torch.bool, device=dev)
    izeros = torch.zeros(n_chains, dtype=torch.int32, device=dev)
    c = {
        "z_l": z, "r_l": r0, "g_l": grad,
        "z_r": z, "r_r": r0, "g_r": grad,
        "rho": r0,
        "z_prop": z, "v_prop": value, "g_prop": grad,
        "log_sum_w": torch.zeros(n_chains, dtype=dtype, device=dev),  # root leaf
        "turning": false, "diverging": false,
        "sum_ap": torch.zeros(n_chains, dtype=dtype, device=dev),
        "n_leapfrog": izeros, "depth": izeros,
    }
    for depth in range(max_depth):
        active = ~c["turning"] & ~c["diverging"]
        if not bool(active.any()):
            break
        go_right = torch.rand(n_chains, generator=gen, device=dev) < 0.5
        z0 = select(go_right, c["z_r"], c["z_l"])
        r0_int = select(go_right, c["r_r"], -c["r_l"])
        g0 = select(go_right, c["g_r"], c["g_l"])
        eps = torch.where(go_right, step_size, -step_size)
        sub = _build_subtree(gen, value_and_grad_fn, z0, r0_int, g0, depth, eps,
                             h0, inv_mass, max_depth, active)
        ok = ~sub.turning & ~sub.diverging
        # endpoints (trajectory frame: the left momentum points rightward)
        right, left = ok & go_right, ok & ~go_right
        z_r = select(right, sub.z, c["z_r"])
        r_r = select(right, sub.r, c["r_r"])
        g_r = select(right, sub.g, c["g_r"])
        z_l = select(left, sub.z, c["z_l"])
        r_l = select(left, -sub.r, c["r_l"])
        g_l = select(left, sub.g, c["g_l"])
        sign = torch.where(go_right, 1.0, -1.0).to(dtype)[:, None]
        rho = c["rho"] + select(ok, sign * sub.rho, torch.zeros_like(sub.rho))
        # biased progressive sampling across subtrees
        uniform = torch.rand(n_chains, generator=gen, dtype=dtype, device=dev)
        take = ok & (torch.log(uniform) < sub.log_sum_w - c["log_sum_w"])
        new = {
            "z_l": z_l, "r_l": r_l, "g_l": g_l,
            "z_r": z_r, "r_r": r_r, "g_r": g_r,
            "rho": rho,
            "z_prop": select(take, sub.z_prop, c["z_prop"]),
            "v_prop": select(take, sub.v_prop, c["v_prop"]),
            "g_prop": select(take, sub.g_prop, c["g_prop"]),
            "log_sum_w": torch.where(
                ok, torch.logaddexp(c["log_sum_w"], sub.log_sum_w), c["log_sum_w"]),
            "turning": sub.turning | (ok & _is_turning(inv_mass, r_l, r_r, rho)),
            "diverging": sub.diverging,
            "sum_ap": c["sum_ap"] + sub.sum_ap,
            "n_leapfrog": c["n_leapfrog"] + sub.n_leapfrog,
            "depth": c["depth"] + 1,
        }
        c = {k: select(active, new[k], c[k]) for k in c}
    n_lf = torch.clamp(c["n_leapfrog"], min=1)
    info = NUTSInfo(accept_prob=c["sum_ap"] / n_lf.to(dtype),
                    diverging=c["diverging"], depth=c["depth"],
                    n_leapfrog=c["n_leapfrog"], energy=h0)
    return c["z_prop"], c["v_prop"], c["g_prop"], info


class NUTSState(NamedTuple):
    """Batched NUTS state: warmup adaptation is driven by the iteration
    counter, so one step function serves burn-in and sampling and plugs into
    ``run_chains_chunked``."""

    z: torch.Tensor  # (C, d)
    value: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, d)
    da: DualAveraging
    wf: Welford
    inv_mass: torch.Tensor  # (C, d) or (C, d, d)
    iteration: torch.Tensor  # (C,) int32
    info: NUTSInfo


def make_nuts_kernel(value_and_grad_fn: Callable, n_burn: int, max_depth: int = 8,
                     target_accept: float = 0.8, init_inv_mass=None):
    """Build (init_fn(gen, z0 (C, d)), step_fn(gen, state)) with Stan-style
    windowed warmup handled inside step_fn (iteration < n_burn).

    ``init_inv_mass``: optional starting inverse metric.  A (d,) diagonal
    (e.g. a Laplace posterior-variance estimate, samplers/mapfit.py) is
    refined by warmup's Welford windows; a dense (d, d) matrix (e.g. a full
    Laplace covariance) stays frozen through warmup: the Welford adaptation
    is diagonal-only and would discard the off-diagonal ridge structure the
    dense metric was chosen for.  Starting at the posterior scale instead of
    the unit metric is what lets short warmups converge at n=100k."""
    dense = is_dense(init_inv_mass)
    schedule = _Schedule(n_burn)
    # With the metric near the posterior covariance the step size is
    # dimensionless (whitened-curvature units) and any sane value is
    # O(0.01-2).  Dual averaging is clamped there: at large n the float32
    # noise of the likelihood floors the acceptance statistic across decades
    # of step size, the accept-vs-step curve goes flat, and unclamped dual
    # averaging can random-walk down to steps at which every tree reaches
    # its maximum depth.
    lo, hi = math.log(0.01), math.log(2.0)
    clamp = (lambda ls: torch.clamp(ls, lo, hi)) if dense else (lambda ls: ls)

    def init_fn(gen, z0):
        n_chains = z0.shape[0]
        value0, grad0 = value_and_grad_fn(z0)
        inv_mass0 = initial_inverse_metric(init_inv_mass, z0)
        eps0 = find_reasonable_step_size(value_and_grad_fn, z0, inv_mass0, gen)
        zeros = torch.zeros(n_chains, dtype=z0.dtype, device=z0.device)
        izeros = torch.zeros(n_chains, dtype=torch.int32, device=z0.device)
        info0 = NUTSInfo(accept_prob=zeros,
                         diverging=torch.zeros(n_chains, dtype=torch.bool,
                                               device=z0.device),
                         depth=izeros, n_leapfrog=izeros, energy=zeros)
        return NUTSState(
            z=z0, value=value0, grad=grad0, da=da_init(eps0),
            wf=welford_init(*z0.shape, z0.dtype, z0.device), inv_mass=inv_mass0,
            iteration=izeros, info=info0)

    def step_fn(gen, state: NUTSState):
        warm = state.iteration < n_burn
        step_size = torch.exp(clamp(torch.where(warm, state.da.log_step,
                                                state.da.log_step_avg)))
        z, value, grad, info = nuts_step(gen, state.z, state.value, state.grad,
                                         value_and_grad_fn, step_size,
                                         state.inv_mass, max_depth)
        da, wf, inv_mass = adapt(state, z, info.accept_prob, n_burn,
                                 schedule.on(z.device), target_accept, dense,
                                 clamp)
        return NUTSState(z=z, value=value, grad=grad, da=da, wf=wf,
                         inv_mass=inv_mass, iteration=state.iteration + 1,
                         info=info)

    return init_fn, step_fn


def nuts_sample(value_and_grad_fn: Callable, z0, gen: torch.Generator,
                n_samples: int, n_burn: int = 500, max_depth: int = 8,
                target_accept: float = 0.8, collect_fn: Callable = None,
                thin: int = 1):
    """Single-chain NUTS run (the reference's ``nuts_sample``): see
    ``hmc._sample_one_chain``.  The models' ``sample_nuts`` runs many chains
    with checkpoints."""
    return _sample_one_chain(
        lambda vg: make_nuts_kernel(vg, n_burn, max_depth, target_accept),
        value_and_grad_fn, z0, gen, n_samples, n_burn, collect_fn, thin)
