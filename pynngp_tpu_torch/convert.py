"""Carries the reference package's state across to the port.  Inputs are
numpy arrays (the JAX arrays after ``np.asarray``), so this module needs no
JAX."""

from __future__ import annotations

import numpy as np
import torch

from pynngp_tpu_torch.models.latent import LatentState
from pynngp_tpu_torch.models.response import ResponseState
from pynngp_tpu_torch.ops.site_tables import LAYOUTS, SiteTables, padded_size
from pynngp_tpu_torch.samplers.hmc import DualAveraging, HMCInfo, HMCState, Welford
from pynngp_tpu_torch.samplers.nuts import NUTSInfo, NUTSState
from pynngp_tpu_torch.samplers.smc import SMCState
from pynngp_tpu_torch.samplers.vi import ADVIResult

__all__ = ["site_tables_from_lane_cache", "bf_planes_from_rows",
           "response_state_from_jax", "latent_state_from_jax",
           "nuts_state_from_jax", "hmc_state_from_jax", "smc_state_from_jax",
           "advi_result_from_jax"]


def site_tables_from_lane_cache(tab_a, tab_b, nn_idx, n, device="cpu",
                                layout="dist"):
    """Plane-major :class:`SiteTables` from the ``LaneCache`` arrays of a
    cache over n sites in either layout: ``tab_a`` (m, S, 8, 128) and
    ``tab_b`` (m(m-1)/2, S, 8, 128) distance planes (dist), or ``tab_a``
    (d, S, 8, 128) and ``tab_b`` (m d, S, 8, 128) coordinate planes
    (coords); ``nn_idx`` (m, S, 8, 128) in both.  The tile padding beyond the
    port's block padding holds only zeros and is dropped."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be 'dist' or 'coords', got {layout!r}")
    n_pad = padded_size(n)

    def planes(a):
        a = np.asarray(a)
        flat = a.reshape(a.shape[0], -1)
        if flat.shape[1] < n_pad or np.any(flat[:, n:]):
            raise ValueError(f"not a {layout}-layout lane cache over n sites")
        return torch.as_tensor(np.ascontiguousarray(flat[:, :n_pad]),
                               device=device)

    return SiteTables(tab_a=planes(tab_a), tab_b=planes(tab_b),
                      nn_idx=planes(np.asarray(nn_idx, np.int32)), n=n,
                      n_pad=n_pad, layout=layout)


def bf_planes_from_rows(b, f, dtype=None, device="cpu"):
    """The port's plane-major (B (C, m, n_pad), F (C, n_pad)) from the
    reference's row-major B (C, n, m) and F (C, n): transposed, and padded to
    the block size with B = 0, F = 1 as the port's kernel pads."""
    b = torch.as_tensor(np.asarray(b), dtype=dtype, device=device)
    f = torch.as_tensor(np.asarray(f), dtype=dtype, device=device)
    pad = padded_size(b.shape[1]) - b.shape[1]
    b = torch.nn.functional.pad(b.transpose(1, 2), (0, pad))
    return b.contiguous(), torch.nn.functional.pad(f, (0, pad), value=1.0)


def _field_reader(state_np, batched, dtype, device):
    def field(name, dt=dtype):
        a = np.asarray(getattr(state_np, name))
        return torch.tensor(a if batched else a[None], dtype=dt, device=device)

    return field


def response_state_from_jax(state_np, dtype=None, device="cpu") -> ResponseState:
    """The port's batched :class:`ResponseState` from a reference
    ``ResponseState`` whose fields are numpy arrays with a leading chain
    axis.  With fixed effects B and F are carried across plane-major; without
    them the reference's (1, 1) and (1,) placeholders map onto the port's."""
    field = _field_reader(state_np, True, dtype, device)
    b, f = field("b"), field("f")
    if b.shape[1:] != (1, 1):
        b, f = bf_planes_from_rows(b, f, dtype, device)
    return ResponseState(
        theta_u=field("theta_u"),
        sigma2=field("sigma2"),
        beta=field("beta"),
        value=field("value"),
        logdet=field("logdet"),
        quad=field("quad"),
        b=b,
        f=f,
        log_steps=field("log_steps"),
        accept=field("accept"),
        iteration=field("iteration", torch.int32),
    )


def latent_state_from_jax(state_np, dtype=None, device="cpu") -> LatentState:
    """The port's batched :class:`LatentState` from a reference
    ``LatentState`` whose fields are numpy arrays: one chain's state (a chain
    axis of 1 is added) or a vmapped batch with a leading chain axis."""
    batched = np.ndim(state_np.sigma2) == 1
    field = _field_reader(state_np, batched, dtype, device)
    b, f = bf_planes_from_rows(field("b"), field("f"), dtype, device)
    return LatentState(
        theta_u=field("theta_u"),
        sigma2=field("sigma2"),
        tau2=field("tau2"),
        beta=field("beta"),
        w=field("w"),
        value=field("value"),
        logdet=field("logdet"),
        quad_w=field("quad_w"),
        b=b,
        f=f,
        log_steps=field("log_steps"),
        accept=field("accept"),
        iteration=field("iteration", torch.int32),
    )


def _gradient_state(state_cls, info_cls, state_np, dtype, device):
    """A batched gradient-sampler state from the reference's, whose fields
    are numpy arrays: one chain's (a chain axis of 1 is added) or a vmapped
    batch.  ``z`` is the full unconstrained vector [log sigma2, logit phi,
    log tau2, beta...], the same in both packages.  Floating fields take
    ``dtype``; counters stay int32 and flags bool."""
    batched = np.ndim(state_np.value) == 1

    def leaf(a):
        a = np.asarray(a)
        a = a if batched else a[None]
        if a.dtype == np.bool_:
            dt = torch.bool
        elif np.issubdtype(a.dtype, np.integer):
            dt = torch.int32
        else:
            dt = dtype
        return torch.tensor(a, dtype=dt, device=device)

    def tree(node_np, cls):
        return cls(*(leaf(getattr(node_np, name)) for name in cls._fields))

    return state_cls(z=leaf(state_np.z), value=leaf(state_np.value),
                     grad=leaf(state_np.grad), da=tree(state_np.da, DualAveraging),
                     wf=tree(state_np.wf, Welford),
                     inv_mass=leaf(state_np.inv_mass),
                     iteration=leaf(state_np.iteration),
                     info=tree(state_np.info, info_cls))


def nuts_state_from_jax(state_np, dtype=None, device="cpu") -> NUTSState:
    """The port's batched :class:`NUTSState` from a reference ``NUTSState``."""
    return _gradient_state(NUTSState, NUTSInfo, state_np, dtype, device)


def hmc_state_from_jax(state_np, dtype=None, device="cpu") -> HMCState:
    """The port's batched :class:`HMCState` from a reference ``HMCState``."""
    return _gradient_state(HMCState, HMCInfo, state_np, dtype, device)


def smc_state_from_jax(state_np, dtype=None, device="cpu") -> SMCState:
    """The port's :class:`SMCState` from a reference ``SMCState`` whose fields
    are numpy arrays (the same fields, the particle axis leading)."""
    return SMCState(*(torch.tensor(np.asarray(getattr(state_np, name)), dtype=dtype,
                                   device=device) for name in SMCState._fields))


def advi_result_from_jax(res_np, dtype=None, device="cpu") -> ADVIResult:
    """The port's :class:`ADVIResult` from a reference ``ADVIResult`` whose
    arrays are numpy arrays."""
    field = lambda name: torch.tensor(np.asarray(getattr(res_np, name)), dtype=dtype,
                                      device=device)
    return ADVIResult(mu=field("mu"), log_sd=field("log_sd"),
                      chol_factor=field("chol_factor"), elbo_trace=field("elbo_trace"),
                      full_rank=bool(res_np.full_rank))
