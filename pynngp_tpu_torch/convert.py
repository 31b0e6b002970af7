"""Carries the reference package's state across to the port.  Inputs are
numpy arrays (the JAX arrays after ``np.asarray``), so this module needs no
JAX."""

from __future__ import annotations

import numpy as np
import torch

from pynngp_tpu_torch.models.response import ResponseState
from pynngp_tpu_torch.ops.site_tables import SiteTables, padded_size

__all__ = ["site_tables_from_lane_cache", "response_state_from_jax"]


def site_tables_from_lane_cache(tab_a, tab_b, nn_idx, n, device="cpu"):
    """Plane-major :class:`SiteTables` from the dist-layout ``LaneCache``
    arrays (``tab_a`` (m, S, 8, 128), ``tab_b`` (m(m-1)/2, S, 8, 128),
    ``nn_idx`` (m, S, 8, 128)) of a cache over n sites.  The tile padding
    beyond the port's block padding holds only zeros and is dropped."""
    n_pad = padded_size(n)

    def planes(a):
        a = np.asarray(a)
        flat = a.reshape(a.shape[0], -1)
        if flat.shape[1] < n_pad or np.any(flat[:, n:]):
            raise ValueError("not a dist-layout lane cache over n sites")
        return torch.as_tensor(np.ascontiguousarray(flat[:, :n_pad]),
                               device=device)

    return SiteTables(d_in=planes(tab_a), d_tri=planes(tab_b),
                      nn_idx=planes(np.asarray(nn_idx, np.int32)), n=n,
                      n_pad=n_pad)


def response_state_from_jax(state_np, dtype=None, device="cpu") -> ResponseState:
    """The port's batched :class:`ResponseState` from a reference
    ``ResponseState`` whose fields are numpy arrays with a leading chain
    axis.  The reference's fixed-effect fields (beta, B, F) carry nothing
    without fixed effects and are dropped."""

    def field(name, dt=dtype):
        return torch.tensor(np.asarray(getattr(state_np, name)), dtype=dt,
                            device=device)

    return ResponseState(
        theta_u=field("theta_u"),
        sigma2=field("sigma2"),
        value=field("value"),
        logdet=field("logdet"),
        quad=field("quad"),
        log_steps=field("log_steps"),
        accept=field("accept"),
        iteration=field("iteration", torch.int32),
    )
