"""Shared model plumbing (counterpart of ``pynngp_tpu.models.base``): data
preparation and the host-chunked multi-chain MCMC driver.

The reference compiles a chunk of iterations into one ``lax.scan`` over a
vmap of chains.  Here the chains are the leading axis of one batched state
and the step loop runs eagerly: each step enqueues its kernels on the current
stream without waiting, and the host synchronises only where a metrics line
needs an honest time and at the end.
"""

from __future__ import annotations

import os
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from pynngp_tpu_torch.priors import InverseGamma, Uniform
from pynngp_tpu_torch.utils.metrics import MetricsLogger
from pynngp_tpu_torch.vecchia import make_vecchia_data

__all__ = ["SpatialData", "check_device", "default_priors",
           "prepare_spatial_data", "run_chains_chunked"]


class SpatialData(NamedTuple):
    """Ordered data bundle shared by the models."""

    vecchia: object  # VecchiaData
    table: object  # NeighborTable (host)
    y: torch.Tensor  # (n,) ordered response
    x: Optional[torch.Tensor]  # (n, p) ordered covariates, or None


def check_device(device, dtype) -> torch.device:
    """The models' device rule: "cuda" (float32 only; raises without a card)
    or "cpu"; there is no automatic choice."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch sees no CUDA device")
        if dtype != torch.float32:
            raise ValueError("the CUDA kernels run in float32")
    elif device.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device}")
    return device


def default_priors(coords, y, priors: Optional[dict] = None) -> dict:
    """Data-informed default priors of both models, overridden by ``priors``."""
    coords = np.asarray(coords)
    span = float(np.max(coords.max(0) - coords.min(0))) if coords.size else 1.0
    var_y = float(np.var(np.asarray(y))) or 1.0
    out = {
        "sigma2": InverseGamma(2.0, var_y),
        "tau2": InverseGamma(2.0, 0.1 * var_y),
        "phi": Uniform(1e-3 * span, 2.0 * span),
        "nu": Uniform(0.1, 3.0),  # read by a kernel that samples nu only
        "beta_scale": 100.0,
    }
    out.update(priors or {})
    return out


def prepare_spatial_data(coords, y, m, x=None, ordering="coordinate",
                         distance="euclidean", dtype=torch.float32,
                         device="cpu", precompute_distances=True):
    coords = np.asarray(coords)
    data, table = make_vecchia_data(coords, m, ordering=ordering,
                                    distance=distance, dtype=dtype,
                                    device=device,
                                    precompute_distances=precompute_distances)
    y_ord = torch.as_tensor(np.asarray(y)[table.order], dtype=dtype,
                            device=device)
    x_ord = None
    if x is not None:
        x = np.asarray(x)
        if x.ndim != 2 or x.shape[0] != coords.shape[0]:
            raise ValueError(f"x must be (n, p) with n={coords.shape[0]}, got "
                             f"{x.shape}")
        x_ord = torch.as_tensor(x[table.order], dtype=dtype, device=device)
    return SpatialData(data, table, y_ord, x_ord)


def _synchronize(states) -> None:
    """Wait for the device work behind a state (no-op on the CPU)."""
    for t in states:
        if isinstance(t, torch.Tensor):
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            return


def run_chains_chunked(
    gen: torch.Generator,
    init_fn: Callable,
    step_fn: Callable,
    collect_fn: Callable,
    n_chains: int,
    n_samples: int,
    n_burn: int = 0,
    thin: int = 1,
    chunk: int = 256,
    metrics=None,
    collect_every: dict = None,
):
    """Host-chunked multi-chain MCMC driver.

    ``init_fn(n_chains)`` returns the batched state (leading chain axis),
    ``step_fn(gen, state)`` advances every chain by one iteration, and
    ``collect_fn(state)`` returns a dict of (C, ...) tensors recorded per
    retained draw.  Burn-in runs ``n_burn`` steps, then ``n_samples`` draws
    are kept, one every ``thin`` steps.  ``metrics`` is a MetricsLogger, a
    path (JSON lines appended to that file), or True (lines to stderr): one
    line per chunk of ``chunk`` iterations, with its time and rate.
    ``collect_every`` maps collect keys to a keep-every-k stride: those keys
    keep only draws with index i % k == 0.  Draws are kept on the device and
    copied to the host once.

    Returns (final_state, draws) with draws as numpy (n_chains, n_draws, ...).
    """
    owned = None
    if metrics is True:
        metrics = MetricsLogger()
    elif isinstance(metrics, (str, os.PathLike)):
        owned = open(metrics, "a")
        metrics = MetricsLogger(stream=owned)
    try:
        return _run(gen, init_fn, step_fn, collect_fn, n_chains, n_samples,
                    n_burn, thin, chunk, metrics, collect_every or {})
    finally:
        if owned is not None:
            owned.close()


def _run(gen, init_fn, step_fn, collect_fn, n_chains, n_samples, n_burn, thin,
         chunk, metrics, collect_every):
    states = init_fn(n_chains)

    def emit(phase, done, total, iters, t0):
        if metrics is None:
            return
        _synchronize(states)  # honest per-chunk timing costs one sync
        dt = time.perf_counter() - t0
        metrics.log(phase, done=int(done), total=int(total),
                    seconds=round(dt, 3),
                    iters_per_sec=round(iters / dt, 3) if dt > 0 else None)

    it = 0
    while it < n_burn:
        t0 = time.perf_counter()
        steps = min(chunk, n_burn - it)
        for _ in range(steps):
            states = step_fn(gen, states)
        it += steps
        emit("burn", it, n_burn, steps, t0)

    buffers = {}

    def record(out, i):
        for key, val in out.items():
            stride = collect_every.get(key, 1)
            if i % stride:
                continue
            if key not in buffers:
                rows = -(-n_samples // stride)
                buffers[key] = torch.empty((rows,) + tuple(val.shape),
                                           dtype=val.dtype, device=val.device)
            buffers[key][i // stride] = val

    got = 0
    draws_per_chunk = max(1, chunk // thin)
    while got < n_samples:
        t0 = time.perf_counter()
        todo = min(draws_per_chunk, n_samples - got)
        for _ in range(todo):
            for _ in range(thin):
                states = step_fn(gen, states)
            record(collect_fn(states), got)
            got += 1
        emit("sample", got, n_samples, todo * thin, t0)
    # (n_draws, n_chains, ...) -> (n_chains, n_draws, ...), one copy per key
    draws = {k: np.swapaxes(b.cpu().numpy(), 0, 1) for k, b in buffers.items()}
    return states, draws
