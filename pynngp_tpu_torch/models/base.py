"""Shared model plumbing (counterpart of ``pynngp_tpu.models.base``): data
preparation, the host-chunked multi-chain MCMC driver and the reference's
two plain drivers, :func:`run_mcmc` (one state, no chunks) and
:func:`run_chains` (one chunk of the chunked driver).

The reference compiles a chunk of iterations into one ``lax.scan`` over a
vmap of chains.  Here the chains are the leading axis of one batched state
and the step loop runs eagerly: each step enqueues its kernels on the current
stream without waiting, and the host synchronises only where a metrics line
needs an honest time and at the end.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from pynngp_tpu_torch.priors import InverseGamma, Uniform
from pynngp_tpu_torch.utils import checkpoint
from pynngp_tpu_torch.utils.metrics import MetricsLogger
from pynngp_tpu_torch.vecchia import make_vecchia_data, require_device

__all__ = ["SpatialData", "check_device", "default_priors",
           "prepare_spatial_data", "run_chains", "run_chains_chunked", "run_mcmc"]


class SpatialData(NamedTuple):
    """Ordered data bundle shared by the models."""

    vecchia: object  # VecchiaData
    table: object  # NeighborTable (host)
    y: torch.Tensor  # (n,) ordered response
    x: Optional[torch.Tensor]  # (n, p) ordered covariates, or None


def check_device(device, dtype, mesh=None) -> torch.device:
    """The models' device rule: "cuda" (float32 only; raises without a card)
    or "cpu"; there is no automatic choice.  With a mesh the model lives on
    the mesh's first device, which must be of the type asked for."""
    device = torch.device(device)
    if mesh is not None:
        if mesh.first.type != device.type:
            raise ValueError(f"device={device} but the mesh starts on {mesh.first}")
        device = mesh.first
    if device.type == "cuda":
        require_device(device)
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


def _stack(draws):
    """A list of collect trees (tensors, dicts, tuples) as one tree of
    tensors stacked along a new leading axis."""
    first = draws[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(draws)
    if isinstance(first, dict):
        return {key: _stack([d[key] for d in draws]) for key in first}
    children = [_stack(list(col)) for col in zip(*draws)]
    return type(first)(*children) if hasattr(first, "_fields") else type(first)(children)


def run_mcmc(gen: torch.Generator, state, step_fn: Callable, collect_fn: Callable,
             n_samples: int, n_burn: int = 0, thin: int = 1):
    """Burn-in, then ``n_samples`` draws kept one every ``thin`` steps, on
    the device of ``state``.

    ``step_fn(gen, state) -> state``; ``collect_fn(state)`` returns a tensor
    or a dict or tuple of them, recorded per kept draw.  Returns (final
    state, draws) with the draws stacked along a leading (n_samples,) axis,
    as tensors (None when ``n_samples`` is 0)."""
    for _ in range(n_burn):
        state = step_fn(gen, state)
    draws = []
    for _ in range(n_samples):
        for _ in range(thin):
            state = step_fn(gen, state)
        draws.append(collect_fn(state))
    return state, (_stack(draws) if draws else None)


def run_chains(gen: torch.Generator, init_fn: Callable, step_fn: Callable,
               collect_fn: Callable, n_chains: int, n_samples: int,
               n_burn: int = 0, thin: int = 1):
    """:func:`run_chains_chunked` in one chunk, without checkpoints or
    metrics: the reference's monolithic driver.  Every random number comes
    from ``gen`` in the same order whatever the chunk, so its result is the
    chunked driver's bit for bit."""
    return run_chains_chunked(gen, init_fn, step_fn, collect_fn, n_chains,
                              n_samples, n_burn, thin,
                              chunk=max(n_burn, n_samples * thin, 1))


def _process_index():
    """This process's rank when ``torch.distributed`` runs more than one,
    else None: the reference's ``jax.process_index()`` rule (its
    ``models/base.py:180``)."""
    if (torch.distributed.is_available() and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        return torch.distributed.get_rank()
    return None


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
    checkpoint_path: str = None,
    checkpoint_every: int = 0,
    config=None,
    health_fn: Callable = None,
    progress_fn: Callable = None,
):
    """Host-chunked multi-chain MCMC driver.

    ``init_fn(n_chains)`` returns the batched state (leading chain axis),
    ``step_fn(gen, state)`` advances every chain by one iteration, and
    ``collect_fn(state)`` returns a dict of (C, ...) tensors recorded per
    retained draw.  Burn-in runs ``n_burn`` steps, then ``n_samples`` draws
    are kept, one every ``thin`` steps.  ``metrics`` is a MetricsLogger, a
    path (JSON lines appended to that file), or True (lines to stderr): one
    line per chunk of ``chunk`` iterations, with its time and rate and the
    fields of ``health_fn(state) -> dict`` when given.
    ``collect_every`` maps collect keys to a keep-every-k stride: those keys
    keep only draws with index i % k == 0.  Draws are kept on the device and
    copied to the host once.  ``progress_fn(phase, done, total)`` is called
    after every chunk: ``("burn", steps done, n_burn)``, then
    ``("sample", draws done, n_samples)``.

    Checkpoints: with ``checkpoint_path`` and ``checkpoint_every`` = K > 0,
    every K-th chunk saves the state and the generator's state
    (``<path>.npz``, ``<path>.json``) and, once draws are kept, the draws so
    far (``<path>.draws.npz``); with ``config`` (an NNGPConfig or a dict)
    the config goes into the descriptor and beside it as
    ``<path>.config.json``.  A run that finds ``<path>.npz`` resumes from it,
    and gives the draws of the run that was stopped bit for bit, since every
    random number comes from ``gen``.  The checkpoint records the run's
    n_chains, n_samples, n_burn, thin, chunk and collect_every; a resume
    whose values differ raises a ``ValueError`` naming the first that
    differs, and so does a ``config`` that differs from the stored one.
    When ``torch.distributed`` runs more than one process, each holds its
    own chains and generator and names its files by rank, as the
    reference does: ``<path>.p<rank>.npz``, ``.p<rank>.json`` and
    ``.p<rank>.draws.npz``; ``<path>.config.json`` stays one file, written
    by rank 0.

    Returns (final_state, draws) with draws as numpy (n_chains, n_draws, ...).
    """
    owned = None
    if metrics is True:
        metrics = MetricsLogger()
    elif isinstance(metrics, (str, os.PathLike)):
        owned = open(metrics, "a")
        metrics = MetricsLogger(stream=owned)
    run = {"n_chains": n_chains, "n_samples": n_samples, "n_burn": n_burn,
           "thin": thin, "chunk": chunk, "collect_every": dict(collect_every or {})}
    ckpt = (_Checkpoints(checkpoint_path, checkpoint_every, run, config, gen)
            if checkpoint_path else None)
    try:
        return _run(gen, init_fn, step_fn, collect_fn, run, metrics, ckpt,
                    health_fn, progress_fn)
    finally:
        if owned is not None:
            owned.close()


class _Checkpoints:
    """Saving and resuming a chunked run's progress at ``path`` (this
    process's files at ``own``)."""

    def __init__(self, path, every, run, config, gen):
        self.path, self.every, self.run = path, every, run
        self.config, self.gen = config, gen
        self.chunks = 0
        self.proc = _process_index()
        self.own = checkpoint.proc_path(path, self.proc)

    def resume(self, states):
        """(state, burn_done, draws_done, the draws so far as numpy
        (rows, C, ...) by key) from an existing checkpoint, or None."""
        if not os.path.exists(checkpoint.npz_path(self.own)):
            return None
        with open(checkpoint.meta_path(self.own)) as fh:
            extra = json.load(fh).get("extra", {})
        stored = extra.get("run", {})
        for key, want in self.run.items():
            if stored.get(key) != want:
                raise ValueError(
                    f"checkpoint {self.own} was written by a run with "
                    f"{key}={stored.get(key)!r}; this run has {key}={want!r}")
        states, gen_state = checkpoint.load_state(
            self.path, (states, self.gen.get_state()), config=self.config,
            process_index=self.proc)
        self.gen.set_state(gen_state)
        burn_done, draws_done = int(extra["burn_done"]), int(extra["draws_done"])
        prior = {}
        if draws_done:
            with np.load(self.own + ".draws.npz") as z:
                prior = {key: z[key] for key in z.files}
        return states, burn_done, draws_done, prior

    def chunk_done(self, states, burn_done, draws_done, buffers):
        """Count a finished chunk; every ``every``-th saves the draws kept so
        far (first, so that the state never runs ahead of them), then the
        state and its descriptor."""
        self.chunks += 1
        if not self.every or self.chunks % self.every:
            return
        if draws_done:
            stride = self.run["collect_every"]
            rows = {key: buf[:-(-draws_done // stride.get(key, 1))].cpu().numpy()
                    for key, buf in buffers.items()}
            checkpoint.write_atomic(self.own + ".draws.npz",
                                    lambda fh: np.savez(fh, **rows))
        checkpoint.save_state(
            self.path, (states, self.gen.get_state()),
            extra={"burn_done": burn_done, "draws_done": draws_done,
                   "run": self.run},
            config=self.config, process_index=self.proc)
        if self.config is not None and not self.proc:
            cfg = checkpoint.config_dict(self.config)
            checkpoint.write_atomic(
                self.path + ".config.json",
                lambda fh: fh.write(json.dumps(cfg, indent=2).encode()))


def _run(gen, init_fn, step_fn, collect_fn, run, metrics, ckpt, health_fn,
         progress_fn):
    n_samples, n_burn, thin = run["n_samples"], run["n_burn"], run["thin"]
    chunk, collect_every = run["chunk"], run["collect_every"]
    states = init_fn(run["n_chains"])
    it = got = 0
    prior = {}
    resumed = ckpt.resume(states) if ckpt is not None else None
    if resumed is not None:
        states, it, got, prior = resumed
        if metrics is not None:
            metrics.log("resume", burn_done=it, draws_done=got)

    def emit(phase, done, total, iters, t0):
        if metrics is None:
            return
        _synchronize(states)  # honest per-chunk timing costs one sync
        dt = time.perf_counter() - t0
        fields = health_fn(states) if health_fn is not None else {}
        metrics.log(phase, done=int(done), total=int(total),
                    seconds=round(dt, 3),
                    iters_per_sec=round(iters / dt, 3) if dt > 0 else None,
                    **fields)

    while it < n_burn:
        t0 = time.perf_counter()
        steps = min(chunk, n_burn - it)
        for _ in range(steps):
            states = step_fn(gen, states)
        it += steps
        if ckpt is not None:
            ckpt.chunk_done(states, it, 0, {})
        if progress_fn is not None:
            progress_fn("burn", it, n_burn)
        emit("burn", it, n_burn, steps, t0)

    buffers = {}

    def record(out, i):
        for key, val in out.items():
            stride = collect_every.get(key, 1)
            if key not in buffers:
                rows = -(-n_samples // stride)
                buffers[key] = torch.empty((rows,) + tuple(val.shape),
                                           dtype=val.dtype, device=val.device)
                if key in prior:  # the draws of a resumed run so far
                    done = prior[key]
                    buffers[key][:len(done)] = torch.from_numpy(done).to(val.device)
            if i % stride == 0:
                buffers[key][i // stride] = val

    draws_per_chunk = max(1, chunk // thin)
    while got < n_samples:
        t0 = time.perf_counter()
        todo = min(draws_per_chunk, n_samples - got)
        for _ in range(todo):
            for _ in range(thin):
                states = step_fn(gen, states)
            record(collect_fn(states), got)
            got += 1
        if ckpt is not None:
            ckpt.chunk_done(states, n_burn, got, buffers)
        if progress_fn is not None:
            progress_fn("sample", got, n_samples)
        emit("sample", got, n_samples, todo * thin, t0)
    # (n_draws, n_chains, ...) -> (n_chains, n_draws, ...), one copy per key;
    # a run resumed after its last draw returns the stored draws
    draws = {k: b.cpu().numpy() for k, b in buffers.items()} or prior
    return states, {k: np.swapaxes(v, 0, 1) for k, v in draws.items()}
