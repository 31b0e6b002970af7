"""Site and chain sharding over a (chains, sites) grid of devices — the
counterpart of ``pynngp_tpu.parallel.sharded``, under its public names.

Design.  One controller drives every device of a :class:`Mesh`.  The sites
axis cuts the plane-major site tables into column blocks
(``ops.site_tables.shard_site_tables``); each block's launches see the
global site index ``site + off`` (the kernels' ``off`` slot), so a shard's
per-site outputs are those of the unsharded launch, bit for bit.  The
chains axis splits a call's C chains into contiguous groups, one a row of
devices (``ops.site_tables.chain_groups``).  Launches on different devices,
made from one thread, run at the same time; the psum of the reference is a
float64 sum of the shards' partial sums on the mesh's first device, and its
all_gather a concatenation there.  The sampler's state stays on the first
device.  The vectors every shard gathers from (y, the noise weights) are
held whole on every device, as the reference replicates them: the m-sparse
dependence needs no halo (SURVEY.md section 5.7).

A device may appear more than once in a mesh: one card then runs several
shards in turn, which measures the cost of the partitioning without a
second card.

The likelihood, the B/F build and the gradients run on the hand-written
kernels through the sharded wrappers of ``ops/`` (the tables of a mesh are
:class:`~pynngp_tpu_torch.ops.site_tables.ShardedTables`); there is no
second, block-math path.  :func:`make_sharded_chromatic` is the reference's
site-sharded chromatic sweep of the latent model.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pynngp_tpu_torch.ops.bf import bf
from pynngp_tpu_torch.ops.diff_suffstats import diff_suffstats
from pynngp_tpu_torch.ops.site_tables import (
    ShardedTables,
    chain_groups,
    make_site_tables,
    shard_site_tables,
)
from pynngp_tpu_torch.vecchia import LOG_2PI, VecchiaData

__all__ = [
    "Mesh",
    "make_mesh",
    "pad_data_for_sharding",
    "shard_vecchia_data",
    "make_sharded_suffstats",
    "make_sharded_loglik",
    "make_sharded_bf",
    "shard_color_tables",
    "make_sharded_chromatic",
]


def _device(d) -> torch.device:
    """``d`` as a torch.device, a CUDA one with its index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A (chains, sites) grid of torch devices, the counterpart of the
    reference's ``jax.sharding.Mesh``: ``devices`` is a (chains, sites)
    object array, ``shape`` the reference's {"chains": ..., "sites": ...}."""

    axis_names = ("chains", "sites")

    def __init__(self, devices):
        grid = np.empty(np.shape(devices)[:2], dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = _device(devices[idx[0]][idx[1]])
        self.devices = grid
        self.shape = {"chains": grid.shape[0], "sites": grid.shape[1]}

    @property
    def first(self) -> torch.device:
        """The device of cell (0, 0): where the sampler's state and every
        gathered result live."""
        return self.devices[0, 0]

    def __repr__(self):
        return f"Mesh({self.shape}, devices={self.devices.tolist()})"


def make_mesh(n_chain_shards: int = 1, n_site_shards: Optional[int] = None,
              devices=None) -> Mesh:
    """The (chains, sites) mesh over ``devices``, by default every visible
    CUDA card.  A device may be listed more than once (several shards on one
    card).  ``n_site_shards`` defaults to ``len(devices) // n_chain_shards``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: torch sees no CUDA device; pass "
                               "devices=[...] (e.g. ['cpu', 'cpu'])")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    nd = len(devices)
    if n_site_shards is None:
        n_site_shards = nd // n_chain_shards
    if n_chain_shards < 1 or n_site_shards < 1 or n_chain_shards * n_site_shards != nd:
        raise ValueError(f"mesh {n_chain_shards}x{n_site_shards} != {nd} devices")
    return Mesh([devices[r * n_site_shards:(r + 1) * n_site_shards]
                 for r in range(n_chain_shards)])


def pad_data_for_sharding(data: VecchiaData, n_shards: int):
    """Pad the site axis of ``data`` to a multiple of ``n_shards`` with
    fully masked rows; returns (padded data, (n_pad,) bool validity).

    Padded rows have no neighbors (B = 0, F = 1 + alpha) and are left out of
    the sums by the validity vector."""
    n = data.n
    extra = (-n) % n_shards
    if extra == 0:
        return data, torch.ones((n,), dtype=torch.bool, device=data.coords.device)

    def pad(a, value=0):
        if a is None:
            return None
        widths = [(0, extra)] + [(0, 0)] * (a.ndim - 1)
        if isinstance(a, np.ndarray):
            return np.pad(a, widths, constant_values=value)
        flat = [w for pair in reversed(widths) for w in pair]
        return torch.nn.functional.pad(a, flat, value=value)

    padded = VecchiaData(
        coords=pad(data.coords),
        nn_idx=pad(data.nn_idx),
        nn_mask=pad(data.nn_mask, False),
        nn_dist=pad(data.nn_dist),
        nn_cross_dist=pad(data.nn_cross_dist),
    )
    valid = torch.cat([torch.ones((n,), dtype=torch.bool),
                       torch.zeros((extra,), dtype=torch.bool)]).to(data.coords.device)
    return padded, valid


def shard_vecchia_data(data: VecchiaData, mesh: Mesh, y=None, layout: str = "dist",
                       coords_host=None):
    """The per-site tables of ``data`` cut over the mesh's sites axis and
    placed on its devices, and the vectors gathered from held whole.

    Returns (tables, y_own, y_full, valid): ``tables`` the
    :class:`ShardedTables` every ``make_sharded_*`` function takes in the
    reference's ``data`` argument; ``y_own`` y padded to the tables' n_pad,
    ``y_full`` y itself and ``valid`` the (n_pad,) validity, on the mesh's
    first device (None without y; valid always).  ``layout`` and
    ``coords_host`` are ``make_site_tables``'s."""
    sites = mesh.shape["sites"]
    tables = make_site_tables(data, dtype=data.coords.dtype, device=mesh.first,
                              layout=layout, coords_host=coords_host, shards=sites)
    sharded = shard_site_tables(tables, mesh)
    valid = torch.arange(tables.n_pad, device=mesh.first) < tables.n
    y_own = y_full = None
    if y is not None:
        y_full = torch.as_tensor(y, device=mesh.first)
        y_own = torch.nn.functional.pad(y_full, (0, tables.n_pad - tables.n))
    return sharded, y_own, y_full, valid


def _check_tables(data, mesh: Mesh) -> ShardedTables:
    if not isinstance(data, ShardedTables):
        raise TypeError("pass the tables of shard_vecchia_data (ShardedTables)")
    if (len(data.cells), len(data.cells[0])) != (mesh.shape["chains"],
                                                 mesh.shape["sites"]):
        raise ValueError(f"the tables were cut for another mesh than {mesh.shape}")
    return data


def make_sharded_suffstats(kernel, mesh: Mesh, jitter: float = 1e-6,
                           hetero: bool = False):
    """fn(params, alpha, data, y_own, y_full, valid[, v_own, v_full]) ->
    (logdet, quad) per chain, computed shard by shard on the mesh (kernel 1,
    or kernel 2 where a gradient is taken: ``ops.diff_suffstats``) and summed
    on its first device.

    ``params`` is the reference's dict, {"phi": (C,)} and "nu" for a kernel
    that samples it; ``data`` the tables of :func:`shard_vecchia_data`.
    Each shard reads its own sites' y (and v) from ``y_full`` (``v_full``) at
    their global index and takes its validity from n, so ``y_own``,
    ``valid`` and ``v_own`` are accepted for the reference's signature and
    not read."""

    def fn(params, alpha, data, y_own, y_full, valid, *v):
        tables = _check_tables(data, mesh)
        noise_v = v[1] if hetero else None
        phi = torch.as_tensor(params["phi"], device=tables.device)
        return diff_suffstats(kernel, tables, phi, alpha, y_full, jitter,
                              params.get("nu"), noise_v)

    return fn


def make_sharded_loglik(kernel, mesh: Mesh, n: int, jitter: float = 1e-6,
                        hetero: bool = False):
    """Per-chain response-model log-likelihood over the mesh:
    fn(params, sigma2, alpha, data, y_own, y_full, valid[, v_own, v_full]);
    ``n`` the true site count."""
    suff = make_sharded_suffstats(kernel, mesh, jitter, hetero=hetero)

    def fn(params, sigma2, alpha, data, y_own, y_full, valid, *v):
        logdet, quad = suff(params, alpha, data, y_own, y_full, valid, *v)
        sigma2 = torch.as_tensor(sigma2, dtype=logdet.dtype, device=logdet.device)
        return -0.5 * (n * (LOG_2PI + torch.log(sigma2)) + logdet + quad / sigma2)

    return fn


def make_sharded_bf(kernel, mesh: Mesh, n: int, jitter: float = 1e-6,
                    hetero: bool = False):
    """Site-sharded B/F build (kernel 3 a shard): fn(params, alpha, data[,
    v_own, v_full]) -> (B (C, n, m), F (C, n)), the shards' rows joined on
    the mesh's first device."""

    def fn(params, alpha, data, *v):
        tables = _check_tables(data, mesh)
        if tables.n != n:
            raise ValueError(f"the tables hold {tables.n} sites, not {n}")
        noise_v = v[1] if hetero else None
        phi = torch.as_tensor(params["phi"], device=tables.device)
        return bf(kernel, tables, phi, alpha, jitter, params.get("nu"), noise_v)

    return fn


def shard_color_tables(colors: np.ndarray, n_shards: int):
    """Partition each colour class round-robin across shards (on the host,
    once).  Returns (sites, mask): (n_shards, n_colors, msz) int32 global
    site ids and bool validity, padded so that every shard sweeps the same
    shape.  Any balanced partition is correct: sites of one colour are
    conditionally independent by the moral colouring."""
    n_colors = int(colors.max()) + 1
    groups = [np.nonzero(colors == c)[0] for c in range(n_colors)]
    msz = max(max((len(g) + n_shards - 1) // n_shards for g in groups), 1)
    sites = np.zeros((n_shards, n_colors, msz), np.int32)
    mask = np.zeros((n_shards, n_colors, msz), bool)
    for c, g in enumerate(groups):
        for s in range(n_shards):
            part = g[s::n_shards]
            sites[s, c, :len(part)] = part
            mask[s, c, :len(part)] = True
    return sites, mask


def make_sharded_chromatic(mesh: Mesh, n_colors: int):
    """Site-sharded exact chromatic Gibbs sweep of the latent-w model.

    Returns fn(csites, csmask, w, resid, eps, child_idx, b_child, fp_child,
    v, sd, ytil, fprec) -> the new w (C, n), with the reference's arguments
    and a leading chain axis C on every per-chain array: w, resid, eps, v,
    sd, ytil, fprec (C, n); b_child, fp_child (C, n, max_c); child_idx
    (n, max_c); csites, csmask the (S, n_colors, msz) tables of
    :func:`shard_color_tables`.

    Each cell (g, s) of the mesh updates shard s's partition of every colour
    for the chains of row g, on its device, from the same pre-colour (w,
    resid).  The deltas of one colour do not collide (each child has one
    parent in a colour, and children are never of its colour), so adding
    every cell's deltas to the state on the first device in any order gives
    the single-device sweep: the psum of the reference, without a dense
    (2, n) buffer.  Given the same ``eps`` this is the reference's sweep up
    to rounding."""
    rows, cols = mesh.shape["chains"], mesh.shape["sites"]

    def fn(csites, csmask, w, resid, eps, child_idx, b_child, fp_child, v, sd,
           ytil, fprec):
        home = w.device
        csites = torch.as_tensor(csites).to(home, torch.int64)
        csmask = torch.as_tensor(csmask).to(home, w.dtype)
        if csites.shape[:2] != (cols, n_colors):
            raise ValueError(f"colour tables {tuple(csites.shape)} do not match "
                             f"{cols} site shards and {n_colors} colours")
        w, resid = w.clone(), resid.clone()
        cells = []
        for g, chains in chain_groups(w.shape[0], rows):
            for s in range(cols):
                dev = mesh.devices[g, s]
                cs = csites[s]  # (n_colors, msz)
                per_site = lambda a: a[chains][:, cs].to(dev)  # (Cg, n_colors, msz, ...)
                cells.append(dict(
                    chains=chains, dev=dev, sites=cs, smask=csmask[s].to(dev),
                    ci=child_idx[cs].to(dev), bc=per_site(b_child),
                    fp=per_site(fp_child), v=per_site(v), sd=per_site(sd),
                    eps=per_site(eps), ytil=per_site(ytil), fprec=per_site(fprec)))
        for c in range(n_colors):
            updates = []
            for x in cells:
                dev, sites, ci = x["dev"], x["sites"][c].to(x["dev"]), x["ci"][c]
                w_d, r_d = w[x["chains"]].to(dev), resid[x["chains"]].to(dev)
                w_s = w_d[:, sites]
                mu_own = w_s - r_d[:, sites]  # B_i . w_N(i) under the current w
                bc = x["bc"][:, c]  # (Cg, msz, max_c)
                resid_excl = r_d[:, ci] + bc * w_s[..., None]
                rhs = (x["ytil"][:, c] + mu_own * x["fprec"][:, c]
                       + (bc * x["fp"][:, c] * resid_excl).sum(-1))
                w_new = x["v"][:, c] * rhs + x["sd"][:, c] * x["eps"][:, c]
                delta = (w_new - w_s) * x["smask"][c]  # pad slots add 0
                child = (-bc * delta[..., None]).reshape(delta.shape[0], -1)
                updates.append((x["chains"], x["sites"][c], delta.to(home),
                                ci.reshape(-1).to(home), child.to(home)))
            for chains, sites, delta, ci, child in updates:
                w[chains].index_add_(1, sites, delta)
                r = resid[chains]
                r.index_add_(1, sites, delta)
                r.index_add_(1, ci, child)
        return w

    return fn
