"""Smoke run of pynngp_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``pynngp_tpu_torch/csrc``, holds each against
its plain PyTorch version, times both, then drives every ported path once and
checks that it went through its kernels:

- the response NNGP at n=100,000, m=15, sqexp, as ``bench.py``'s ``bench_ess``
  MWG branch runs it, its run cut to half (kernels 1 and 2);
- the latent-w NNGP at n=10,000, m=15, exponential, 8 chains, as ``bench.py``'s
  config 2 runs it at half its draws, and a short run of the same model at
  n=100,000 (kernel 3);
- the response NNGP with an intercept and one covariate at n=100,000, 16
  chains (kernel 3);
- NUTS over the joint posterior of the first model, as ``bench.py``'s
  ``bench_ess`` NUTS branch runs it at half its draws (fit_map, then 4
  chains with the dense Laplace metric; kernel 2 on every leapfrog step),
  and a short HMC run;
- NUTS with the intercept and the covariate (the EMIT_Y instances of kernel
  2 and the y-cotangent gather on every leapfrog step);
- ``bench.py``'s config 3, uncut: the response NNGP with a sampled-nu Matern
  at n=25,000, m=10 on a Matern(nu=1.2) NNGP prior draw, fit_map(300), then
  NUTS over (sigma2, phi, tau2, nu) (kernel 2's general-nu instances, the
  Bessel K_nu evaluated inside the kernel);
- the same model's MWG sampler with the theta block (phi, alpha, nu) (kernel
  1's general-nu instances), a short NUTS run with fixed effects and a
  sampled nu (kernel 2's general-nu EMIT_Y instances), and the latent-w NNGP
  with ``Matern()`` on the first 10,000 sites (kernel 3's general-nu
  instances);
- on the coords table layout (every distance recomputed in the kernels from
  coordinate planes): ``bench.py``'s config 5 probe (``bench_setup500k``,
  uncut: set-up phases and 50 log-likelihood evaluations at n=500,000, m=20),
  the response NNGP at that size on coords (bench_ess's MWG
  recipe cut, and a short NUTS run), its fixed effects (``fit_map(x=)``), the
  latent-w NNGP at that size, and config 3's model with
  ``lane_layout="coords"`` against the dist layout (kernels 1 and 2's
  general-nu coords instances, with fixed effects kernel 2's EMIT_Y and
  kernel 3's).

- with heterogeneous (per-site) noise, v ~ U(0.25, 4): the response NNGP on
  the main path's data (bench_ess's MWG recipe, run cut), with fixed effects
  (MWG and NUTS), and the latent-w NNGP at config 2's size, with and without
  fixed effects (the V^-1-weighted beta update).

Before the paths: every coords instance against its plain version, both
layouts timed on the same sites at n=100,000 (m=15) and 500,000 (m=20), and
each layout's host set-up (seconds, table sizes, peak host memory) at those
sizes, run in the background beside the kernel phases, from which the
layout rule is printed (``site_tables.COORDS_LAYOUT_MIN_SITES``);
every instance launched with noise weights (``..._hetero``) against its
plain version and timed, the coords instances with d = 4, m = 12 and
m = 17 run on the M = 15 and M = 20 instances against their plain versions
and timed against those instances' own m, and m = 25 and m = 32 on the
rolled instances of all three kernels, both layouts, and m = 40 and m = 64
on their large-m instances (each kernel a warp a (site, chain) system in
shared memory), both layouts, with and without noise weights, closed form
and sampled nu, with the three kernels also on their cluster body (a
thread-block cluster a (site, chain) system, its factor spread over the
blocks' shared memory) at the first m of each cluster size and at
geometry.M_CLUSTER, both layouts, closed form and sampled nu, with and
without noise weights, and timed at each kernel's first m there
(geometry.M_SMEM + 1 for kernels 1 and 3, geometry.M_SMEM_GRAD + 1 for
kernel 2); the three kernels at m = geometry.M_CLUSTER + 1 on the scratch
body (one thread a (site, chain), its state in a scratch buffer); and the
factor-only yardstick (``torch.linalg.cholesky_ex`` on the
m = 64 correlation batch, and on each cluster and scratch row's batch as
that row's library_ms).
After the build it prints the registers, stack, shared bytes and warps an
SM of every tile instance of the three kernels (a block of up to four
chains, one warp each, over a 32-site tile staged in shared memory) and of
the three kernels' shared-memory bodies.  After the paths above, both models at m = 40 on config 2's field,
through the large-m instances, and the response model's MAP at m = 240
(kernel 2's cluster body); then ``bench.py``'s config 4, uncut (tempered
SMC with 512 particles at n=50,000, m=10: kernel 1 at 512 chains, held to its
plain version at that launch and timed beside its bound), ADVI on the first
model (kernel 2 at eight points a step, mean-field and full rank), and an
interrupt and resume of MWG, NUTS and the latent model from the checkpoints of
``run_chains_chunked``, each equal to its uninterrupted run bit for bit.
Last, slice 10's four: prediction at 10,000 new sites from the main path's
draws through the ``SeqNNGP`` facade (``torch.linalg`` on the card), the
facade's defaults end to end (the latent model on config 2's field, sample,
summary, predict), the max-min and natural orderings at n=100,000, and the
dot-product distance on 20,000 sites of the sphere (kernels 1-3 on its
dissimilarity tables, MWG, prediction, and the neighbor-table cache).
Then the three of sharding: the shard offset of every kernel (path 27: its
cases, the three kernels on their cluster body among them, each on meshes
(1, 2), (1, 4) and (2, 2) of cuda:0, per-site outputs bit for bit against
the unsharded launch), config 5 on a (1, 4) mesh of
cuda:0 through both models' ``mesh=`` (path 28), and two processes on gloo
sharing the card, the chains split across them (path 29).

Each path starts with every launch count at 0.  Any failure exits non-zero.
Without a CUDA device it exits 1 and prints no result.  The line before the
last lists the kernels; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from pynngp_tpu_torch import bessel, diagnostics, neighbors
from pynngp_tpu_torch.kernels import Exponential, Matern, SqExp
from pynngp_tpu_torch.models.latent import LatentNNGP
from pynngp_tpu_torch.models.response import ResponseNNGP
from pynngp_tpu_torch.models.seq import SeqNNGP
from pynngp_tpu_torch.noise import HeterogeneousNoise
from pynngp_tpu_torch.ops import _build, geometry
from pynngp_tpu_torch.ops import bf as bf_ops
from pynngp_tpu_torch.ops import diff_suffstats as diff_ops
from pynngp_tpu_torch.ops import suffstats as fwd_ops
from pynngp_tpu_torch.neighbors import build_neighbor_table
from pynngp_tpu_torch.ops import site_tables
from pynngp_tpu_torch.ops.site_tables import (
    LAYOUTS,
    make_site_tables,
    shard_site_tables,
    unpack_distances,
    with_children,
)
from pynngp_tpu_torch.parallel import make_mesh
from pynngp_tpu_torch.predict import build_prediction_table, predict_draws
from pynngp_tpu_torch.samplers import smc, vi
from pynngp_tpu_torch.samplers.nuts import make_nuts_kernel
from pynngp_tpu_torch.vecchia import conditional_system, make_vecchia_data

N_MAIN, M_MAIN, CHAINS = 100_000, 15, 16
TAU2_TRUE = 0.09  # the generator's noise variance, 0.3^2
KERNEL_ROWS = {
    "vecchia_suffstats": ("pynngp_tpu_torch/csrc/vecchia_suffstats.cu",
                          "pynngp_tpu/ops/pallas_bf.py:409", fwd_ops.COUNT),
    "vecchia_grad": ("pynngp_tpu_torch/csrc/vecchia_grad.cu",
                     "pynngp_tpu/ops/pallas_bf.py:727", diff_ops.COUNT),
    "vecchia_bf": ("pynngp_tpu_torch/csrc/vecchia_bf.cu",
                   "pynngp_tpu/ops/pallas_bf.py:941", bf_ops.COUNT),
    # the emit_y branch of _grad_kernel
    "vecchia_grad_y": ("pynngp_tpu_torch/csrc/vecchia_grad_y.cu",
                       "pynngp_tpu/ops/pallas_bf.py:857", diff_ops.COUNT_Y),
    # the general-nu Matern instances of the same three kernels: the
    # _matern_rho_general branch of _rho_fn, the with_nu contractions of
    # _grad_kernel (also with emit_y), _bf_kernel reading nu
    "vecchia_suffstats_nu": ("pynngp_tpu_torch/csrc/vecchia_suffstats_nu.cu",
                             "pynngp_tpu/ops/pallas_bf.py:338", fwd_ops.COUNT_NU),
    "vecchia_grad_nu": ("pynngp_tpu_torch/csrc/vecchia_grad_nu.cu",
                        "pynngp_tpu/ops/pallas_bf.py:812", diff_ops.COUNT_NU),
    "vecchia_grad_y_nu": ("pynngp_tpu_torch/csrc/vecchia_grad_y_nu.cu",
                          "pynngp_tpu/ops/pallas_bf.py:1107", diff_ops.COUNT_Y_NU),
    "vecchia_bf_nu": ("pynngp_tpu_torch/csrc/vecchia_bf_nu.cu",
                      "pynngp_tpu/ops/pallas_bf.py:949", bf_ops.COUNT_NU),
    # the coords-layout instances of all eight: the coords branch of
    # _dist_access (l.377) where each kernel body calls it
    "vecchia_suffstats_coords": ("pynngp_tpu_torch/csrc/vecchia_suffstats_coords.cu",
                                 "pynngp_tpu/ops/pallas_bf.py:437", fwd_ops.COUNT_COORDS),
    "vecchia_grad_coords": ("pynngp_tpu_torch/csrc/vecchia_grad_coords.cu",
                            "pynngp_tpu/ops/pallas_bf.py:752", diff_ops.COUNT_COORDS),
    "vecchia_bf_coords": ("pynngp_tpu_torch/csrc/vecchia_bf_coords.cu",
                          "pynngp_tpu/ops/pallas_bf.py:957", bf_ops.COUNT_COORDS),
    "vecchia_grad_y_coords": ("pynngp_tpu_torch/csrc/vecchia_grad_y_coords.cu",
                              "pynngp_tpu/ops/pallas_bf.py:752", diff_ops.COUNT_Y_COORDS),
    "vecchia_suffstats_nu_coords": ("pynngp_tpu_torch/csrc/vecchia_suffstats_nu_coords.cu",
                                    "pynngp_tpu/ops/pallas_bf.py:437",
                                    fwd_ops.COUNT_NU_COORDS),
    "vecchia_grad_nu_coords": ("pynngp_tpu_torch/csrc/vecchia_grad_nu_coords.cu",
                               "pynngp_tpu/ops/pallas_bf.py:752", diff_ops.COUNT_NU_COORDS),
    "vecchia_grad_y_nu_coords": ("pynngp_tpu_torch/csrc/vecchia_grad_y_nu_coords.cu",
                                 "pynngp_tpu/ops/pallas_bf.py:752",
                                 diff_ops.COUNT_Y_NU_COORDS),
    "vecchia_bf_nu_coords": ("pynngp_tpu_torch/csrc/vecchia_bf_nu_coords.cu",
                             "pynngp_tpu/ops/pallas_bf.py:957", bf_ops.COUNT_NU_COORDS),
}
# the same sixteen instances launched with per-site noise weights (the hetero
# branch of each Pallas body), counted apart
_HETERO_LINES = {"suffstats": 430, "grad": 743, "bf": 951}
_COUNTS = {**fwd_ops.COUNTS, **diff_ops.COUNTS, **bf_ops.COUNTS}
KERNEL_ROWS.update({
    name + "_hetero": (src, f"pynngp_tpu/ops/pallas_bf.py:{_HETERO_LINES[name.split('_')[1]]}",
                       _COUNTS[name + "_hetero"])
    for name, (src, _, _) in list(KERNEL_ROWS.items())
})
# the large-m instance of every source, with and without noise weights (m >
# 32: a warp a (site, chain) system in shared memory, up to geometry.M_SMEM
# for kernels 1 and 3 and geometry.M_SMEM_GRAD for kernel 2; the large-m
# branch of each Pallas body is the body itself at a static m), counted apart
KERNEL_ROWS.update({
    name.removesuffix("_hetero") + "_large" + ("_hetero" if name.endswith("_hetero") else ""): (
        "pynngp_tpu_torch/csrc/" + ("vecchia_grad_smem.cuh" if name.startswith("vecchia_grad")
                                    else "vecchia_large_smem.cuh"), tpu,
        _COUNTS[name.removesuffix("_hetero") + "_large"
                + ("_hetero" if name.endswith("_hetero") else "")])
    for name, (_, tpu, _) in list(KERNEL_ROWS.items())
})
# the M = 20 team bodies (csrc/vecchia_team.cuh): kernels 1, 2, 2-EMIT_Y
# and 3 on coords and kernels 2 and 2-EMIT_Y on dist at 15 < m <= 20,
# closed-form rho, counted in fwd_ops.COUNTS_M20 beside their instances'
# counts (every launch of the body); timed at config 5's n=500,000, m=20,
# 16 chains, and kernel 2 also at 4 chains (the NUTS recipe's launch: the
# same body, its own time, bound and error, and its own count, the body's
# launches of four chains).  Kernels 1 and 3 on dist keep a lane a (site,
# chain) at M = 20 (LANE_KEPT_M20).
_TEAM_SRC = "pynngp_tpu_torch/csrc/vecchia_team.cuh"
M20_ROWS = {
    "vecchia_suffstats_coords_m20": "pynngp_tpu/ops/pallas_bf.py:437",
    "vecchia_grad_m20": "pynngp_tpu/ops/pallas_bf.py:727",
    "vecchia_grad_coords_m20": "pynngp_tpu/ops/pallas_bf.py:752",
    "vecchia_grad_y_m20": "pynngp_tpu/ops/pallas_bf.py:857",
    "vecchia_grad_y_coords_m20": "pynngp_tpu/ops/pallas_bf.py:752",
    "vecchia_bf_coords_m20": "pynngp_tpu/ops/pallas_bf.py:957",
}
# the M = 20 instances kept on a lane a (site, chain), and their teams of 2
# as the card timed them (tools/time_trees.py --m20 over teams of 2, 4 and
# 8 and the lane body, n=500,000, m=20, sqexp, 16 chains; NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md): printed beside this run's lane time
LANE_KEPT_M20 = {"vecchia_suffstats": 3.0119, "vecchia_bf": 3.1224}
M20_FOUR = {"vecchia_grad_m20_4_chains": "vecchia_grad_m20",
            "vecchia_grad_coords_m20_4_chains": "vecchia_grad_coords_m20"}
_COUNTS.update(fwd_ops.COUNTS_M20)
KERNEL_ROWS.update({name: (_TEAM_SRC, tpu, _COUNTS[name]) for name, tpu in M20_ROWS.items()})
KERNEL_ROWS.update({name: (_TEAM_SRC, M20_ROWS[row], _COUNTS[name])
                    for name, row in M20_FOUR.items()})
# the cluster body (a thread-block cluster a (site, chain) system) of
# kernels 1 and 3 (geometry.M_SMEM < m <= geometry.M_CLUSTER) and of kernel
# 2 and 2-EMIT_Y (geometry.M_SMEM_GRAD < m <= geometry.M_CLUSTER_GRAD),
# every source, counted apart; and the scratch body above them on the
# closed-form dist sources (the launches of scratch_body_check)
CLUSTER_ROWS = {name + "_large_cluster": name for name in (
    "vecchia_suffstats", "vecchia_suffstats_nu", "vecchia_suffstats_coords",
    "vecchia_suffstats_nu_coords", "vecchia_bf", "vecchia_bf_nu", "vecchia_bf_coords",
    "vecchia_bf_nu_coords", "vecchia_grad", "vecchia_grad_nu", "vecchia_grad_coords",
    "vecchia_grad_nu_coords", "vecchia_grad_y", "vecchia_grad_y_nu", "vecchia_grad_y_coords",
    "vecchia_grad_y_nu_coords")}
SCRATCH_ROWS = {"vecchia_suffstats_large_scratch": "vecchia_suffstats",
                "vecchia_bf_large_scratch": "vecchia_bf",
                "vecchia_grad_large_scratch": "vecchia_grad",
                "vecchia_grad_y_large_scratch": "vecchia_grad_y"}
KERNEL_ROWS.update({row: ("pynngp_tpu_torch/csrc/" + ("vecchia_grad_cluster.cuh"
                                                      if name.startswith("vecchia_grad")
                                                      else "vecchia_large_cluster.cuh"),
                          KERNEL_ROWS[name][1], _COUNTS[row])
                    for row, name in CLUSTER_ROWS.items()})
KERNEL_ROWS.update({row: ("pynngp_tpu_torch/csrc/vecchia_large_m.cuh", KERNEL_ROWS[name][1],
                          _COUNTS[row]) for row, name in SCRATCH_ROWS.items()})
# every row's launches in calls over several cells of a mesh (slice 11),
# counted apart and added to the row's launches
SHARDED = {name: _COUNTS[name + "_sharded"] for name in KERNEL_ROWS}
N_NU, M_NU = 25_000, 10  # bench.py's config 3
# Published peaks of one H100 SXM: device memory rate, float32 rate outside
# the tensor cores, and the special-function rate that follows from it (an SM
# issues 16 special-function operations a clock against 128 FMAs, so
# 67e12 / 2 / 8).
PEAK_BYTES, PEAK_FLOPS, PEAK_SFU = 3.35e12, 67e12, 67e12 / 16


class SmokeFailure(RuntimeError):
    pass


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def bench_field(n: int, seed: int = 0, noise_v=None):
    """bench.py's bench_ess generator: an RFF draw from a sqexp GP with
    lengthscale ~0.07 on the unit square plus N(0, 0.3^2) noise; with
    ``noise_v``, per-site weights in the sites' order, N(0, 0.3^2 v_i) from
    the same draws."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2))
    n_feat = 256
    freqs = rng.normal(scale=20.0, size=(n_feat, 2))
    phases = rng.uniform(0, 2 * np.pi, n_feat)
    w = np.sqrt(2 / n_feat) * np.cos(coords @ freqs.T + phases).sum(axis=1)
    scale = 0.3 if noise_v is None else 0.3 * np.sqrt(noise_v)
    y = w + scale * rng.standard_normal(n)
    return coords, y


def noise_weights(n: int):
    """Per-site noise weights v ~ U(0.25, 4) from default_rng(7), in the
    sites' order (the reference's tests/test_noise_models.py:47-61 recipe)."""
    return np.random.default_rng(7).uniform(0.25, 4.0, n)


def config3_field(n: int = 25_000, m: int = 10):
    """bench.py's config 3 data (l.838-855): an NNGP prior draw of a
    Matern(nu=1.2, phi=0.15) field with sigma2 = 1.5 on uniform sites, composed
    site by site through dense per-site conditionals (numpy and scipy's K_nu:
    an implementation independent of the port's kernels), plus N(0, 0.1)
    noise, all from ``np.random.default_rng(33)``."""
    from scipy.special import gamma as sp_gamma
    from scipy.special import kv as sp_kv

    sig_t, phi_t, nu_t, tau_t = 1.5, 0.15, 1.2, 0.1

    def rho(d):
        t = np.sqrt(2.0 * nu_t) * d / phi_t
        out = np.ones_like(t)
        pos = t > 0
        out[pos] = (2.0 ** (1.0 - nu_t) / sp_gamma(nu_t)) * t[pos] ** nu_t * sp_kv(nu_t, t[pos])
        return out

    g = np.random.default_rng(33)
    coords = g.uniform(size=(n, 2))
    tab = build_neighbor_table(coords, m=m)
    oc = coords[tab.order]
    z = g.standard_normal(n)
    w_ord = np.zeros(n)
    for i in range(n):  # w_i = B_i w_N + sqrt(F_i) z_i
        sel = tab.nn_idx[i][tab.nn_mask[i]]
        if len(sel) == 0:
            w_ord[i] = z[i]
            continue
        pts = oc[sel]
        c_nn = rho(np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)))
        c_in = rho(np.sqrt(((oc[i] - pts) ** 2).sum(-1)))
        b = np.linalg.solve(c_nn, c_in)
        w_ord[i] = b @ w_ord[sel] + np.sqrt(1.0 - c_in @ b) * z[i]
    w = np.sqrt(sig_t) * w_ord[tab.inverse_order]
    return coords, w + np.sqrt(tau_t) * g.standard_normal(n)


def team_name(kernel: str, flags: list) -> str:
    """The instance an M = 20 team kernel's template flags name: kernel 2
    <EMIT_Y, COORDS>, kernel 1 <> (coords), kernel 3 <HETERO> (coords);
    e.g. ``grad_y_coords``, ``bf_coords_hetero``."""
    if kernel == "grad":
        return ("grad_y" if flags[0] == "1" else "grad") + ("_coords" if flags[1] == "1" else "")
    if kernel == "suffstats":
        return "suffstats_coords"
    return "bf_coords" + ("_hetero" if flags[0] == "1" else "")


def ptxas_summary(ptxas: str, m: int) -> str:
    """'<kernel><m> R regs spill S/L B' (spill stores/loads) of the m
    instance of every kernel (``_team``: the M = 20 team bodies, whose
    second template argument is their lanes a system).  The
    template arguments after M are EMIT_Y
    (kernel 2 only), GENERAL, the general-nu Matern, COORDS, the coords
    table layout, ROLLED, the rolled instance for m > 20 or d > 3
    (``_rolled``; M = 32, slice 6's coords-only ANY_D at M = 20), and,
    kernel 3 only, HETERO (``_hetero``, its launches with noise weights;
    none in slice 7's tree); trees before slice 6 have neither of the last
    two."""
    out = []
    lines = ptxas.splitlines()
    for i, line in enumerate(lines):
        found = re.search(rf"(suffstats|grad|bf)(?:_nu)?(_team)?_kernelILi{m}E(?:Li\d+E)?"
                          r"((?:Lb[01]E)*)", line)
        if "Compiling entry function" not in line or not found:
            continue
        name, flags = found.group(1), re.findall(r"Lb([01])E", found.group(3))
        if found.group(2):  # an M = 20 team body
            name, flags = team_name(name, flags) + "_team", []
        core = 3 if name == "grad" else 2  # (EMIT_Y,) GENERAL, COORDS
        if name == "grad" and flags[:1] == ["1"]:
            name = "grad_y"
        if flags[core - 2:core - 1] == ["1"]:
            name += "_nu"
        if flags[core - 1:core] == ["1"]:
            name += "_coords"
        if flags[core:core + 1] == ["1"]:
            name += "_rolled"
        if flags[core + 1:core + 2] == ["1"]:  # kernel 3's HETERO instances
            name += "_hetero"
        spill = regs = frame = "?"
        for nxt in lines[i + 1:i + 4]:
            if "spill stores" in nxt:
                parts = nxt.split(",")
                frame = parts[0].split()[0]
                spill = "/".join(p.split()[0] for p in parts[1:3])
            if "registers" in nxt:
                regs = nxt.split("Used")[1].split("registers")[0].strip()
        out.append(f"{name}<{m}> {regs} regs frame {frame} spill {spill} B")
    return "; ".join(sorted(out))


# the float64 plain versions' chunk of chains (Case.chunk): one (chains,
# n_pad, m, m) float64 tensor of at most this many bytes, as 4 chains at the
# main path's n=100,000, m=15 take
PLAIN_CHUNK_BYTES = 750_000_000


def plain_chunk(n_pad: int, m: int, chains: int, least: int) -> int:
    """Chains a float64 plain call takes: at least ``least``, and as many as
    keep one (chains, n_pad, m, m) float64 tensor within PLAIN_CHUNK_BYTES
    (the plain calls of small cases, the general-nu series above all, are
    bound by their launches, not their bytes)."""
    return max(least, min(chains, PLAIN_CHUNK_BYTES // (n_pad * m * m * 8)))


class Case:
    """Site tables, y and per-chain parameters of one parity case, in float32
    for the kernels and the same values in float64 for the oracle.  In the
    coords layout both hold the same float32 coordinate planes, and the
    float64 oracle recomputes the distances from them; ``distance`` names
    the metric of the dist layout's tables.  ``v32`` / ``v64``
    are per-site noise weights in ordered site space (:meth:`with_noise`),
    None for homogeneous noise."""

    def __init__(self, n, m, kernel, chains, seed, dev, field=None, nu=None,
                 layout="dist", distance="euclidean", shards=1):
        coords, y = field if field is not None else bench_field(n, seed)
        # above M_SMEM_GRAD (the cluster body) the dist planes come from the
        # coords layout's on the card (dist_tables_from_coords): the host's
        # (n, m, m) table takes seconds at m = 233 and a minute at m = 600
        built = "coords" if layout == "dist" and m > geometry.M_SMEM_GRAD else layout
        data, table = make_vecchia_data(coords, m, dtype=torch.float64,
                                        distance=distance,
                                        precompute_distances=built == "dist", device="cpu")
        self.n, self.m, self.kernel, self.layout = n, m, kernel, layout
        self.order = table.order
        self.v32 = self.v64 = None
        tab = make_site_tables(data, dtype=torch.float32, device=dev, layout=built,
                               coords_host=np.asarray(coords)[table.order], shards=shards)
        self.tab32 = with_children(tab if built == layout else dist_tables_from_coords(tab))
        self.tab64 = self.tab32.to(torch.float64)
        self.y32 = torch.as_tensor(y[table.order], dtype=torch.float32, device=dev)
        self.y64 = self.y32.double()
        self.phi = torch.linspace(0.05, 0.2, chains, device=dev)
        self.alpha = torch.linspace(0.05, 0.3, chains, device=dev)
        # (C,) smoothness per chain for a kernel that samples it, else None
        self.nu = None if nu is None else torch.as_tensor(
            nu, dtype=torch.float32, device=dev)
        self.jitter = 1e-6
        # a residual per chain, y - x beta_c, as the fixed-effects model forms
        # it: the chains' slopes spread over +-0.05, some fifty posterior
        # standard deviations at this n
        x = torch.as_tensor(np.random.default_rng(seed + 1).standard_normal(n),
                            dtype=torch.float32, device=dev)
        beta = torch.linspace(-0.05, 0.05, chains, device=dev)
        self.y32_chains = self.y32 - beta[:, None] * x
        # chains a float64 plain call takes (4 at n=100,000, m=15; every
        # chain of the small cases)
        self.chunk = plain_chunk(self.tab32.n_pad, m, chains, 4)

    def subset(self, sl, kernel=None, chunk=1):
        """The same tables and y with the chains ``sl`` of this case, under
        ``kernel`` if given, and ``chunk`` chains a plain call (the float64
        plain versions' memory at config 5's n), or with ``chunk=None`` at
        least 2 and as many as plain_chunk allows."""
        out = copy.copy(self)
        out.phi, out.alpha, out.y32_chains = self.phi[sl], self.alpha[sl], self.y32_chains[sl]
        out.nu = None if self.nu is None else self.nu[sl]
        out.kernel = self.kernel if kernel is None else kernel
        out.chunk = chunk if chunk is not None else plain_chunk(
            self.tab32.n_pad, self.m, out.phi.shape[0], 2)
        return out

    def with_noise(self, v):
        """The same case with per-site noise weights ``v`` (n,) in the sites'
        order: float32 for the kernels, the same values in float64."""
        out = copy.copy(self)
        out.v32 = torch.as_tensor(v[self.order], dtype=torch.float32,
                                  device=self.y32.device)
        out.v64 = out.v32.double()
        return out

    def params64(self, sl, requires_grad=False, alpha=None):
        alpha = self.alpha if alpha is None else alpha
        phi = self.phi[sl].double().requires_grad_(requires_grad)
        alpha = alpha[sl].double().requires_grad_(requires_grad)
        nu = None if self.nu is None else self.nu[sl].double()
        pr = fwd_ops.params_array(phi, alpha, np.float32(self.jitter), self.n,
                                  torch.float64, phi.device,
                                  fwd_ops.kernel_nu(self.kernel, nu))
        return phi, alpha, pr

    def chunks(self):
        chains = self.phi.shape[0]
        return [slice(i, min(i + self.chunk, chains)) for i in range(0, chains, self.chunk)]


def _rel(a, b):
    return float(((a - b).abs() / b.abs()).max())


def _allclose_ratio(a, b, rtol, atol):
    """Worst |a-b| / (atol + rtol |b|): <= 1 passes, as numpy's allclose."""
    return float(((a - b).abs() / (atol + rtol * b.abs())).max())


def check_forward(case: Case, label: str, out=None) -> dict:
    """Kernel 1 against its plain version (float64 on the card, chunked over
    chains); tolerances of tests/test_pallas.py:62-70.  ``out``: the
    kernel's outputs of a launch already made, or None to launch it."""
    logdet, quad, f, r = out if out is not None else fwd_ops.suffstats(
        case.kernel, case.tab32, case.phi, case.alpha, case.y32, case.jitter,
        noise_v=case.v32)
    torch.cuda.synchronize()
    ref = [fwd_ops.suffstats_reference(case.kernel, case.tab64,
                                       case.params64(sl)[2], case.y64, case.v64)
           for sl in case.chunks()]
    ld_ref, q_ref, f_ref, r_ref = (torch.cat(x) for x in zip(*ref))
    n = case.n
    f, r = f[:, :n].double(), r[:, :n].double()
    f_ref, r_ref = f_ref[:, :n], r_ref[:, :n]
    res = {
        "logdet_rel": _rel(logdet.double(), ld_ref),
        "quad_rel": _rel(quad.double(), q_ref),
        "f_ratio": _allclose_ratio(f, f_ref, 1e-4, 1e-6),
        "r_ratio": _allclose_ratio(r, r_ref, 2e-3, 1e-4),
        "f_max_abs_err": float((f - f_ref).abs().max()),
    }
    print(f"forward parity [{label}]: " + json.dumps(res), flush=True)
    _require(res["logdet_rel"] <= 3e-4 and res["quad_rel"] <= 3e-4,
             f"kernel 1 logdet/quad disagree [{label}]")
    _require(res["f_ratio"] <= 1.0 and res["r_ratio"] <= 1.0,
             f"kernel 1 F/r disagree [{label}]")
    return res


def check_grad(case: Case, label: str, grad_rtol: float, out=None) -> dict:
    """Kernel 2 against autograd through the plain float64 version.
    ``out``: the sums of a launch already made, or None to launch it."""
    sums = out if out is not None else diff_ops.value_and_grad_sums(
        case.kernel, case.tab32, case.phi, case.alpha, case.y32, case.jitter,
        noise_v=case.v32)
    torch.cuda.synchronize()
    refs = []
    for sl in case.chunks():
        phi, alpha, pr = case.params64(sl, requires_grad=True)
        ld, q, _, _ = fwd_ops.suffstats_reference(case.kernel, case.tab64, pr,
                                                  case.y64, case.v64)
        dld = torch.autograd.grad(ld.sum(), (phi, alpha), retain_graph=True)
        dq = torch.autograd.grad(q.sum(), (phi, alpha))
        refs.append(torch.stack([ld.detach(), q.detach(), dld[0], dq[0],
                                 dld[1], dq[1]]))
    ref = torch.cat(refs, dim=1)
    got = sums.double()
    res = {
        "value_rel": _rel(got[:2], ref[:2]),
        "dphi_rel": _rel(got[2:4], ref[2:4]),
        "dalpha_rel": _rel(got[4:6], ref[4:6]),
        "max_abs_err": float((got - ref).abs().max()),
    }
    print(f"grad parity [{label}]: " + json.dumps(res), flush=True)
    _require(res["value_rel"] <= 5e-4, f"kernel 2 values disagree [{label}]")
    _require(res["dphi_rel"] <= grad_rtol and res["dalpha_rel"] <= grad_rtol,
             f"kernel 2 gradients disagree [{label}]")
    return res


def check_bf(case: Case, label: str, zero_alpha: bool, gated: bool, out=None) -> dict:
    """Kernel 3 against its plain version (float64 on the card, chunked over
    chains), B and F over the sites < n, and the padded-site rule (B = 0,
    F = 1 exactly for site >= n).

    Tolerances.  With the case's alpha: B atol 3e-5 and F rtol 3e-5, as
    tests/test_pallas.py:80-81 holds the TPU kernel.  With alpha = 0 (what
    the latent model passes) the systems are far worse conditioned: B atol
    1e-3 and F rtol 1e-3 for the rough exponential kernel; for sqexp any two
    correct float32 factorizations disagree (tests/test_pallas.py:34-38), so
    that case is printed and only its padded sites are held.  ``out``: the
    kernel's (B, F) of a launch already made, or None to launch it."""
    alpha = torch.zeros_like(case.alpha) if zero_alpha else case.alpha
    b, f = out if out is not None else bf_ops.bf_planes(
        case.kernel, case.tab32, case.phi, alpha, case.jitter, noise_v=case.v32)
    torch.cuda.synchronize()
    ref = [bf_ops.bf_reference(case.kernel, case.tab64,
                               case.params64(sl, alpha=alpha)[2], case.v64)
           for sl in case.chunks()]
    b_ref, f_ref = (torch.cat(x) for x in zip(*ref))
    n = case.n
    b_err = (b[:, :, :n].double() - b_ref[:, :, :n]).abs()
    f_err = (f[:, :n].double() - f_ref[:, :n]).abs() / f_ref[:, :n].abs()
    pad_ok = bool((b[:, :, n:] == 0).all() and (f[:, n:] == 1).all())
    res = {
        "alpha": "0" if zero_alpha else "case", "gated": gated,
        "b_max_abs_err": float(b_err.nan_to_num(nan=float("inf")).max()),
        "f_max_rel_err": float(f_err.nan_to_num(nan=float("inf")).max()),
        "b_max_abs": float(b_ref.abs().max()),
        "padded_sites": case.tab32.n_pad - n, "padded_b0_f1": pad_ok,
    }
    print(f"bf parity [{label}]: " + json.dumps(res), flush=True)
    _require(pad_ok, f"kernel 3 padded sites are not B=0, F=1 [{label}]")
    if gated:
        tol = 1e-3 if zero_alpha else 3e-5
        _require(res["b_max_abs_err"] <= tol and res["f_max_rel_err"] <= tol,
                 f"kernel 3 B/F disagree [{label}, alpha {res['alpha']}]")
    return res


def check_grad_y(case: Case, label: str, per_chain: bool, grad_rtol: float,
                 out=None) -> dict:
    """The EMIT_Y instances of kernel 2 against the plain version in float64
    on the card (chunked over chains), with a shared or a per-chain y.

    Tolerances.  The six sums as kernel 2 (values rtol 5e-4, gradients
    ``grad_rtol``).  B atol 3e-5, kernel 3's limit.  r/F rtol 2e-3 and atol
    1e-4, kernel 1's limit for r.  dy = dquad/dy from the kernel's planes
    through the gather, against autograd through the float64 factorization:
    rtol 2e-3, atol 2e-4 (tests/test_pallas.py:205-209).  Padded sites hold
    B = 0 and r/F = 0 exactly, and so does every invalid slot of B.  ``out``:
    the (sums, B, r/F) of a launch already made, or None to launch it."""
    y32 = case.y32_chains if per_chain else case.y32
    sums, b, rof = out if out is not None else diff_ops.value_and_grad_sums(
        case.kernel, case.tab32, case.phi, case.alpha, y32, case.jitter, emit_y=True,
        noise_v=case.v32)
    dy = diff_ops.dquad_dy(case.tab32, b, rof)
    torch.cuda.synchronize()
    n, m = case.n, case.m
    refs = []
    for sl in case.chunks():
        _, _, pr = case.params64(sl)
        width = sl.stop - sl.start
        # one y row per chain, so that the shared y's gradient splits by chain
        y64 = y32[sl].double() if per_chain else case.y64.expand(width, n)
        y64 = y64.clone().requires_grad_(True)
        s_ref, b_ref, rof_ref = diff_ops.grad_reference(
            case.kernel, case.tab64, pr, y64.detach(), emit_y=True, noise_v=case.v64)
        _, q, _, _ = fwd_ops.suffstats_reference(case.kernel, case.tab64, pr, y64,
                                                  case.v64)
        (dy_ref,) = torch.autograd.grad(q.sum(), y64)
        refs.append((s_ref, b_ref, rof_ref, dy_ref))
    s_ref = torch.cat([r[0] for r in refs], dim=1)
    b_ref, rof_ref, dy_ref = (torch.cat([r[i] for r in refs]) for i in (1, 2, 3))
    got = sums.double()
    pad_ok = bool((b[:, :, n:] == 0).all() and (rof[:, n:] == 0).all())
    slots_ok = all(bool((b[:, k, :k + 1] == 0).all()) for k in range(m))
    res = {
        "y": "per-chain" if per_chain else "shared",
        "value_rel": _rel(got[:2], s_ref[:2]),
        "dphi_rel": _rel(got[2:4], s_ref[2:4]),
        "dalpha_rel": _rel(got[4:6], s_ref[4:6]),
        "b_max_abs_err": float((b.double() - b_ref).abs().max()),
        "rof_ratio": _allclose_ratio(rof.double(), rof_ref, 2e-3, 1e-4),
        "dy_ratio": _allclose_ratio(dy.double(), dy_ref, 2e-3, 2e-4),
        "dy_max_abs": float(dy_ref.abs().max()),
        "padded_sites": case.tab32.n_pad - n, "padded_zero": pad_ok,
        "invalid_slots_zero": slots_ok,
        "max_children": case.tab32.child_flat.shape[1],
    }
    print(f"grad_y parity [{label}]: " + json.dumps(res), flush=True)
    _require(pad_ok and slots_ok,
             f"EMIT_Y padded sites or invalid slots are not exactly 0 [{label}]")
    _require(res["value_rel"] <= 5e-4, f"EMIT_Y values disagree [{label}]")
    _require(res["dphi_rel"] <= grad_rtol and res["dalpha_rel"] <= grad_rtol,
             f"EMIT_Y gradients disagree [{label}]")
    _require(res["b_max_abs_err"] <= 3e-5, f"EMIT_Y B disagrees [{label}]")
    _require(res["rof_ratio"] <= 1.0, f"EMIT_Y r/F disagrees [{label}]")
    _require(res["dy_ratio"] <= 1.0, f"the y cotangent disagrees [{label}]")
    return res


# Limits of the general-nu parity phases: float32 kernel against the float64
# plain version, relative unless named otherwise.
NU_LIMITS = {
    "value_rel": 5e-5, "dphi_rel": 2e-4, "dalpha_rel": 2e-4, "dnu_rel": 5e-2,
    "b_max_abs_err": 1e-4, "f_ratio": 1.0, "r_ratio": 1.0, "rof_ratio": 1.0,
    "dy_ratio": 1.0,
}


def nu_spread(chains: int):
    """Per-chain smoothness over (0.15, 2.9), with the three cancellation
    cases of the nearest-integer split (bessel.py): nu within 1e-4 of 1/2, 1
    and 3/2, from below and from above."""
    edge = [0.5 - 1e-4, 0.5 + 1e-4, 1.0 - 1e-4, 1.0 + 1e-4, 1.5 - 1e-4, 1.5 + 1e-4]
    rest = np.linspace(0.15, 2.9, chains - len(edge))
    return np.concatenate([rest, edge])[:chains]


def check_general_nu(case: Case, label: str, per_chain_y: bool = True) -> dict:
    """The general-nu instances of kernels 1, 2, 2-EMIT_Y and 3 against their
    plain versions in float64 on the card (chunked over chains), sampled nu;
    kernel 2-EMIT_Y with one y row a chain, or with ``per_chain_y`` false the
    shared y of kernel 2 (one float64 plain call then serves both).

    Limits, and why.  The float32 series for K_nu carries up to 1e-5 relative
    noise in rho, where a closed form carries 1e-7; F and r follow rho through
    the factorization.  The limits were set after the first run on the card,
    about ten times what it showed (an NVIDIA H100 80GB HBM3; in brackets).
    Values (logdet, quad) rtol 5e-5 (4.5e-7: the noise averages out over the
    sites).  F rtol 1e-3 / atol 1e-5 (0.005 of it), r rtol 2e-3 / atol 2e-4,
    r/F rtol 2e-3 / atol 2e-4 and dy rtol 2e-3 / atol 5e-4: twice the
    closed-form instances' absolute limits, which scale as 1/F >= 1/alpha.  B
    atol 1e-4 (1.1e-5).  The phi and alpha sums rtol 2e-4 (1.3e-6, 1.0e-6).
    The nu sums rtol 5e-2 (4.8e-3 at nu = 2.6; below 2e-4 for nu < 2): the
    derivative is a difference of two float32 rho over a width of 2e-2, which
    divides the series' noise by that width.  Padded sites and invalid slots
    exactly 0 (kernel 3: B = 0, F = 1)."""
    k, t32, t64, n, m = case.kernel, case.tab32, case.tab64, case.n, case.m
    jit, v32, v64 = case.jitter, case.v32, case.v64
    logdet, quad, f, r = fwd_ops.suffstats(k, t32, case.phi, case.alpha, case.y32,
                                           jit, nu=case.nu, noise_v=v32)
    b3, f3 = bf_ops.bf_planes(k, t32, case.phi, case.alpha, jit, nu=case.nu,
                              noise_v=v32)
    sums = diff_ops.value_and_grad_sums(k, t32, case.phi, case.alpha, case.y32, jit,
                                        nu=case.nu, noise_v=v32)
    y_emit = case.y32_chains if per_chain_y else case.y32
    sums_y, b, rof = diff_ops.value_and_grad_sums(
        k, t32, case.phi, case.alpha, y_emit, jit, emit_y=True, nu=case.nu, noise_v=v32)
    dy = diff_ops.dquad_dy(t32, b, rof)
    torch.cuda.synchronize()
    refs = []
    for sl in case.chunks():
        _, _, pr = case.params64(sl)
        fwd = fwd_ops.suffstats_reference(k, t64, pr, case.y64, v64)
        bf = bf_ops.bf_reference(k, t64, pr, v64)
        sy_ref, b_ref, rof_ref = diff_ops.grad_reference(
            k, t64, pr, y_emit[sl].double() if per_chain_y else case.y64, emit_y=True,
            noise_v=v64)
        s_ref = (diff_ops.grad_reference(k, t64, pr, case.y64, noise_v=v64) if per_chain_y
                 else sy_ref)
        refs.append((*fwd, *bf, s_ref, sy_ref, b_ref, rof_ref,
                     diff_ops.dquad_dy(t64, b_ref, rof_ref)))
    cat = lambda i, dim=0: torch.cat([ref[i] for ref in refs], dim=dim)
    ld_ref, q_ref, f_ref, r_ref, b3_ref, f3_ref = (cat(i) for i in range(6))
    s_ref, sy_ref = cat(6, 1), cat(7, 1)
    b_ref, rof_ref, dy_ref = cat(8), cat(9), cat(10)
    pad_ok = bool((b3[:, :, n:] == 0).all() and (f3[:, n:] == 1).all()
                  and (b[:, :, n:] == 0).all() and (rof[:, n:] == 0).all())
    slots_ok = all(bool((b[:, j, :j + 1] == 0).all()) for j in range(m))
    got, got_y = sums.double(), sums_y.double()
    res = {
        "nu": [round(float(v), 4) for v in case.nu], "y": "per-chain" if per_chain_y else "shared",
        "value_rel": max(_rel(logdet.double(), ld_ref), _rel(quad.double(), q_ref),
                         _rel(got[:2], s_ref[:2]), _rel(got_y[:2], sy_ref[:2])),
        "f_ratio": _allclose_ratio(f[:, :n].double(), f_ref[:, :n], 1e-3, 1e-5),
        "r_ratio": _allclose_ratio(r[:, :n].double(), r_ref[:, :n], 2e-3, 2e-4),
        "f_max_abs_err": float((f[:, :n].double() - f_ref[:, :n]).abs().max()),
        "bf_b_max_abs_err": float((b3.double() - b3_ref).abs().max()),
        "bf_f_max_rel_err": _rel(f3[:, :n].double(), f3_ref[:, :n]),
        "dphi_rel": max(_rel(got[2:4], s_ref[2:4]), _rel(got_y[2:4], sy_ref[2:4])),
        "dalpha_rel": max(_rel(got[4:6], s_ref[4:6]), _rel(got_y[4:6], sy_ref[4:6])),
        "dnu_rel": max(_rel(got[6:8], s_ref[6:8]), _rel(got_y[6:8], sy_ref[6:8])),
        "dnu_rel_by_chain": [round(float(v), 5) for v in
                             ((got[6:8] - s_ref[6:8]).abs() / s_ref[6:8].abs()).amax(0)],
        "sums_max_abs_err": float((got - s_ref).abs().max()),
        "b_max_abs_err": float((b.double() - b_ref).abs().max()),
        "rof_ratio": _allclose_ratio(rof.double(), rof_ref, 2e-3, 2e-4),
        "dy_ratio": _allclose_ratio(dy.double(), dy_ref, 2e-3, 5e-4),
        "padded_sites": t32.n_pad - n, "padded_ok": pad_ok, "invalid_slots_zero": slots_ok,
    }
    print(f"general-nu parity [{label}]: " + json.dumps(res), flush=True)
    _require(pad_ok and slots_ok,
             f"general-nu padded sites or invalid slots are wrong [{label}]")
    _require(res["bf_b_max_abs_err"] <= NU_LIMITS["b_max_abs_err"]
             and res["bf_f_max_rel_err"] <= 1e-4,
             f"general-nu kernel 3 B/F disagree [{label}]")
    for key, limit in NU_LIMITS.items():
        _require(res[key] <= limit, f"general-nu {key} {res[key]} exceeds {limit} [{label}]")
    return res


def check_general_nu_13(case: Case, label: str) -> dict:
    """The general-nu instances of kernels 1 and 3 alone against their plain
    versions in float64 on the card, sampled nu, at :func:`check_general_nu`'s
    limits (NU_LIMITS; kernel 3's F rtol 1e-4)."""
    k, t32, t64, n = case.kernel, case.tab32, case.tab64, case.n
    logdet, quad, f, r = fwd_ops.suffstats(k, t32, case.phi, case.alpha, case.y32,
                                           case.jitter, nu=case.nu, noise_v=case.v32)
    b3, f3 = bf_ops.bf_planes(k, t32, case.phi, case.alpha, case.jitter, nu=case.nu,
                              noise_v=case.v32)
    torch.cuda.synchronize()
    refs = []
    for sl in case.chunks():
        _, _, pr = case.params64(sl)
        refs.append((*fwd_ops.suffstats_reference(k, t64, pr, case.y64, case.v64),
                     *bf_ops.bf_reference(k, t64, pr, case.v64)))
    ld_ref, q_ref, f_ref, r_ref, b3_ref, f3_ref = (torch.cat([ref[i] for ref in refs])
                                                   for i in range(6))
    pad_ok = bool((b3[:, :, n:] == 0).all() and (f3[:, n:] == 1).all())
    res = {
        "nu": [round(float(v), 4) for v in case.nu],
        "value_rel": max(_rel(logdet.double(), ld_ref), _rel(quad.double(), q_ref)),
        "f_ratio": _allclose_ratio(f[:, :n].double(), f_ref[:, :n], 1e-3, 1e-5),
        "r_ratio": _allclose_ratio(r[:, :n].double(), r_ref[:, :n], 2e-3, 2e-4),
        "f_max_abs_err": float((f[:, :n].double() - f_ref[:, :n]).abs().max()),
        "bf_b_max_abs_err": float((b3.double() - b3_ref).abs().max()),
        "bf_f_max_rel_err": _rel(f3[:, :n].double(), f3_ref[:, :n]),
        "padded_sites": t32.n_pad - n, "padded_ok": pad_ok,
    }
    print(f"general-nu parity, kernels 1 and 3 [{label}]: " + json.dumps(res), flush=True)
    _require(pad_ok, f"general-nu kernel 3 padded sites are wrong [{label}]")
    _require(res["bf_b_max_abs_err"] <= NU_LIMITS["b_max_abs_err"]
             and res["bf_f_max_rel_err"] <= 1e-4,
             f"general-nu kernel 3 B/F disagree [{label}]")
    for key in ("value_rel", "f_ratio", "r_ratio"):
        _require(res[key] <= NU_LIMITS[key],
                 f"general-nu {key} {res[key]} exceeds {NU_LIMITS[key]} [{label}]")
    return res


def check_static_nu(case: Case, label: str) -> dict:
    """``Matern(nu=0.8)``, a static general nu, through the same instances
    without the nu sums: kernel 2's eight sums against the plain version, the
    last two exactly 0; limits of :func:`check_general_nu`."""
    k = Matern(nu=0.8)
    sums = diff_ops.value_and_grad_sums(k, case.tab32, case.phi, case.alpha,
                                        case.y32, case.jitter)
    torch.cuda.synchronize()
    pr = fwd_ops.params_array(case.phi.double(), case.alpha.double(),
                              np.float32(case.jitter), case.n, torch.float64,
                              case.phi.device, 0.8)
    ref = torch.cat([diff_ops.grad_reference(k, case.tab64, pr[sl], case.y64)
                     for sl in case.chunks()], dim=1)
    got = sums.double()
    res = {"value_rel": _rel(got[:2], ref[:2]), "dphi_rel": _rel(got[2:4], ref[2:4]),
           "dalpha_rel": _rel(got[4:6], ref[4:6]),
           "nu_sums_zero": bool((sums[6:] == 0).all())}
    print(f"static-nu parity [{label}]: " + json.dumps(res), flush=True)
    _require(res["nu_sums_zero"], f"static nu wrote nu sums [{label}]")
    for key in ("value_rel", "dphi_rel", "dalpha_rel"):
        _require(res[key] <= NU_LIMITS[key], f"static-nu {key} disagrees [{label}]")
    return res


def check_kve(dev) -> dict:
    """bessel.kve in float64 on the card against scipy.special.kve over
    x in [1e-6, 60] and the orders of tests/test_bessel.py: rtol 1e-9 (the
    series and the continued fraction run to float64 convergence)."""
    from scipy.special import kve as scipy_kve

    x = np.exp(np.random.default_rng(0).uniform(np.log(1e-6), np.log(60.0), 4000))
    worst = 0.0
    for nu in (0.0, 0.3, 0.5, 0.99, 0.9999, 1.0, 1.5, 2.7, 5.25, 10.6):
        got = bessel.kve(torch.as_tensor(x, device=dev), nu).cpu().numpy()
        want = scipy_kve(nu, x)
        worst = max(worst, float(np.max(np.abs(got - want) / np.abs(want))))
    print("kve parity [float64 on the card vs scipy]: "
          + json.dumps({"max_rel_err": worst}), flush=True)
    _require(worst <= 1e-9, f"bessel.kve disagrees with scipy: {worst}")
    return {"max_rel_err": worst}


# Card clocks (at up to 2 GHz) of the sleep that _time_ms puts ahead of each
# call it times: enough for the host to enqueue that many microseconds of
# wrapper work.
SLEEP_CYCLES_PER_CALL = 1_000_000


def _time_ms(fn, warm: int, reps: int) -> float:
    """Card milliseconds of one call of ``fn``: CUDA events around ``reps``
    calls after ``warm`` more.  A sleep kernel ahead of the first event
    keeps the card busy while the host enqueues the calls, so that a kernel
    shorter than its wrapper's host work is timed on the card, not at the
    host's pace; a call that waits for the card is timed with its host work,
    as before."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * reps)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _suffix(case: Case) -> str:
    """The row-name suffix of the case's table layout."""
    return _suffix_of(case.layout)


def _suffix_of(layout: str) -> str:
    return "_coords" if layout == "coords" else ""


def time_plain(case: Case) -> dict:
    """Per-call times of the float32 plain versions of kernels 1, 2,
    2-EMIT_Y and 3 at the case's shapes, named by the rows of its layout."""
    k, t, y = case.kernel, case.tab32, case.y32
    params = fwd_ops.params_array(case.phi, case.alpha, case.jitter, case.n,
                                  torch.float32, case.phi.device)
    sfx = _suffix(case)
    return {name + sfx + "_plain": ms for name, ms in {
        "vecchia_suffstats": _time_ms(
            lambda: fwd_ops.suffstats_reference(k, t, params, y), 2, 5),
        "vecchia_grad": _time_ms(lambda: diff_ops.grad_reference(k, t, params, y), 2, 5),
        "vecchia_bf": _time_ms(lambda: bf_ops.bf_reference(k, t, params), 2, 5),
        "vecchia_grad_y": _time_ms(
            lambda: diff_ops.grad_reference(k, t, params, case.y32_chains, emit_y=True),
            2, 5),
    }.items()}


def time_kernels(case: Case) -> dict:
    """Per-call times of kernels 1, 2, 2-EMIT_Y and 3 on the dist layout and
    of their float32 plain versions; also of kernel 2 and the y-cotangent
    gather at 1, 4 and 16 chains."""
    k, t, y = case.kernel, case.tab32, case.y32
    times = {
        "vecchia_suffstats": _time_ms(
            lambda: fwd_ops.suffstats(k, t, case.phi, case.alpha, y, case.jitter),
            20, 200),
        "vecchia_grad": _time_ms(
            lambda: diff_ops.value_and_grad_sums(k, t, case.phi, case.alpha, y,
                                                 case.jitter), 20, 200),
        "vecchia_bf": _time_ms(
            lambda: bf_ops.bf_planes(k, t, case.phi, case.alpha, case.jitter),
            20, 200),
        "vecchia_grad_y": _time_ms(
            lambda: diff_ops.value_and_grad_sums(k, t, case.phi, case.alpha,
                                                 case.y32_chains, case.jitter,
                                                 emit_y=True), 20, 200),
        **time_plain(case),
    }
    # the EMIT_Y instances and the y-cotangent gather by chain count, and the
    # scatter-add that the gather replaces (index_add_: float atomics, not
    # reproducible, timed as a yardstick and used nowhere in the port)
    idx = t.nn_idx.long().reshape(-1)
    by_chains = {}
    for c in (1, 4, 16):
        phi, alpha, y = case.phi[:c], case.alpha[:c], case.y32_chains[:c]
        _, b, rof = diff_ops.value_and_grad_sums(k, t, phi, alpha, y, case.jitter,
                                                 emit_y=True)

        def scatter():
            out = 2.0 * rof
            src = (-2.0 * b * rof[:, None, :]).reshape(c, -1)
            return out.index_add_(1, idx, src)

        by_chains[c] = {
            "grad_y_ms": _time_ms(lambda: diff_ops.value_and_grad_sums(
                k, t, phi, alpha, y, case.jitter, emit_y=True), 20, 100),
            "grad_ms": _time_ms(lambda: diff_ops.value_and_grad_sums(
                k, t, phi, alpha, y, case.jitter), 20, 100),
            "suffstats_per_chain_y_ms": _time_ms(lambda: fwd_ops.suffstats(
                k, t, phi, alpha, y, case.jitter), 20, 100),
            "dy_gather_ms": _time_ms(lambda: diff_ops.dquad_dy(t, b, rof), 10, 50),
            "dy_index_add_ms": _time_ms(scatter, 10, 50),
        }
    print("grad_y times by chains: " + json.dumps(by_chains), flush=True)
    chains = case.phi.shape[0]
    print(f"kernel times [{case.layout}]: " + json.dumps({
        **{f"{name}_ms": ms for name, ms in times.items()},
        f"vecchia_loglik_evals_per_sec_n{case.n}_m{case.m}":
            chains * 1e3 / times["vecchia_suffstats"],
        "grad_evals_per_sec": chains * 1e3 / times["vecchia_grad"],
        "bf_builds_per_sec": chains * 1e3 / times["vecchia_bf"],
        "chains": chains,
    }), flush=True)
    return times


def kernel_bounds(case: Case) -> dict:
    """The least time the card could take for one launch of each kernel at
    the case's shapes: name -> (bound_ms, "bytes" or "operations").

    Bytes: every input read once (the tables are shared by all chains; kernel
    3 reads no neighbor ids and no y) and every output written once, over
    3.35 TB/s.  Operations per (site, chain), the reference's own cost
    estimate (pynngp_tpu/ops/pallas_bf.py:1027-1031) extended to each
    kernel's solves: m^3/3 float32 operations for the factorization and m^2
    per triangular solve (kernel 1: two forward; kernel 2: two forward, two
    backward and ~3 m^2 for the dC/dphi contractions, the same with EMIT_Y;
    kernel 3: one forward, one backward) over 67 TFLOP/s; and one special-function operation per
    correlation (m(m+1)/2) and per pivot (m) over 4.19e12/s, in kernel 2
    too: for every closed-form rho, d rho / d phi is rho's own exponential
    times an algebraic factor (spherical's is algebraic), so the function
    needs no second one (the kernels and the reference evaluate it again;
    the bound does not count that).  The bound is the largest of the three times.

    The coords layout reads (d + m d) coordinate planes for its tables and
    adds what its distances need (:func:`distance_work`)."""
    t, m = case.tab32, case.m
    sites = t.n_pad * case.phi.shape[0]
    blocks = sites // 128
    tables = (t.tab_a.numel() + t.tab_b.numel()) * 4
    ids_y = t.nn_idx.numel() * 4 + t.n * 4
    corr = m * (m + 1) // 2
    dist_flops, dist_sfu = distance_work(t)
    work = {
        "vecchia_suffstats": (tables + ids_y + (2 * sites + 2 * blocks) * 4,
                              m**3 / 3 + 2 * m * m, corr + m),
        "vecchia_grad": (tables + ids_y + 6 * blocks * 4,
                         m**3 / 3 + 7 * m * m, corr + m),
        "vecchia_bf": (tables + (m + 1) * sites * 4,
                       m**3 / 3 + 2 * m * m, corr + m),
        # kernel 2's work, one y row per chain, and the B and r/F stores
        "vecchia_grad_y": (tables + t.nn_idx.numel() * 4
                           + case.phi.shape[0] * t.n * 4 + 6 * blocks * 4
                           + (m + 1) * sites * 4,
                           m**3 / 3 + 7 * m * m, corr + m),
    }
    if case.v32 is not None:
        work = {name: (nbytes + noise_bytes(t, name), flops + noise_flops(m, name), sfu)
                for name, (nbytes, flops, sfu) in work.items()}
    out, shown = {}, {}
    for name, (nbytes, flops, sfu) in work.items():
        sfx = _suffix(case) + _large(case, name) + _hetero(case)
        flops, sfu = flops * sites + dist_flops, sfu * sites + dist_sfu
        byte_ms = nbytes / PEAK_BYTES * 1e3
        op_ms = max(flops / PEAK_FLOPS, sfu / PEAK_SFU) * 1e3
        out[name + sfx] = (max(byte_ms, op_ms),
                           "bytes" if byte_ms >= op_ms else "operations")
        shown[name + sfx] = {"bound_ms": out[name + sfx][0],
                             "bound_by": out[name + sfx][1], "bytes": nbytes,
                             "flops": flops, "special": sfu}
    print(f"kernel bounds [{case.layout}{_large(case)}{_hetero(case)} n{case.n} m{case.m}]: "
          + json.dumps(shown), flush=True)
    return out


def _hetero(case: Case) -> str:
    """The row-name suffix of a case with noise weights."""
    return "" if case.v32 is None else "_hetero"


def _large(case: Case, name: str = "vecchia_suffstats") -> str:
    """The row-name suffix of kernel ``name`` (a row or base name) at a case
    with m > 32 (the large-m instances): ``_large`` on the shared-memory
    body, ``_large_cluster`` or ``_large_scratch`` above it
    (``geometry.large_body``)."""
    if not geometry.large(case.m):
        return ""
    base = next(b for b in ("vecchia_grad", "vecchia_bf", "vecchia_suffstats")
                if name.startswith(b))
    body = geometry.large_body(base, case.m)
    return "_large" + ("" if body == "smem" else "_" + body)


def noise_bytes(t, name: str) -> int:
    """Bytes the noise weights add to a kernel's reads: v at the m neighbors
    and at the site, (m + 1) planes of n_pad floats, the reference's
    _noise_planes (pallas_bf.py:510-518); kernel 3 also reads the neighbor
    ids it gathers them through."""
    ids = t.nn_idx.numel() * 4 if name.startswith("vecchia_bf") else 0
    return (t.m + 1) * t.n_pad * 4 + ids


def noise_flops(m: int, name: str) -> int:
    """Operations the noise weights add per (site, chain): the m + 1
    products alpha v, and in kernel 2 the v weights of its two alpha sums."""
    return 3 * m + 1 if name.startswith("vecchia_grad") else m + 1


def distance_work(t) -> tuple:
    """(float32 operations, special-function operations) that the coords
    layout's distances need on top of the rest: one distance per (site, slot)
    and per pair of slots, each d subtractions and d multiply-adds and one
    sqrt, counted once per site since they do not depend on the chain (the
    kernels recompute each for every chain, and kernel 2 every pair twice;
    the bound does not count that).  Zero for the dist layout."""
    if t.layout != "coords":
        return 0.0, 0.0
    per_site = t.m * (t.m + 1) // 2
    return 2.0 * t.dim * per_site * t.n_pad, float(per_site * t.n_pad)


def dist_tables_from_coords(t):
    """Dist-layout tables of the same sites and neighbors as the coords
    tables ``t``: the float64 distances of :func:`distance_planes` rounded to
    float32 once, as the host's dist layout rounds its float64 distances."""
    d_in, d_nn = distance_planes(t)
    return t._replace(tab_a=d_in.float().contiguous(), tab_b=d_nn.float().contiguous(),
                      layout="dist")


def distance_planes(t):
    """(site -> slot (m, n_pad), slot pair (m(m-1)/2, n_pad)) distances of
    tables in either layout, the coords layout's recomputed in float64."""
    if t.layout == "dist":
        return t.tab_a, t.tab_b[:t.m * (t.m - 1) // 2]
    d_in, d_nn = unpack_distances(t.to(torch.float64))
    iu, ku = np.tril_indices(t.m, -1)  # the packed order, tri_index(i, k)
    return d_in.T, d_nn[:, iu, ku].T


def time_kernels_nu(case: Case, plain: bool) -> dict:
    """Per-call times of the general-nu instances at the case's shapes (all
    its chains, sampled nu) and, with ``plain``, of their float32 plain
    versions; kernel 2 also with 2 chains, config 3's launch shape."""
    k, t, y, nu = case.kernel, case.tab32, case.y32, case.nu
    args = (case.phi, case.alpha)
    times = {
        "vecchia_suffstats_nu": _time_ms(
            lambda: fwd_ops.suffstats(k, t, *args, y, case.jitter, nu=nu), 5, 50),
        "vecchia_grad_nu": _time_ms(
            lambda: diff_ops.value_and_grad_sums(k, t, *args, y, case.jitter, nu=nu),
            5, 50),
        "vecchia_grad_y_nu": _time_ms(
            lambda: diff_ops.value_and_grad_sums(k, t, *args, case.y32_chains,
                                                 case.jitter, emit_y=True, nu=nu), 5, 50),
        "vecchia_bf_nu": _time_ms(
            lambda: bf_ops.bf_planes(k, t, *args, case.jitter, nu=nu), 5, 50),
        "vecchia_grad_nu_2_chains": _time_ms(
            lambda: diff_ops.value_and_grad_sums(k, t, case.phi[:2], case.alpha[:2], y,
                                                 case.jitter, nu=nu[:2]), 5, 50),
        "vecchia_grad_nu_static": _time_ms(
            lambda: diff_ops.value_and_grad_sums(Matern(nu=0.8), t, *args, y,
                                                 case.jitter), 5, 50),
    }
    if plain:
        params = fwd_ops.params_array(*args, case.jitter, case.n, torch.float32,
                                      case.phi.device, nu)
        times.update({
            "vecchia_suffstats_nu_plain": _time_ms(
                lambda: fwd_ops.suffstats_reference(k, t, params, y), 1, 1),
            "vecchia_grad_nu_plain": _time_ms(
                lambda: diff_ops.grad_reference(k, t, params, y), 1, 1),
            "vecchia_grad_y_nu_plain": _time_ms(
                lambda: diff_ops.grad_reference(k, t, params, case.y32_chains,
                                                emit_y=True), 1, 1),
            "vecchia_bf_nu_plain": _time_ms(
                lambda: bf_ops.bf_reference(k, t, params), 1, 1),
        })
    sfx = _suffix(case)
    times = {name.replace("_nu", "_nu" + sfx, 1): ms for name, ms in times.items()}
    print(f"general-nu kernel times [{case.layout} n{case.n} m{case.m}]: " + json.dumps(
        {**{f"{name}_ms": ms for name, ms in times.items()},
         "chains": case.phi.shape[0]}), flush=True)
    return times


# Operations of one call of kve_order (csrc/vecchia_bessel.cuh), counted from
# its code as (float32 operations, special-function operations); a float32
# division is one reciprocal and four operations of refinement.
TEMME_SETUP, TEMME_TERM = (42, 10), (34, 4)  # log, exp, sinh, exp(x), 4 divisions; 4 a term
CF2_SETUP, CF2_STEP = (28, 5), (33, 3)  # sqrt and 4 divisions; 3 a step
RECUR_STEP = (8, 1)  # one advance of the upward recurrence
RHO_TAIL = (6, 3)  # two logs and an exp around K_nu; rho_drho_general: twice that


def kernel_bounds_nu(case: Case) -> dict:
    """:func:`kernel_bounds` for the general-nu instances.  The bytes are
    those of the closed-form instances (kernel 2 writes two sums more).  The
    operations add, to the factorization and the solves, the Bessel
    evaluations this run's data needs: :func:`bessel.series_terms` gives, for
    every table entry and chain, the branch (Temme for t <= 2, CF2 above) and
    the terms or steps it runs until it converges to float32, as the kernel's
    loops do.  Entries below the floor of t (the padded slots among them)
    cost nothing.  Evaluations per entry, what the function needs and not
    what the kernel spends: kernels 1 and 3 one (rho); kernel 2 with a
    sampled nu three, one for rho with d rho / d phi (one evaluation yields
    K_nu and K_{nu-1}, below nu = 1/2 as K_{-nu} and K_{1-nu}) and two for
    the difference in nu (counted at nu, not at nu +- h); with a static nu
    one.  The kernel itself evaluates every pair of neighbors a fourth time
    (it does not keep d rho / d phi from the factorization to the
    contractions), which the bound does not forgive."""
    t, m = case.tab32, case.m
    chains = case.phi.shape[0]
    sites = t.n_pad * chains
    blocks = sites // 128
    tables = (t.tab_a.numel() + t.tab_b.numel()) * 4
    ids_y = t.nn_idx.numel() * 4 + t.n * 4
    flops = {"in": [], "tri": []}  # per chain: (flops, sfu, entries) of one evaluation each
    for c in range(chains):
        nu, phi = case.nu[c].double(), case.phi[c].double()
        for key, d in zip(("in", "tri"), distance_planes(t)):
            x = torch.sqrt(2.0 * nu) * d.double() / phi
            live = x >= 1e-8
            count, small = bessel.series_terms(torch.clamp(x, min=1e-8), nu)
            recur = max(int(torch.floor(nu + 0.5)) - 1, 0)

            def total(i):
                per = torch.where(small, TEMME_SETUP[i] + count * TEMME_TERM[i],
                                  CF2_SETUP[i] + count * CF2_STEP[i]) + recur * RECUR_STEP[i]
                return float((per * live).sum())

            flops[key].append((total(0), total(1), float(live.sum())))

    def bessel_ops(evals, tails):
        """(flops, sfu) of ``evals`` evaluations and ``tails`` units of
        RHO_TAIL per live entry of both tables."""
        out = [0.0, 0.0]
        for key in ("in", "tri"):
            for f, s, entries in flops[key]:
                for i, one in enumerate((f, s)):
                    out[i] += evals * one + tails * entries * RHO_TAIL[i]
        return out

    k1 = bessel_ops(1, 1)
    # kernel 2, per entry of either table: one rho with d rho / d phi (two
    # units of RHO_TAIL) and, with a sampled nu, two rho more
    k2 = bessel_ops(3, 4)
    k2_static = bessel_ops(1, 2)
    fact = sites * (m**3 / 3 + 2 * m * m)
    fact2 = sites * (m**3 / 3 + 10 * m * m)  # 7 m^2 as kernel 2, 3 m^2 more for dC/dnu
    work = {
        "vecchia_suffstats_nu": (tables + ids_y + (2 * sites + 2 * blocks) * 4,
                                 fact + k1[0], k1[1] + m * sites),
        "vecchia_grad_nu": (tables + ids_y + 8 * blocks * 4,
                            fact2 + k2[0], k2[1] + m * sites),
        "vecchia_grad_y_nu": (tables + t.nn_idx.numel() * 4 + chains * t.n * 4
                              + 8 * blocks * 4 + (m + 1) * sites * 4,
                              fact2 + k2[0], k2[1] + m * sites),
        "vecchia_bf_nu": (tables + (m + 1) * sites * 4, fact + k1[0], k1[1] + m * sites),
        "vecchia_grad_nu_static": (tables + ids_y + 8 * blocks * 4,
                                   sites * (m**3 / 3 + 7 * m * m) + k2_static[0],
                                   k2_static[1] + m * sites),
    }
    if case.v32 is not None:
        work = {name: (nbytes + noise_bytes(t, name), ops + noise_flops(m, name) * sites,
                       sfu) for name, (nbytes, ops, sfu) in work.items()}
    dist_flops, dist_sfu = distance_work(t)
    work = {name.replace("_nu", "_nu" + _suffix(case), 1) + _large(case, name) + _hetero(case):
            (nbytes, ops + dist_flops, sfu + dist_sfu)
            for name, (nbytes, ops, sfu) in work.items()}
    out = {}
    for name, (nbytes, ops, sfu) in work.items():
        byte_ms = nbytes / PEAK_BYTES * 1e3
        op_ms = max(ops / PEAK_FLOPS, sfu / PEAK_SFU) * 1e3
        out[name] = (max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms else "operations")
    entries = sum(e for key in flops for _, _, e in flops[key])
    print(f"general-nu kernel bounds [{case.layout}{_hetero(case)} n{case.n} m{case.m}]: "
          + json.dumps({
        "bessel_evaluations_per_entry_kernel_1": 1,
        "bessel_evaluations_per_entry_kernel_2": 3,
        "bessel_evaluations_per_entry_kernel_2_static_nu": 1,
        "bessel_evaluations_per_pair_kernel_2_spends": 4,
        "mean_series_flops_per_evaluation": sum(f for key in flops for f, _, _ in flops[key]) / entries,
        "mean_series_special_per_evaluation": sum(s for key in flops for _, s, _ in flops[key]) / entries,
        "live_entries": entries,
        **{k: {"bound_ms": v[0], "bound_by": v[1], "bytes": work[k][0],
               "flops": work[k][1], "special": work[k][2]} for k, v in out.items()}}),
          flush=True)
    return out


def _chain_stats(draws):
    """(min-ESS, max split-R-hat) over the (sigma2, phi, tau2) marginals, and
    nu's where it was sampled."""
    min_ess, max_rhat = np.inf, 0.0
    for key in ("phi", "sigma2", "tau2") + (("nu",) if "nu" in draws else ()):
        min_ess = min(min_ess, diagnostics.ess(draws[key]))
        max_rhat = max(max_rhat, diagnostics.split_rhat(draws[key]))
    return float(min_ess), float(max_rhat)


def _reset_counts() -> None:
    for name, (_, _, count) in KERNEL_ROWS.items():
        count.reset()
        SHARDED[name].reset()


def _read_counts(path: str, expected: tuple) -> dict:
    """Launch counts since the last reset, each row's sharded launches (a
    call over several mesh cells) included and also listed under
    ``<row>_sharded`` where there were any; fails unless every kernel of
    ``expected`` (row names, or ``<row>_sharded``) was launched and no plain
    version was called."""
    sharded = {name + "_sharded": SHARDED[name].launches for name in KERNEL_ROWS
               if SHARDED[name].launches}
    launches = {name: row[2].launches + SHARDED[name].launches
                for name, row in KERNEL_ROWS.items()}
    plain = {name: row[2].plain + SHARDED[name].plain
             for name, row in KERNEL_ROWS.items()}
    launches.update(sharded)
    _require(all(launches.get(name, 0) > 0 for name in expected),
             f"a kernel was not launched on the {path} path: {launches}")
    _require(all(v == 0 for v in plain.values()),
             f"the {path} path reached a plain version: {plain}")
    return launches


def _mwg_recipe(model, pilot: tuple, run: tuple, tag: str) -> dict:
    """bench.py's bench_ess MWG recipe (l.440-503) on ``model``: fit_map(250),
    a correlated-RW pilot of ``pilot`` = (burn-in, draws) steps from the MAP
    point with the projected Laplace covariance, then ``run`` = (burn-in,
    draws) independence-mixture steps fitted to the pilot; 16 chains.
    Returns the phases' seconds, min-ESS over MAP + pilot + run seconds
    (bench_ess's denominator), R-hat, posterior means, the draws, the MAP
    fit and the initial point."""
    t0 = time.perf_counter()
    mp = model.fit_map(n_steps=250)
    u0 = mp.u.cpu().numpy()
    map_s = time.perf_counter() - t0
    sig0, tau0 = float(np.exp(u0[0])), float(np.exp(u0[2]))
    init = {
        "sigma2": sig0,
        "phi": float(model._t_phi.forward(torch.as_tensor(u0[1]))),
        "alpha": tau0 / sig0,
    }

    t0 = time.perf_counter()
    draws = model.sample(pilot[1], n_burn=pilot[0], n_chains=CHAINS, init=init,
                         seed=101,
                         proposal_cov=model.theta_proposal_cov(mp.laplace_cov))
    u_pilot = np.stack([
        model._t_phi.inverse(torch.as_tensor(draws["phi"])).numpy().ravel(),
        np.log(draws["tau2"] / draws["sigma2"]).ravel(),
    ], axis=1)
    emp_cov = np.cov(u_pilot.T) * 1.2  # slight inflation: tail safety
    emp_mean = u_pilot.mean(axis=0)
    pilot_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    draws = model.sample(run[1], n_burn=run[0], n_chains=CHAINS, init=init, seed=0,
                         proposal_cov=emp_cov, proposal_center=emp_mean)
    run_s = time.perf_counter() - t0
    min_ess, max_rhat = _chain_stats(draws)
    return {
        "map_s": map_s, "pilot_s": pilot_s, "run_s": run_s,
        f"min_ess_per_sec_{tag}": min_ess / (run_s + pilot_s + map_s),
        "min_ess": min_ess, "rhat_max": max_rhat, "map_value": float(mp.value),
        "posterior_mean": {k: float(np.mean(draws[k])) for k in ("sigma2", "phi", "tau2")},
        "draws_shape": list(draws["phi"].shape), "init": init,
        "draws": draws, "map_fit": mp,
    }


def main_path(dev) -> tuple:
    """bench.py's bench_ess MWG branch on the port: the same generator and
    seed, fit_map(250), a 16 x 1200 correlated-RW pilot with 800 burn-in,
    then 16 x 3000 independence-mixture draws with 500 burn-in (the recipe's
    6000, halved to keep the script well under its time limit).  Returns
    (the path's numbers, its draws)."""
    coords, y = bench_field(N_MAIN, seed=0)
    _reset_counts()
    t0 = time.perf_counter()
    model = ResponseNNGP(coords, y, kernel="sqexp", m=M_MAIN, device=dev)
    setup_s = time.perf_counter() - t0
    res = {"setup_s": setup_s, "lane_layout": model.lane_layout,
           **_mwg_recipe(model, (800, 1200), (500, 3000), f"n{N_MAIN}_m{M_MAIN}")}
    draws = res.pop("draws")
    del res["map_fit"], res["init"]
    launches = _read_counts("response", ("vecchia_suffstats", "vecchia_grad"))
    res.update(launches=launches, plain_calls=0)
    print("main path: " + json.dumps(res), flush=True)
    _require(all(np.isfinite(v).all() for v in draws.values()),
             "non-finite draws")
    _require(draws["phi"].shape == (CHAINS, 3000), "draws have the wrong shape")
    tau2 = res["posterior_mean"]["tau2"]
    _require(TAU2_TRUE / 2 <= tau2 <= TAU2_TRUE * 2,
             f"posterior mean tau2 {tau2} is not within 2x of 0.09")
    return res, draws


def config2_field(n: int, scale: float, rng, noise_v=None):
    """bench.py's ``_field`` (l.724-730): a 128-feature RFF draw on uniform
    sites plus N(0, 0.3^2) noise, from the caller's generator; with
    ``noise_v``, N(0, 0.3^2 v_i) from the same draws."""
    coords = rng.uniform(size=(n, 2))
    freqs = rng.normal(scale=scale, size=(128, 2))
    ph = rng.uniform(0, 2 * np.pi, 128)
    w = np.sqrt(2 / 128) * np.cos(coords @ freqs.T + ph).sum(axis=1)
    sd = 0.3 if noise_v is None else 0.3 * np.sqrt(noise_v)
    return coords, w + sd * rng.standard_normal(n)


def _step_ms(step, state, gen, steps: int):
    """(wall ms per sampler step, the state after them), unprofiled, ending
    in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(gen, state)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps, state


def profile_steps(step, state, gen, steps: int = 5, wall_steps: int = 20) -> dict:
    """Where a sampler step's time goes, for ``step(gen, state) -> state``:
    device-busy ms per step from the kernels that torch.profiler records over
    ``steps`` steps, against the wall ms per step of ``wall_steps``
    unprofiled steps (the profiler itself slows the host).  The idle share is the part of the
    unprofiled wall clock in which no kernel ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wall_ms, state = _step_ms(step, state, gen, wall_steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state = step(gen, state)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device-side rows only: an operator's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(ms for _, ms, _ in rows)
    _require(busy_ms > 0, "torch.profiler recorded no device time")
    top = sorted(rows, key=lambda r: -r[1])[:4]
    return {
        "wall_ms_per_step": wall_ms, "profiled_wall_ms_per_step": profiled_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "bf_kernel_ms_per_step": sum(ms for k, ms, _ in rows if "bf_kernel" in k),
        "grad_kernel_ms_per_step": sum(ms for k, ms, _ in rows if "grad_kernel" in k),
        "grad_kernel_launches_per_step": sum(c for k, _, c in rows if "grad_kernel" in k),
        "device_kernels_per_step": sum(c for _, _, c in rows),
        "top": [[k[:60], ms] for k, ms, _ in top],
    }


def latent_path(dev) -> dict:
    """bench.py's config 2 (l.784-823) on the port: the latent-w NNGP at
    n=10,000, m=15, exponential, 8 chains, 500 draws after 250 burn-in with
    w_every=8 (the config's 1000 after 500, halved to keep the script well
    under its time limit), doubled up to twice while split-R-hat > 1.05."""
    n, chains = 10_000, 8
    coords, y = config2_field(n, 10.0, np.random.default_rng(0))
    _reset_counts()
    t0 = time.perf_counter()
    model = LatentNNGP(coords, y, kernel="exponential", m=M_MAIN, device=dev)
    setup_s = time.perf_counter() - t0
    init = {"sigma2": float(np.var(y)) * 0.8, "phi": 0.1,
            "tau2": float(np.var(y)) * 0.15}
    n_draws, run_s, steps = 500, 0.0, 0
    for attempt in range(3):  # size the run to the R-hat gate
        t0 = time.perf_counter()
        draws = model.sample(n_draws, n_burn=n_draws // 2, n_chains=chains,
                             seed=attempt, init=init, w_every=8)
        run_s += time.perf_counter() - t0
        steps += n_draws + n_draws // 2
        min_ess, max_rhat = _chain_stats(draws)
        if max_rhat <= 1.05:
            break
        n_draws *= 2
    launches = _read_counts("latent n=10,000", ("vecchia_bf",))
    means = {k: float(np.mean(draws[k])) for k in ("sigma2", "phi", "tau2")}
    res = {
        "setup_s": setup_s, "run_s": run_s, "colors": model.n_colors,
        "attempts": attempt + 1, "n_draws": n_draws, "steps": steps,
        "steps_per_sec": steps / run_s,
        f"config2_latent_mwg_ess_per_sec_n{n}": min_ess / run_s,
        "min_ess": min_ess, "rhat_max": max_rhat, "posterior_mean": means,
        "launches": launches, "plain_calls": 0,
        "w_shape": list(draws["w"].shape),
    }
    print("latent path: " + json.dumps(res), flush=True)
    _require(all(np.isfinite(v).all() for v in draws.values()),
             "non-finite latent draws")
    _require(draws["w"].shape == (chains, -(-n_draws // 8), n),
             f"w draws have the wrong shape {draws['w'].shape}")
    _require(draws["phi"].shape == (chains, n_draws), "draws have the wrong shape")
    _require(TAU2_TRUE / 2 <= means["tau2"] <= TAU2_TRUE * 2,
             f"posterior mean tau2 {means['tau2']} is not within 2x of 0.09")
    gen = torch.Generator(device=dev).manual_seed(7)
    prof = profile_steps(model.step, model.init_state(chains, init), gen)
    print("latent step profile [n10000]: " + json.dumps(prof), flush=True)
    return res


def latent_path_large(dev) -> dict:
    """The same model at the data scale of the response path: n=100,000,
    m=15, exponential, 8 chains, 150 draws after 150 burn-in, w_every=8."""
    n, chains, n_burn, n_draws = N_MAIN, 8, 150, 150
    coords, y = bench_field(n, seed=0)
    _reset_counts()
    t0 = time.perf_counter()
    model = LatentNNGP(coords, y, kernel="exponential", m=M_MAIN, device=dev)
    setup_s = time.perf_counter() - t0
    init = {"sigma2": float(np.var(y)) * 0.8, "phi": 0.1,
            "tau2": float(np.var(y)) * 0.15}
    t0 = time.perf_counter()
    draws = model.sample(n_draws, n_burn=n_burn, n_chains=chains, seed=0,
                         init=init, w_every=8)
    run_s = time.perf_counter() - t0
    launches = _read_counts("latent n=100,000", ("vecchia_bf",))
    gen = torch.Generator(device=dev).manual_seed(7)
    state = model.init_state(chains, init)
    res = {
        "setup_s": setup_s, "run_s": run_s, "colors": model.n_colors,
        "ms_per_step": run_s * 1e3 / (n_burn + n_draws),
        "posterior_mean": {k: float(np.mean(draws[k]))
                           for k in ("sigma2", "phi", "tau2")},
        "launches": launches, "plain_calls": 0,
        "w_shape": list(draws["w"].shape),
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print("latent path [n100000]: " + json.dumps(res), flush=True)
    _require(all(np.isfinite(v).all() for v in draws.values()),
             "non-finite latent draws at n=100,000")
    _require(draws["w"].shape == (chains, -(-n_draws // 8), n),
             f"w draws have the wrong shape {draws['w'].shape}")
    prof = profile_steps(model.step, state, gen)
    print("latent step profile [n100000]: " + json.dumps(prof), flush=True)
    return res


def fixed_effects_path(dev) -> dict:
    """The response NNGP with an intercept and one covariate on the
    n=100,000 field plus x @ [1, -2]: 16 chains, 100 componentwise MWG draws
    after 100 burn-in.  Every proposal is one kernel-3 launch."""
    n_burn, n_draws = 100, 100
    coords, y = bench_field(N_MAIN, seed=0)
    x = np.column_stack([np.ones(N_MAIN),
                         np.random.default_rng(1).standard_normal(N_MAIN)])
    beta_true = np.array([1.0, -2.0])
    _reset_counts()
    t0 = time.perf_counter()
    model = ResponseNNGP(coords, y + x @ beta_true, kernel="sqexp", m=M_MAIN,
                         x=x, device=dev)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    init = {"sigma2": 1.0, "phi": 0.1, "alpha": 0.1}
    draws = model.sample(n_draws, n_burn=n_burn, n_chains=CHAINS, seed=0,
                         init=init)
    run_s = time.perf_counter() - t0
    launches = _read_counts("fixed-effects", ("vecchia_bf",))
    beta_mean = draws["beta"].mean(axis=(0, 1))
    res = {
        "setup_s": setup_s, "run_s": run_s,
        "ms_per_step": run_s * 1e3 / (n_burn + n_draws),
        "beta_mean": beta_mean.tolist(), "beta_true": beta_true.tolist(),
        "posterior_mean": {k: float(np.mean(draws[k]))
                           for k in ("sigma2", "phi", "tau2")},
        "launches": launches, "plain_calls": 0,
        "beta_shape": list(draws["beta"].shape),
    }
    print("fixed-effects path: " + json.dumps(res), flush=True)
    _require(all(np.isfinite(v).all() for v in draws.values()),
             "non-finite fixed-effects draws")
    _require(draws["beta"].shape == (CHAINS, n_draws, 2),
             "beta draws have the wrong shape")
    _require(abs(beta_mean[1] - beta_true[1]) <= 0.1,
             f"posterior mean slope {beta_mean[1]} is not within 0.1 of -2")
    gen = torch.Generator(device=dev).manual_seed(7)
    prof = profile_steps(model.step, model.init_state(CHAINS, init), gen)
    print("fixed-effects step profile: " + json.dumps(prof), flush=True)
    return res


def _digest(draws: dict) -> str:
    """sha256 over the draws' bytes: equal between two runs iff every draw is."""
    h = hashlib.sha256()
    for key in sorted(draws):
        h.update(key.encode() + np.ascontiguousarray(draws[key]).tobytes())
    return h.hexdigest()[:16]


def _nuts_summary(draws, n_burn, launches_name, launches) -> dict:
    n_chains, n_draws = draws["phi"].shape
    min_ess, max_rhat = _chain_stats(draws)
    return {
        "min_ess": min_ess, "rhat_max": max_rhat,
        "mean_tree_depth": float(draws["depth"].mean()),
        "leapfrogs_per_draw": float(draws["n_leapfrog"].mean()),
        "divergences": int(draws["diverging"].sum()),
        "posterior_mean": {k: float(np.mean(draws[k]))
                           for k in ("sigma2", "phi", "tau2", "nu") if k in draws},
        # every chain waits for the deepest tree of its transition
        f"{launches_name}_launches_per_transition": launches / (n_burn + n_draws),
        "draws_shape": [n_chains, n_draws], "draws_sha256": _digest(draws),
    }


def profile_nuts(model, mp, chains: int, max_depth: int, warm: int = 40,
                 wall_steps: int = 20, value_and_grad: bool = False) -> dict:
    """profile_steps over two NUTS transitions of ``model`` from its MAP fit
    (a transition's thousands of profiler events cost seconds to read), after
    ``warm`` transitions of warmup, with the per-leapfrog figures that follow
    from the kernel-2 launches of the window and, with ``value_and_grad``,
    a profile of the value and gradient alone."""
    gen = torch.Generator().manual_seed(7)  # the samplers' state is on the host
    init_fn, step_fn = make_nuts_kernel(model.full_value_and_grad, 300, max_depth,
                                        init_inv_mass=mp.laplace_cov)
    state = init_fn(gen, model._warm_init_u(mp.u, mp.laplace_cov, chains, gen, 2.0))
    for _ in range(warm):
        state = step_fn(gen, state)
    prof = profile_steps(step_fn, state, gen, steps=2, wall_steps=wall_steps)
    per = max(prof["grad_kernel_launches_per_step"], 1.0)
    prof["wall_ms_per_leapfrog"] = prof["wall_ms_per_step"] / per
    prof["device_busy_ms_per_leapfrog"] = prof["device_busy_ms_per_step"] / per
    prof["device_kernels_per_leapfrog"] = prof["device_kernels_per_step"] / per
    prof["grad_kernel_ms_per_launch"] = prof["grad_kernel_ms_per_step"] / per
    if not value_and_grad:
        return prof
    # the share of a leapfrog that is the value and gradient of the posterior
    # (kernel 2, the eager ops around it and their backward), on its own
    vg = profile_steps(lambda _, u: (model.full_value_and_grad(u), u)[1],
                       state.z, gen)
    prof["value_and_grad"] = {k: vg[k] for k in (
        "wall_ms_per_step", "device_busy_ms_per_step", "device_kernels_per_step")}
    return prof


def nuts_path(dev, mwg_ess_per_sec: float) -> dict:
    """bench.py's bench_ess NUTS branch (l.392-434) on the port, on the main
    path's model and data: fit_map(250), then 4 chains x 200 NUTS draws after
    150 burn-in at max_depth 6 (the recipe's 400 after 300, halved to keep
    the script well under its time limit), started 2 posterior sds around
    the MAP with the dense Laplace covariance as the frozen metric.  Then a
    short HMC run on the same model, 4 x (50 + 25) (halved from 100 + 50 for
    the same reason)."""
    chains, n_burn, n_draws, max_depth = 4, 150, 200, 6
    coords, y = bench_field(N_MAIN, seed=0)
    _reset_counts()
    model = ResponseNNGP(coords, y, kernel="sqexp", m=M_MAIN, device=dev)
    t0 = time.perf_counter()
    mp = model.fit_map(n_steps=250)
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    map_launches = diff_ops.COUNT.launches
    t0 = time.perf_counter()
    draws = model.sample_nuts(n_draws, n_burn=n_burn, n_chains=chains, seed=0,
                              max_depth=max_depth, init_u=mp.u,
                              init_inv_mass=mp.laplace_cov, init_jitter=2.0)
    run_s = time.perf_counter() - t0
    nuts_launches = diff_ops.COUNT.launches - map_launches
    t0 = time.perf_counter()
    hmc = model.sample_hmc(25, n_burn=50, n_chains=chains, seed=1, n_leapfrog=32,
                           init_u=mp.u, init_inv_mass=mp.laplace_cov)
    hmc_s = time.perf_counter() - t0
    launches = _read_counts("NUTS and HMC", ("vecchia_grad",))
    res = {
        "map_s": map_s, "run_s": run_s,
        "samples_per_sec": chains * n_draws / run_s,
        **_nuts_summary(draws, n_burn, "vecchia_grad", nuts_launches),
        f"mwg_min_ess_per_sec_n{N_MAIN}_m{M_MAIN}": mwg_ess_per_sec,
        "launches": launches, "plain_calls": 0,
    }
    res[f"nuts_min_ess_per_sec_n{N_MAIN}_m{M_MAIN}"] = res["min_ess"] / (map_s + run_s)
    print("NUTS path: " + json.dumps(res), flush=True)
    _require(all(np.isfinite(v).all() for v in draws.values()), "non-finite NUTS draws")
    _require(draws["phi"].shape == (chains, n_draws), "NUTS draws have the wrong shape")
    tau2 = res["posterior_mean"]["tau2"]
    _require(TAU2_TRUE / 2 <= tau2 <= TAU2_TRUE * 2,
             f"NUTS posterior mean tau2 {tau2} is not within 2x of 0.09")
    _require(draws["depth"].max() <= max_depth
             and draws["n_leapfrog"].max() <= 2**max_depth - 1,
             "a NUTS tree exceeded its depth limit")
    print("HMC run: " + json.dumps({
        "run_s": hmc_s, "mean_accept_prob": float(hmc["accept_prob"].mean()),
        "divergences": int(hmc["diverging"].sum()),
        "posterior_mean": {k: float(np.mean(hmc[k])) for k in ("sigma2", "phi", "tau2")},
        "vecchia_grad_launches": launches["vecchia_grad"] - map_launches - nuts_launches,
        "draws_shape": list(hmc["phi"].shape), "draws_sha256": _digest(hmc),
    }), flush=True)
    _require(all(np.isfinite(v).all() for v in hmc.values()), "non-finite HMC draws")
    _require(hmc["phi"].shape == (chains, 25), "HMC draws have the wrong shape")
    print("NUTS transition profile: " + json.dumps(
        profile_nuts(model, mp, chains, max_depth, value_and_grad=True)), flush=True)
    return res


def nuts_fixed_effects_path(dev) -> dict:
    """NUTS with fixed effects on the fixed-effects path's data: fit_map(250)
    with x=, then 4 chains x 50 draws after 75 burn-in at max_depth 6 with
    the dense Laplace metric (halved from 100 after 150 to keep the script
    under its time limit).  Every leapfrog step is one launch of the EMIT_Y
    instances of kernel 2 and one y-cotangent gather."""
    chains, n_burn, n_draws, max_depth = 4, 75, 50, 6
    coords, y = bench_field(N_MAIN, seed=0)
    x = np.column_stack([np.ones(N_MAIN),
                         np.random.default_rng(1).standard_normal(N_MAIN)])
    beta_true = np.array([1.0, -2.0])
    _reset_counts()
    model = ResponseNNGP(coords, y + x @ beta_true, kernel="sqexp", m=M_MAIN,
                         x=x, device=dev)
    t0 = time.perf_counter()
    mp = model.fit_map(n_steps=250)
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    map_launches = diff_ops.COUNT_Y.launches
    t0 = time.perf_counter()
    draws = model.sample_nuts(n_draws, n_burn=n_burn, n_chains=chains, seed=0,
                              max_depth=max_depth, init_u=mp.u,
                              init_inv_mass=mp.laplace_cov, init_jitter=2.0)
    run_s = time.perf_counter() - t0
    launches = _read_counts("NUTS with fixed effects", ("vecchia_grad_y",))
    beta_mean = draws["beta"].mean(axis=(0, 1))
    res = {
        "map_s": map_s, "run_s": run_s, "map_u": mp.u.cpu().tolist(),
        "samples_per_sec": chains * n_draws / run_s,
        **_nuts_summary(draws, n_burn, "vecchia_grad_y",
                        launches["vecchia_grad_y"] - map_launches),
        "beta_mean": beta_mean.tolist(), "beta_true": beta_true.tolist(),
        "launches": launches, "plain_calls": 0,
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print("NUTS fixed-effects path: " + json.dumps(res), flush=True)
    _require(all(np.isfinite(v).all() for v in draws.values()),
             "non-finite NUTS draws with fixed effects")
    _require(draws["beta"].shape == (chains, n_draws, 2),
             "beta draws have the wrong shape")
    _require(abs(beta_mean[1] - beta_true[1]) <= 0.1,
             f"NUTS posterior mean slope {beta_mean[1]} is not within 0.1 of -2")
    print("NUTS fixed-effects transition profile: "
          + json.dumps(profile_nuts(model, mp, chains, max_depth)), flush=True)
    return res


TAU2_NU = 0.1  # config 3's noise variance


def matern_nu_nuts_path(dev, field) -> tuple:
    """bench.py's config 3 (l.825-895) on the port, uncut: the response NNGP
    with a sampled-nu Matern at n=25,000, m=10, fit_map(300), then NUTS over
    (sigma2, phi, tau2, nu): 2 chains x 200 draws after 150 burn-in at
    max_depth 6, started 2 posterior sds around the MAP with the dense Laplace
    covariance as the frozen metric, doubled up to twice while split-R-hat >
    1.05.  Every MAP step and every leapfrog step is one launch of kernel 2's
    general-nu instances with the two nu sums.  Returns (result, model, MAP
    fit) for the MWG path on the same model."""
    coords, y = field
    chains, max_depth, keys = 2, 6, ("sigma2", "tau2", "phi", "nu")
    _reset_counts()
    t_all = time.perf_counter()
    model = ResponseNNGP(coords, y, kernel=Matern(), m=M_NU, device=dev)
    setup_s = time.perf_counter() - t_all
    t0 = time.perf_counter()
    mp = model.fit_map(n_steps=300)
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    map_launches = diff_ops.COUNT_NU.launches
    n_s, sample_s, transitions = 200, 0.0, 0
    for attempt in range(3):  # size the run to the R-hat gate
        n_burn = max(150, n_s // 2)
        t0 = time.perf_counter()
        draws = model.sample_nuts(n_s, n_burn=n_burn, n_chains=chains, seed=attempt,
                                  max_depth=max_depth, init_u=mp.u,
                                  init_inv_mass=mp.laplace_cov, init_jitter=2.0)
        sample_s += time.perf_counter() - t0
        transitions += n_s + n_burn
        min_ess = min(diagnostics.ess(draws[k]) for k in keys)
        rhat = max(diagnostics.split_rhat(draws[k]) for k in keys)
        if rhat <= 1.05 or attempt == 2:
            break
        n_s *= 2
    total_s = time.perf_counter() - t_all  # MAP fit and set-up included
    launches = _read_counts("sampled-nu NUTS", ("vecchia_grad_nu",))
    nuts_launches = launches["vecchia_grad_nu"] - map_launches
    summary = _nuts_summary(draws, n_burn, "vecchia_grad_nu", nuts_launches)
    summary["vecchia_grad_nu_launches_per_transition"] = nuts_launches / transitions
    res = {
        "setup_s": setup_s, "map_s": map_s, "sample_seconds": sample_s,
        "total_seconds": total_s, "attempts": attempt + 1, "n_draws": n_s,
        "samples_per_sec": chains * n_s / sample_s, **summary,
        f"config3_matern_nu_nuts_ess_per_sec_n{N_NU}": float(min_ess) / total_s,
        "min_ess": float(min_ess), "rhat_max": float(rhat),
        "converged": bool(rhat <= 1.05),
        "map": {k: float(v) for k, v in zip(
            ("sigma2", "phi", "tau2", "nu"),
            (torch.exp(mp.u[0]), model._t_phi.forward(mp.u[1]), torch.exp(mp.u[2]),
             model._t_nu.forward(mp.u[3])))},
        "ms_per_launch": sample_s * 1e3 / nuts_launches,
        "launches": launches, "plain_calls": 0,
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print("sampled-nu NUTS path [config 3]: " + json.dumps(res), flush=True)
    _require(all(np.isfinite(v).all() for v in draws.values()),
             "non-finite sampled-nu NUTS draws")
    _require(draws["nu"].shape == (chains, n_s), "sampled-nu draws have the wrong shape")
    _require(map_launches >= 300, f"fit_map launched kernel 2 {map_launches} times")
    _require(nuts_launches >= transitions,
             "fewer kernel-2 launches than NUTS transitions")
    means = res["posterior_mean"]
    _require(TAU2_NU / 2 <= means["tau2"] <= TAU2_NU * 2,
             f"posterior mean tau2 {means['tau2']} is not within 2x of {TAU2_NU}")
    _require(0.3 < means["nu"] < 2.8,
             f"posterior mean nu {means['nu']} sits on a bound of its prior")
    print("sampled-nu NUTS transition profile: "
          + json.dumps(profile_nuts(model, mp, chains, max_depth)), flush=True)
    return res, model, mp


def matern_nu_nuts_fixed_effects_path(dev, field) -> dict:
    """Fixed effects with a sampled nu: config 3's data plus x @ [1, -2],
    fit_map(150) with x=, then 2 chains x 30 NUTS draws after 50 burn-in at
    max_depth 5 (no reference recipe; cut to a few seconds).  Every step is
    one launch of kernel 2's general-nu EMIT_Y instances and one y-cotangent
    gather."""
    coords, y = field
    chains, n_burn, n_draws, max_depth = 2, 50, 30, 5
    x = np.column_stack([np.ones(N_NU), np.random.default_rng(1).standard_normal(N_NU)])
    beta_true = np.array([1.0, -2.0])
    _reset_counts()
    model = ResponseNNGP(coords, y + x @ beta_true, kernel=Matern(), m=M_NU, x=x,
                         device=dev)
    t0 = time.perf_counter()
    mp = model.fit_map(n_steps=150)
    map_launches = diff_ops.COUNT_Y_NU.launches
    draws = model.sample_nuts(n_draws, n_burn=n_burn, n_chains=chains, seed=0,
                              max_depth=max_depth, init_u=mp.u,
                              init_inv_mass=mp.laplace_cov, init_jitter=2.0)
    run_s = time.perf_counter() - t0
    launches = _read_counts("sampled-nu NUTS with fixed effects", ("vecchia_grad_y_nu",))
    beta_mean = draws["beta"].mean(axis=(0, 1))
    res = {
        "map_and_run_s": run_s,
        **_nuts_summary(draws, n_burn, "vecchia_grad_y_nu",
                        launches["vecchia_grad_y_nu"] - map_launches),
        "beta_mean": beta_mean.tolist(), "beta_true": beta_true.tolist(),
        "launches": launches, "plain_calls": 0,
    }
    print("sampled-nu NUTS fixed-effects path: " + json.dumps(res), flush=True)
    _require(all(np.isfinite(v).all() for v in draws.values()),
             "non-finite sampled-nu NUTS draws with fixed effects")
    _require(draws["beta"].shape == (chains, n_draws, 2), "beta draws have the wrong shape")
    _require(abs(beta_mean[1] - beta_true[1]) <= 0.1,
             f"posterior mean slope {beta_mean[1]} is not within 0.1 of -2")
    return res


def matern_nu_mwg_path(dev, model, mp) -> dict:
    """The MWG sampler of config 3's model, theta block (phi, alpha, nu): 16
    chains, 300 draws after 200 burn-in from the MAP point with the projected
    Laplace covariance as the proposal.  Every proposal is one launch of
    kernel 1's general-nu instances."""
    n_burn, n_draws = 200, 300
    u0 = mp.u.cpu()
    sig0, tau0 = float(torch.exp(u0[0])), float(torch.exp(u0[2]))
    init = {"sigma2": sig0, "phi": float(model._t_phi.forward(u0[1])),
            "alpha": tau0 / sig0, "nu": float(model._t_nu.forward(u0[3]))}
    _reset_counts()
    t0 = time.perf_counter()
    draws = model.sample(n_draws, n_burn=n_burn, n_chains=CHAINS, init=init, seed=0,
                         proposal_cov=model.theta_proposal_cov(mp.laplace_cov))
    run_s = time.perf_counter() - t0
    launches = _read_counts("sampled-nu MWG", ("vecchia_suffstats_nu",))
    min_ess, max_rhat = _chain_stats(draws)
    means = {k: float(np.mean(draws[k])) for k in ("sigma2", "phi", "tau2", "nu")}
    res = {
        "run_s": run_s, "ms_per_step": run_s * 1e3 / (n_burn + n_draws),
        "min_ess": min_ess, "rhat_max": max_rhat, "posterior_mean": means,
        "launches": launches, "plain_calls": 0,
        "draws_shape": list(draws["nu"].shape),
    }
    print("sampled-nu MWG path: " + json.dumps(res), flush=True)
    _require(all(np.isfinite(v).all() for v in draws.values()),
             "non-finite sampled-nu MWG draws")
    _require(draws["nu"].shape == (CHAINS, n_draws), "MWG nu draws have the wrong shape")
    _require(launches["vecchia_suffstats_nu"] >= n_burn + n_draws,
             "fewer kernel-1 launches than MWG steps")
    _require(TAU2_NU / 2 <= means["tau2"] <= TAU2_NU * 2,
             f"MWG posterior mean tau2 {means['tau2']} is not within 2x of {TAU2_NU}")
    _require(0.3 < means["nu"] < 2.8,
             f"MWG posterior mean nu {means['nu']} sits on a bound of its prior")
    gen = torch.Generator(device=dev).manual_seed(7)
    prof = profile_steps(model.step, model.init_state(CHAINS, init), gen)
    print("sampled-nu MWG step profile: " + json.dumps(prof), flush=True)
    return res


def matern_nu_latent_path(dev, field, start) -> dict:
    """The latent-w NNGP with ``Matern()`` on the first 10,000 sites of
    config 3's data: m=10, 8 chains, 100 draws after 150 burn-in (200 after
    300 until the script neared its time limit), w_every=8,
    theta block (phi, nu), started at ``start``, the response model's MAP
    estimate of (sigma2, phi, tau2, nu) on all 25,000 sites.  Every proposal
    is one launch of kernel 3's general-nu instances, two a step.  The gates
    are those of the response paths: tau2 within 2x of 0.1 and nu off its
    prior's bounds; sigma2, phi and nu move along their ridge for longer than
    this run and have none.

    The call a user would make first, ``LatentNNGP(coords, y,
    kernel=Matern(), m=10)`` with the default jitter 1e-6, is made first from
    a cold start at the generator's phi = 0.15 and nu = 1, and what it does
    is printed.  Without a nugget (alpha = 0) the conditional variance F of a
    site that nearly repeats a neighbor is the jitter itself, and 1 + 1e-6
    has three bits in float32: at that start one site of these 10,000 comes
    out at F = 0 exactly where float64 gives 1.1e-6.  init_state raises there
    and names jitter; the run follows its advice with jitter=1e-4.  The
    exponential kernel of the other latent paths never gets there (1 - rho
    falls like d, not d^2)."""
    n, chains, n_burn, n_draws = 10_000, 8, 150, 100
    coords, y = field[0][:n], field[1][:n]
    cold = {"sigma2": float(np.var(y)) * 0.8, "phi": 0.15, "nu": 1.0,
            "tau2": float(np.var(y)) * 0.1}
    try:
        LatentNNGP(coords, y, kernel=Matern(), m=M_NU, device=dev).init_state(chains, cold)
        default_call = "starts at a finite log-density"
    except ValueError as err:
        _require("jitter" in str(err), f"the default call fails without naming jitter: {err}")
        default_call = "raises ValueError naming jitter"
    _reset_counts()
    t0 = time.perf_counter()
    model = LatentNNGP(coords, y, kernel=Matern(), m=M_NU, jitter=1e-4, device=dev)
    setup_s = time.perf_counter() - t0
    init = {k: float(start[k]) for k in ("sigma2", "phi", "tau2", "nu")}
    t0 = time.perf_counter()
    draws = model.sample(n_draws, n_burn=n_burn, n_chains=chains, seed=0, init=init,
                         w_every=8)
    run_s = time.perf_counter() - t0
    launches = _read_counts("sampled-nu latent", ("vecchia_bf_nu",))
    means = {k: float(np.mean(draws[k])) for k in ("sigma2", "phi", "tau2", "nu")}
    res = {
        "setup_s": setup_s, "run_s": run_s, "colors": model.n_colors,
        "ms_per_step": run_s * 1e3 / (n_burn + n_draws), "posterior_mean": means,
        "launches": launches, "plain_calls": 0, "w_shape": list(draws["w"].shape),
        "default_jitter_call": default_call, "start": init,
        "mean_by_fifth": {k: [float(np.mean(part)) for part in
                              np.array_split(draws[k], 5, axis=1)]
                          for k in ("sigma2", "phi", "tau2", "nu")},
    }
    res["min_ess"], res["rhat_max"] = _chain_stats(draws)
    print("sampled-nu latent path [n10000]: " + json.dumps(res), flush=True)
    _require(all(np.isfinite(v).all() for v in draws.values()),
             "non-finite sampled-nu latent draws")
    _require(draws["w"].shape == (chains, -(-n_draws // 8), n),
             f"w draws have the wrong shape {draws['w'].shape}")
    _require(draws["nu"].shape == (chains, n_draws), "latent nu draws have the wrong shape")
    _require(launches["vecchia_bf_nu"] >= n_burn + n_draws,
             "fewer kernel-3 launches than latent steps")
    _require(TAU2_NU / 2 <= means["tau2"] <= TAU2_NU * 2,
             f"latent posterior mean tau2 {means['tau2']} is not within 2x of {TAU2_NU}")
    _require(0.3 < means["nu"] < 2.8,
             f"latent posterior mean nu {means['nu']} sits on a bound of its prior")
    return res


# ---- the coords table layout (slice 5) -----------------------------------

N_C5, M_C5 = 500_000, 20  # BASELINE.json config 5


def coords_parity(main: Case, small: Case) -> dict:
    """The coords instances of the closed-form kernels 1, 2, 2-EMIT_Y and 3
    against their float64 plain versions on the same coordinate planes, with
    the dist rows' own checks and limits, at the main path's shapes and at
    n=1,500, m=7; returns the max_abs_err of each row."""
    fwd = check_forward(main, "coords n100000 m15 sqexp")
    check_forward(small, "coords n1500 m7 exponential")
    grad = check_grad(main, "coords n100000 m15 sqexp", grad_rtol=2e-3)
    check_grad(small, "coords n1500 m7 exponential", grad_rtol=2e-4)
    bf = check_bf(main, "coords n100000 m15 sqexp", zero_alpha=False, gated=True)
    check_bf(main, "coords n100000 m15 sqexp", zero_alpha=True, gated=False)
    check_bf(small, "coords n1500 m7 exponential", zero_alpha=False, gated=True)
    check_bf(small, "coords n1500 m7 exponential", zero_alpha=True, gated=True)
    grad_y = check_grad_y(main, "coords n100000 m15 sqexp", False, grad_rtol=2e-3)
    check_grad_y(main, "coords n100000 m15 sqexp", True, grad_rtol=2e-3)
    check_grad_y(small, "coords n1500 m7 exponential", False, grad_rtol=2e-4)
    check_grad_y(small, "coords n1500 m7 exponential", True, grad_rtol=2e-4)
    return {"vecchia_suffstats_coords": fwd["f_max_abs_err"],
            "vecchia_grad_coords": grad["max_abs_err"],
            "vecchia_bf_coords": bf["b_max_abs_err"],
            "vecchia_grad_y_coords": grad_y["b_max_abs_err"]}


# kernel 3's B error at config 5's shapes, exponential, alpha = 0, on the
# thread-a-system body, before the coords instance moved to the team body
# (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's last runs before it,
# PERF.md)
ALPHA0_LANE_B = {"coords": 8.84e-3, "dist": 7.25e-3}


def config5_parity(dist: Case, coords: Case) -> dict:
    """The m=20 coords instances at config 5's shapes (n=500,000), as paths
    11-14 launch them, against their float64 plain versions on the same
    coordinate planes, with the dist rows' own checks and limits: kernels
    1, 2 and 2-EMIT_Y (shared and per-chain y) with sqexp, as paths 11-13
    run them; kernel 3 with sqexp and with exponential (path 14's) at the
    case's alpha.  Kernels 1, 2 (four chains), 2-EMIT_Y (two chains) and 3
    (sqexp and exponential) also on the dist layout: at M = 20 kernel 2 runs
    its team body on both layouts, kernels 1 and 3 theirs on coords and a
    lane a (site, chain) on dist; the rows named ``_m20`` are the team
    bodies', and kernel 2's launches of four chains on either layout give
    the ``_m20_4_chains`` rows their errors.
    Four of the case's chains (every fourth, so phi and alpha span the
    case's range), two a float64 plain call, to keep the plain versions'
    memory to a few GB; returns the max_abs_err of each row.

    Kernel 3 at alpha = 0 (the latent model's) is printed for both layouts
    on the same sites and not gated, as the sqexp rows at alpha = 0 are: at
    this density (neighbors ~1e-3 apart, correlations above 0.98 for phi
    >= 0.05) the exponential systems without a nugget are as ill-conditioned
    as sqexp's at n=1,500, and the first run on the card (an NVIDIA H100
    80GB HBM3) put the coords instance at B 9.0e-3, F 6.3e-3 from the
    float64 plain version, over the 1e-3 that holds at n=1,500, m=7.  Those
    errors are printed beside the thread-a-system body's last ones
    (ALPHA0_LANE_B)."""
    every4 = slice(None, None, 4)
    sqexp = coords.subset(every4, chunk=2)
    label = f"coords n{coords.n} m{coords.m} sqexp"
    fwd = check_forward(sqexp, label)
    grad = check_grad(sqexp, label, grad_rtol=2e-3)
    grad_y = check_grad_y(sqexp, label, False, grad_rtol=2e-3)
    label_dist = f"dist n{dist.n} m{dist.m} sqexp"
    sq_dist = dist.subset(every4, chunk=2)
    _require(sqexp.phi.shape[0] == sq_dist.phi.shape[0] == 4,
             "config 5's kernel 2 parity launches are not of four chains")
    check_forward(sq_dist, label_dist)  # kernel 1-dist's lane body at M = 20
    grad_dist = check_grad(sq_dist, label_dist, grad_rtol=2e-3)
    grad_y_dist = check_grad_y(dist.subset(slice(None, None, 8), chunk=2),  # chains 0 and 8
                               label_dist, False, grad_rtol=2e-3)
    bf = check_bf(sqexp, label, zero_alpha=False, gated=True)["b_max_abs_err"]
    check_bf(sq_dist, label_dist, zero_alpha=False, gated=True)  # kernel 3-dist's lane body
    alpha0 = {}
    for case in (coords, dist):
        expo = case.subset(every4, kernel=Exponential(), chunk=2)
        label = f"{case.layout} n{case.n} m{case.m} exponential"
        err = check_bf(expo, label, zero_alpha=False, gated=True)["b_max_abs_err"]
        if case is coords:
            bf = max(bf, err)
        zero = check_bf(expo, label, zero_alpha=True, gated=False)
        alpha0[case.layout] = {"b_max_abs_err": zero["b_max_abs_err"],
                               "f_max_rel_err": zero["f_max_rel_err"],
                               "lane_body_b_max_abs_err": ALPHA0_LANE_B[case.layout]}
    print(f"kernel 3 at alpha = 0 [n{dist.n} m{dist.m} exponential, not gated; coords on "
          "the team body, dist on the lane body], beside the lane body's last errors: "
          + json.dumps(alpha0), flush=True)
    return {"vecchia_suffstats_coords": fwd["f_max_abs_err"],
            "vecchia_grad_coords": grad["max_abs_err"],
            "vecchia_bf_coords": bf,
            "vecchia_grad_y_coords": grad_y["b_max_abs_err"],
            "vecchia_suffstats_coords_m20": fwd["f_max_abs_err"],
            "vecchia_bf_coords_m20": bf,
            "vecchia_grad_m20": grad_dist["max_abs_err"],
            "vecchia_grad_coords_m20": grad["max_abs_err"],
            "vecchia_grad_y_m20": grad_y_dist["b_max_abs_err"],
            "vecchia_grad_y_coords_m20": grad_y["b_max_abs_err"],
            "vecchia_grad_m20_4_chains": grad_dist["max_abs_err"],
            "vecchia_grad_coords_m20_4_chains": grad["max_abs_err"]}


def time_plain_m20(dist: Case, coords: Case) -> dict:
    """Per-call times of the float32 plain versions of the M = 20 rows at
    config 5's shapes: kernels 1, 2, 2-EMIT_Y and 3 at 16 chains, as four
    calls of 4 chains (one call of 16 would hold tens of GB of (C, n_pad,
    m, m) tensors), and kernel 2 at 4 chains; one timed call each."""
    out = {}
    for case in (dist, coords):
        k, t = case.kernel, case.tab32
        sfx = _suffix(case)
        params = fwd_ops.params_array(case.phi, case.alpha, case.jitter, case.n,
                                      torch.float32, case.phi.device)
        quarters = [slice(i, i + 4) for i in range(0, case.phi.shape[0], 4)]
        grad = lambda sl, y: diff_ops.grad_reference(k, t, params[sl], y)
        grad_y = lambda sl: diff_ops.grad_reference(k, t, params[sl], case.y32_chains[sl],
                                                    emit_y=True)
        out[f"vecchia_grad{sfx}_m20_plain"] = _time_ms(
            lambda: [grad(sl, case.y32) for sl in quarters], 0, 1)
        out[f"vecchia_grad_y{sfx}_m20_plain"] = _time_ms(
            lambda: [grad_y(sl) for sl in quarters], 0, 1)
        out[f"vecchia_grad{sfx}_m20_4_chains_plain"] = _time_ms(
            lambda: grad(quarters[0], case.y32), 0, 1)
        out[f"vecchia_suffstats{sfx}_m20_plain"] = _time_ms(
            lambda: [fwd_ops.suffstats_reference(k, t, params[sl], case.y32)
                     for sl in quarters], 0, 1)
        out[f"vecchia_bf{sfx}_m20_plain"] = _time_ms(
            lambda: [bf_ops.bf_reference(k, t, params[sl]) for sl in quarters], 0, 1)
        torch.cuda.empty_cache()
    print("plain times [n500000 m20, 16 chains in four calls; 4 chains]: "
          + json.dumps(out), flush=True)
    return out


def compare_layouts(dist: Case, coords: Case, label: str) -> dict:
    """Ungated: how far the coords instances (distances recomputed from
    float32 coordinates) land from the dist instances (float64 distances
    rounded to float32) on the same sites and parameters, both in float32.
    This is the cost of in-kernel distances, not a parity check."""
    k, jit, nu = dist.kernel, dist.jitter, dist.nu
    out = {}
    for name, case in (("dist", dist), ("coords", coords)):
        t = case.tab32
        ld, q, f, _ = fwd_ops.suffstats(k, t, case.phi, case.alpha, case.y32, jit, nu=nu)
        sums = diff_ops.value_and_grad_sums(k, t, case.phi, case.alpha, case.y32, jit,
                                            nu=nu)
        b, f3 = bf_ops.bf_planes(k, t, case.phi, case.alpha, jit, nu=nu)
        out[name] = (torch.stack([ld, q]).double(), f[:, :case.n].double(), sums.double(),
                     b.double(), f3[:, :case.n].double())
    d, c = out["dist"], out["coords"]
    res = {
        "suffstats_value_rel": _rel(c[0], d[0]),
        "suffstats_f_max_abs": float((c[1] - d[1]).abs().max()),
        "grad_value_rel": _rel(c[2][:2], d[2][:2]),
        "grad_dphi_rel": _rel(c[2][2:4], d[2][2:4]),
        "grad_dalpha_rel": _rel(c[2][4:6], d[2][4:6]),
        "bf_b_max_abs": float((c[3] - d[3]).abs().max()),
        "bf_f_max_rel": _rel(c[4], d[4]),
    }
    if nu is not None:
        res["grad_dnu_rel"] = _rel(c[2][6:8], d[2][6:8])
    print(f"coords against dist, float32 [{label}] (not gated): " + json.dumps(res),
          flush=True)
    return res


def time_layout_kernels(case: Case, warm: int, reps: int) -> dict:
    """Per-call times of kernels 1, 2, 2-EMIT_Y and 3 at the case's shapes,
    and of kernel 2 with 4 chains, named by the rows of its layout (no plain
    versions)."""
    k, t, y = case.kernel, case.tab32, case.y32
    args = (case.phi, case.alpha)
    sfx = _suffix(case)
    times = {
        "vecchia_suffstats" + sfx: _time_ms(
            lambda: fwd_ops.suffstats(k, t, *args, y, case.jitter), warm, reps),
        "vecchia_grad" + sfx: _time_ms(
            lambda: diff_ops.value_and_grad_sums(k, t, *args, y, case.jitter), warm, reps),
        "vecchia_grad_y" + sfx: _time_ms(
            lambda: diff_ops.value_and_grad_sums(k, t, *args, case.y32_chains, case.jitter,
                                                 emit_y=True), warm, reps),
        "vecchia_bf" + sfx: _time_ms(
            lambda: bf_ops.bf_planes(k, t, *args, case.jitter), warm, reps),
        # the NUTS recipe's launch shape
        "vecchia_grad_4_chains" + sfx: _time_ms(
            lambda: diff_ops.value_and_grad_sums(k, t, case.phi[:4], case.alpha[:4], y,
                                                 case.jitter), warm, reps),
    }
    print(f"kernel times [{case.layout} n{case.n} m{case.m}]: "
          + json.dumps({**{f"{n}_ms": ms for n, ms in times.items()},
                        "chains": case.phi.shape[0]}), flush=True)
    return times


def layout_setup_child(layout: str, n: int, m: int) -> dict:
    """One layout's host set-up at (n, m) on bench_setup500k's sites, meant
    for a process of its own so that its peak resident memory is its own:
    the neighbor table, the Vecchia data (with the (n, m, m) distance table
    on the dist layout only), the site tables.  Peak host memory two ways:
    the resident set sampled every 2 ms from /proc/self/statm, and the peak
    of numpy's allocations (tracemalloc), which holds the tables."""
    import tracemalloc

    peak, done = [_rss_mb()], threading.Event()

    def sample():
        while not done.wait(0.002):
            peak[0] = max(peak[0], _rss_mb())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    tracemalloc.start()
    coords = np.random.default_rng(0).uniform(size=(n, 2))
    t0 = time.perf_counter()
    tab = build_neighbor_table(coords, m)
    t_nb = time.perf_counter() - t0
    t0 = time.perf_counter()
    data, tab = make_vecchia_data(coords, m, precompute_distances=layout == "dist",
                                  table=tab, device="cpu")
    t_vd = time.perf_counter() - t0
    t0 = time.perf_counter()
    tables = make_site_tables(data, layout=layout, coords_host=coords[tab.order], device="cpu")
    t_st = time.perf_counter() - t0
    numpy_peak = tracemalloc.get_traced_memory()[1] / 1e6
    tracemalloc.stop()
    done.set()
    sampler.join()
    return {
        "layout": layout, "neighbor_table_s": t_nb, "vecchia_data_s": t_vd,
        "site_tables_s": t_st, "setup_s": t_nb + t_vd + t_st,
        "table_mb": sum(a.numel() * a.element_size()
                        for a in (tables.tab_a, tables.tab_b, tables.nn_idx)) / 1e6,
        "distance_table_mb": 0.0 if data.nn_cross_dist is None else
        (data.nn_dist.nbytes + data.nn_cross_dist.nbytes) / 1e6,
        "peak_rss_mb": max(peak[0], _rss_mb()), "peak_numpy_mb": numpy_peak,
    }


def _rss_mb() -> float:
    """This process's resident memory now, from /proc/self/statm (getrusage's
    peak also keeps that of the process this one was forked from)."""
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e6
    except (OSError, ValueError, IndexError):
        return float("nan")


class LayoutSetups:
    """The layout phase's host set-ups, one process a layout and size, each
    fresh (this script imported as a module; it touches no card) so that its
    peak resident memory is its own.  They start once the kernels are built
    and run one after another in the background, beside the kernel phases:
    each imports, then waits for "go" on its standard input (and exits
    without a word on anything else, as when this process dies).  Their
    seconds are taken beside the kernel phases' host work, on the machine's
    other cores."""

    def __init__(self, sizes):
        here = os.path.dirname(os.path.abspath(__file__))
        self.procs, self.outputs, self.stopped = {}, {}, False
        for n, m in sizes:
            for layout in LAYOUTS:
                code = ("import json, sys, chip_smoke\n"
                        "if sys.stdin.readline().strip() == 'go':\n"
                        "    print(json.dumps(chip_smoke.layout_setup_child("
                        f"{layout!r}, {n}, {m})))")
                self.procs[n, m, layout] = subprocess.Popen(
                    [sys.executable, "-c", code], cwd=here, stdin=subprocess.PIPE,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.thread = threading.Thread(target=self._drive, daemon=True)
        self.thread.start()

    def _drive(self) -> None:
        for key, proc in self.procs.items():
            if self.stopped:
                break
            try:
                self.outputs[key] = proc.communicate("go\n", timeout=900)
            except subprocess.TimeoutExpired:
                proc.kill()
                self.outputs[key] = ("", "timed out after 900 s")

    def result(self, n: int, m: int) -> dict:
        """Set-up seconds, table sizes and peak resident memory of each
        layout at (n, m), once every set-up has run."""
        self.thread.join()
        out = {}
        for layout in LAYOUTS:
            stdout, stderr = self.outputs.get((n, m, layout), ("", "did not run"))
            _require(self.procs[n, m, layout].returncode == 0 and stdout.strip(),
                     f"the {layout} set-up process failed:\n{stderr[-4000:]}")
            out[layout] = json.loads(stdout.strip().splitlines()[-1])
        print(f"layout set-up [n{n} m{m}]: " + json.dumps(out), flush=True)
        return out

    def stop(self) -> None:
        """Ends whichever of the processes still runs."""
        self.stopped = True
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
        self.thread.join()
        for proc in self.procs.values():
            proc.communicate()


# the sizes of the layout phase: (n, m), the main path's (m = 15, the models'
# default) and config 5's at the threshold (m = 20); the sizes between them
# (200,000 and 300,000 at m = 15) and 10,000 ran until the script's time grew
# too close to its limit: the ranking they gave never differed from 100,000's
LAYOUT_SIZES = ((N_MAIN, M_MAIN), (N_C5, M_C5))
# bench_ess's two recipes as kernel launches (paths 1 and 5 of this script): the MWG
# branch, the response model's default sampler, one kernel-1 launch of 16
# chains a step (a 2000-step pilot and a 6500-step run); the NUTS branch,
# one kernel-2 launch of 4 chains a leapfrog.  bench_ess's default
# (--sampler best) runs both on one set-up: the rule's recipe.
RECIPES = {"mwg": ("vecchia_suffstats", 8_500), "nuts": ("vecchia_grad_4_chains", 11_257)}


def layout_rule(layouts: dict) -> dict:
    """The measurement behind site_tables.COORDS_LAYOUT_MIN_SITES: at each
    size, the host set-up seconds plus the seconds of the kernel launches of
    each of bench_ess's recipes (RECIPES) and of both ("best", bench_ess's
    default, one set-up), on either layout; the faster layout of each.  Fails
    unless choose_layout("auto", n) takes the layout that runs "best" faster
    at every size measured."""
    rows = {}
    for key, got in sorted(layouts.items(), key=lambda kv: kv[1]["n"]):
        ms, setup = got["times"]["ms"], got["setup"]
        row = {recipe: {layout: count * ms[kernel + sfx] / 1e3
                        for layout, sfx in (("dist", ""), ("coords", "_coords"))}
               for recipe, (kernel, count) in RECIPES.items()}
        row["best"] = {layout: sum(row[r][layout] for r in RECIPES) for layout in LAYOUTS}
        for recipe in list(row):
            row[recipe] = {layout: setup[layout]["setup_s"] + sec
                           for layout, sec in row[recipe].items()}
            row[recipe]["faster"] = min(LAYOUTS, key=row[recipe].get)
        row["auto"] = site_tables.choose_layout("auto", got["n"])
        row["coords_over_dist"] = got["times"]["coords_over_dist"]
        rows[key] = row
    out = {"recipe_seconds": rows,
           "coords_layout_min_sites": site_tables.COORDS_LAYOUT_MIN_SITES}
    print("layout rule: " + json.dumps(out), flush=True)
    for key, row in rows.items():
        _require(row["auto"] == row["best"]["faster"],
                 f"COORDS_LAYOUT_MIN_SITES takes {row['auto']} at {key}, where "
                 f"bench_ess's recipes run faster on {row['best']['faster']}")
    return out


def config5_probe(dev) -> dict:
    """bench.py's bench_setup500k (l.921-970, over _build_fused l.193-247) on
    the port, uncut: n=500,000 uniform sites and y ~ N(0, 1) from
    default_rng(0), m=20, sqexp, the coords layout; set-up in phases, then
    50 single-chain log-likelihood evaluations at phi = linspace(0.2, 0.4) +
    0.002, alpha = 0.1, through the forward pass (kernel 1), after a warm
    pass at + 0.001."""
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(N_C5, 2))
    y = rng.standard_normal(N_C5)
    _reset_counts()
    phases = {}
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    tab = build_neighbor_table(coords, M_C5)
    phases["neighbor_table"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    data, tab = make_vecchia_data(coords, M_C5, precompute_distances=False, table=tab, device="cpu")
    phases["vecchia_data"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    y_dev = torch.as_tensor(y[tab.order], dtype=torch.float32, device=dev)
    tables = make_site_tables(data, device=dev, layout="coords",
                              coords_host=coords[tab.order])
    torch.cuda.synchronize()
    phases["site_tables"] = time.perf_counter() - t0
    phases["layout"] = tables.layout
    phases["table_mb"] = sum(a.numel() * a.element_size()
                             for a in (tables.tab_a, tables.tab_b, tables.nn_idx)) / 1e6
    setup_s = time.perf_counter() - t_all
    k_evals, kernel = 50, SqExp()
    alpha = torch.full((1,), 0.1, device=dev)

    def many(phis):
        acc = torch.zeros((), dtype=torch.float64, device=dev)
        for phi in phis:
            ld, q, _, _ = fwd_ops.suffstats(kernel, tables, phi.reshape(1), alpha, y_dev)
            acc = acc - 0.5 * (ld + q).double().sum()
        return float(acc)

    phis = torch.linspace(0.2, 0.4, k_evals, device=dev)
    many(phis + 0.001)
    t0 = time.perf_counter()
    total = many(phis + 0.002)
    evals_per_sec = k_evals / (time.perf_counter() - t0)
    launches = _read_counts("config 5 probe", ("vecchia_suffstats_coords",
                                               "vecchia_suffstats_coords_m20"))
    res = {
        f"config5_loglik_evals_per_sec_n{N_C5}_m{M_C5}": evals_per_sec,
        "setup_seconds": setup_s, "setup_phases": phases, "sum_loglik": total,
        "launches": launches, "plain_calls": 0,
    }
    print("config 5 probe: " + json.dumps(res), flush=True)
    _require(np.isfinite(total), "non-finite config 5 log-likelihoods")
    _require(launches["vecchia_suffstats_coords"] == 2 * k_evals,
             "the config 5 probe did not launch kernel 1 once per evaluation")
    return res


def config5_response_path(dev) -> dict:
    """The response NNGP at config 5's size on the coords layout (the
    reference's default at this n; the port's is dist up to
    COORDS_LAYOUT_MIN_SITES): bench_ess's field at n=500,000 (seed 0, noise
    sd 0.3), m=20,
    sqexp; fit_map(250), then bench_ess's MWG recipe cut to a 16 x 300
    correlated-RW pilot (100 burn-in) and 16 x 600 independence-mixture
    draws after 300 burn-in; then NUTS, 4 chains x 30 draws after 30 burn-in
    at max_depth 6 from the Laplace fit.  Kernel 1 per MWG proposal, kernel
    2 per MAP step and leapfrog, both their coords instances."""
    coords, y = bench_field(N_C5, seed=0)
    _reset_counts()
    t0 = time.perf_counter()
    model = ResponseNNGP(coords, y, kernel="sqexp", m=M_C5, device=dev,
                         lane_layout="coords")
    setup_s = time.perf_counter() - t0
    res = {"setup_s": setup_s, "lane_layout": model.lane_layout,
           **_mwg_recipe(model, (100, 200), (300, 600), f"n{N_C5}_m{M_C5}")}
    draws, mp = res.pop("draws"), res.pop("map_fit")
    res["config5_min_ess_per_sec_n500000_m20"] = res.pop(f"min_ess_per_sec_n{N_C5}_m{M_C5}")
    chains, n_burn, n_draws, max_depth = 4, 30, 30, 6
    map_launches = diff_ops.COUNT_COORDS.launches
    t0 = time.perf_counter()
    nuts = model.sample_nuts(n_draws, n_burn=n_burn, n_chains=chains, seed=0,
                             max_depth=max_depth, init_u=mp.u,
                             init_inv_mass=mp.laplace_cov, init_jitter=2.0)
    res["nuts_run_s"] = time.perf_counter() - t0
    launches = _read_counts("config 5 response", ("vecchia_suffstats_coords",
                                                  "vecchia_grad_coords",
                                                  "vecchia_suffstats_coords_m20",
                                                  "vecchia_grad_coords_m20",
                                                  "vecchia_grad_coords_m20_4_chains"))
    res["nuts"] = _nuts_summary(nuts, n_burn, "vecchia_grad_coords",
                                launches["vecchia_grad_coords"] - map_launches)
    res.update(launches=launches, plain_calls=0,
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    print("config 5 response path: " + json.dumps(res), flush=True)
    for name, got in (("MWG", draws), ("NUTS", nuts)):
        _require(all(np.isfinite(v).all() for v in got.values()),
                 f"non-finite {name} draws at config 5's size")
    _require(draws["phi"].shape == (CHAINS, 600), "MWG draws have the wrong shape")
    for name, tau2 in (("MWG", res["posterior_mean"]["tau2"]),
                       ("NUTS", res["nuts"]["posterior_mean"]["tau2"])):
        _require(TAU2_TRUE / 2 <= tau2 <= TAU2_TRUE * 2,
                 f"{name} posterior mean tau2 {tau2} is not within 2x of 0.09")
    init = res["init"]
    gen = torch.Generator(device=dev).manual_seed(7)
    prof = profile_steps(model.step, model.init_state(CHAINS, init), gen, wall_steps=10)
    print("config 5 MWG step profile: " + json.dumps(prof), flush=True)
    # without the value and gradient alone: late in this script's process
    # torch.profiler recorded no device time over them (twice; in a fresh
    # process it does, tools/profile_window.py)
    print("config 5 NUTS transition profile: "
          + json.dumps(profile_nuts(model, mp, chains, max_depth, warm=5, wall_steps=5,
                                    value_and_grad=False)), flush=True)
    return res


def config5_fixed_effects_path(dev) -> dict:
    """Config 5's field plus x @ [1, -2] with an intercept and one covariate:
    fit_map(150) with x= on the coords layout, every step one launch of
    kernel 2's EMIT_Y coords instances and one y-cotangent gather; the MAP
    slope must be within 0.1 of -2."""
    coords, y = bench_field(N_C5, seed=0)
    x = np.column_stack([np.ones(N_C5), np.random.default_rng(1).standard_normal(N_C5)])
    beta_true = np.array([1.0, -2.0])
    _reset_counts()
    t0 = time.perf_counter()
    model = ResponseNNGP(coords, y + x @ beta_true, kernel="sqexp", m=M_C5, x=x,
                         device=dev, lane_layout="coords")
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mp = model.fit_map(n_steps=150)
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    launches = _read_counts("config 5 fixed effects", ("vecchia_grad_y_coords",
                                                       "vecchia_grad_y_coords_m20"))
    u = mp.u.cpu()
    res = {"setup_s": setup_s, "map_s": map_s, "lane_layout": model.lane_layout,
           "map_u": u.tolist(), "map_beta": u[3:].tolist(),
           "beta_true": beta_true.tolist(), "launches": launches, "plain_calls": 0}
    print("config 5 fixed-effects path: " + json.dumps(res), flush=True)
    _require(bool(torch.isfinite(u).all()), "non-finite MAP point with fixed effects")
    _require(abs(float(u[4]) - beta_true[1]) <= 0.1,
             f"MAP slope {float(u[4])} is not within 0.1 of -2")
    return res


def config5_latent_path(dev) -> dict:
    """The latent-w NNGP at config 5's size on config 5's field: m=20,
    exponential, on the coords layout, 8 chains, 50 draws after 50 burn-in
    (100 + 100 until the script neared its time limit), w_every=8.  One launch of kernel 3's coords instances a step,
    for the proposal of the theta block (phi).  The latent model takes its
    layout by n alone, as the reference's does, and the reference's
    threshold (200,000) takes coords here: the path builds the model under
    that threshold."""
    n, chains, n_burn, n_draws = N_C5, 8, 50, 50
    coords, y = bench_field(n, seed=0)
    _reset_counts()
    t0 = time.perf_counter()
    port_threshold = site_tables.COORDS_LAYOUT_MIN_SITES
    site_tables.COORDS_LAYOUT_MIN_SITES = 200_000
    try:
        model = LatentNNGP(coords, y, kernel="exponential", m=M_C5, device=dev)
    finally:
        site_tables.COORDS_LAYOUT_MIN_SITES = port_threshold
    setup_s = time.perf_counter() - t0
    _require(model.lane_layout == "coords",
             f"the latent model's layout at n={n} is {model.lane_layout}")
    init = {"sigma2": float(np.var(y)) * 0.8, "phi": 0.1, "tau2": float(np.var(y)) * 0.15}
    t0 = time.perf_counter()
    draws = model.sample(n_draws, n_burn=n_burn, n_chains=chains, seed=0, init=init,
                         w_every=8)
    run_s = time.perf_counter() - t0
    launches = _read_counts("config 5 latent", ("vecchia_bf_coords", "vecchia_bf_coords_m20"))
    res = {
        "setup_s": setup_s, "run_s": run_s, "colors": model.n_colors,
        "lane_layout": model.lane_layout,
        "ms_per_step": run_s * 1e3 / (n_burn + n_draws),
        "posterior_mean": {k: float(np.mean(draws[k])) for k in ("sigma2", "phi", "tau2")},
        "launches": launches, "plain_calls": 0, "w_shape": list(draws["w"].shape),
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"latent path [n{n} m{M_C5}]: " + json.dumps(res), flush=True)
    _require(all(np.isfinite(v).all() for v in draws.values()),
             "non-finite latent draws at config 5's size")
    _require(draws["w"].shape == (chains, -(-n_draws // 8), n),
             f"w draws have the wrong shape {draws['w'].shape}")
    _require(launches["vecchia_bf_coords"] >= n_burn + n_draws,
             "fewer kernel-3 launches than latent steps")
    return res


def matern_nu_coords_path(dev, field, mp) -> dict:
    """Config 3's model (sampled-nu Matern, n=25,000, m=10) with
    lane_layout="coords": the kernel sums and the log-posterior's value and
    gradient at path 7's MAP point against the dist-layout model's, within
    the general-nu limits, a log-likelihood without gradient (kernel 1-nu),
    NUTS with 2 chains x 30 draws after 30 burn-in; then the same data plus
    x @ [1, -2] on the coords layout: the value and gradient (kernel 2-nu's
    EMIT_Y instances) and 4 MWG chains x 20 draws after 20 burn-in (kernel
    3-nu per proposal)."""
    coords, y = field
    dist_model = ResponseNNGP(coords, y, kernel=Matern(), m=M_NU, lane_layout="dist",
                              device=dev)
    _reset_counts()
    model = ResponseNNGP(coords, y, kernel=Matern(), m=M_NU, lane_layout="coords",
                         device=dev)
    _require(model.lane_layout == "coords", "lane_layout='coords' was not taken")
    u = mp.u.reshape(1, -1)  # [log sigma2, logit phi, log tau2, logit nu]
    nat = model._natural(torch.stack([u[0, 1], u[0, 2] - u[0, 0], u[0, 3]]))
    phi, alpha, nu = (nat[k].reshape(1).to(dev) for k in ("phi", "alpha", "nu"))
    sums = {name: diff_ops.value_and_grad_sums(m.kernel, m.tables, phi, alpha, m.y,
                                               m.jitter, nu=nu).double().cpu()
            for name, m in (("coords", model), ("dist", dist_model))}
    vg = {name: m.full_value_and_grad(u) for name, m in (("coords", model),
                                                          ("dist", dist_model))}
    with torch.no_grad():
        ll = float(model.full_loglik(u)[0])
    c, d = sums["coords"], sums["dist"]
    res = {
        "sums_value_rel": _rel(c[:2], d[:2]), "sums_dphi_rel": _rel(c[2:4], d[2:4]),
        "sums_dalpha_rel": _rel(c[4:6], d[4:6]), "sums_dnu_rel": _rel(c[6:8], d[6:8]),
        "logpost_rel": _rel(vg["coords"][0].double(), vg["dist"][0].double()),
        "logpost_grad_coords": vg["coords"][1].tolist(),
        "logpost_grad_dist": vg["dist"][1].tolist(), "loglik": ll,
    }
    chains, n_burn, n_draws = 2, 30, 30
    before = diff_ops.COUNT_NU_COORDS.launches
    t0 = time.perf_counter()
    draws = model.sample_nuts(n_draws, n_burn=n_burn, n_chains=chains, seed=0,
                              max_depth=6, init_u=mp.u, init_inv_mass=mp.laplace_cov,
                              init_jitter=2.0)
    res["nuts_run_s"] = time.perf_counter() - t0
    res["nuts"] = _nuts_summary(draws, n_burn, "vecchia_grad_nu_coords",
                                diff_ops.COUNT_NU_COORDS.launches - before)
    x = np.column_stack([np.ones(N_NU), np.random.default_rng(1).standard_normal(N_NU)])
    fixed = ResponseNNGP(coords, y + x @ np.array([1.0, -2.0]), kernel=Matern(), m=M_NU,
                         x=x, lane_layout="coords", device=dev)
    u_fixed = torch.cat([mp.u, torch.tensor([1.0, -2.0])]).reshape(1, -1)
    value, grad = fixed.full_value_and_grad(u_fixed)
    u0 = mp.u.cpu()
    sig0, tau0 = float(torch.exp(u0[0])), float(torch.exp(u0[2]))
    init = {"sigma2": sig0, "phi": float(model._t_phi.forward(u0[1])),
            "alpha": tau0 / sig0, "nu": float(model._t_nu.forward(u0[3]))}
    mwg = fixed.sample(20, n_burn=20, n_chains=4, init=init, seed=0)
    launches = _read_counts("sampled-nu coords", (
        "vecchia_suffstats_nu_coords", "vecchia_grad_nu_coords",
        "vecchia_grad_y_nu_coords", "vecchia_bf_nu_coords"))
    res.update(fixed_effects_value=float(value[0]), fixed_effects_grad=grad[0].tolist(),
               mwg_beta_mean=mwg["beta"].mean(axis=(0, 1)).tolist(),
               launches=launches, plain_calls=0)
    print("sampled-nu coords path [config 3]: " + json.dumps(res), flush=True)
    for key, limit in (("sums_value_rel", NU_LIMITS["value_rel"]),
                       ("sums_dphi_rel", NU_LIMITS["dphi_rel"]),
                       ("sums_dalpha_rel", NU_LIMITS["dalpha_rel"]),
                       ("sums_dnu_rel", NU_LIMITS["dnu_rel"]),
                       ("logpost_rel", NU_LIMITS["value_rel"])):
        _require(res[key] <= limit, f"coords against dist: {key} {res[key]} exceeds {limit}")
    _require(all(np.isfinite(v).all() for v in draws.values()),
             "non-finite sampled-nu NUTS draws on the coords layout")
    _require(all(np.isfinite(v).all() for v in mwg.values())
             and bool(torch.isfinite(grad).all()) and np.isfinite(ll),
             "non-finite values with fixed effects on the coords layout")
    return res


def time_layouts(dist: Case, coords: Case, warm: int, reps: int) -> dict:
    """Kernels 1, 2, 2-EMIT_Y and 3 in both layouts on the same sites, timed
    in turns (dist, coords, coords, dist): the mean of each layout's two
    rounds, and the coords/dist ratio of each kernel."""
    mean = {}
    for case in (dist, coords, coords, dist):
        for name, ms in time_layout_kernels(case, warm, reps).items():
            mean[name] = mean.get(name, 0.0) + ms / 2
    ratio = {name: mean[name + "_coords"] / mean[name]
             for name in mean if not name.endswith("_coords")}
    out = {"ms": mean, "coords_over_dist": ratio}
    print(f"layout times [n{dist.n} m{dist.m}, {dist.phi.shape[0]} chains]: "
          + json.dumps(out), flush=True)
    return out


# ---- heterogeneous noise, any m <= 20, coords with any d (slice 6) --------


def time_instances(case: Case, warm: int, reps: int, plain: tuple,
                   bases: tuple = ("vecchia_suffstats", "vecchia_grad", "vecchia_bf")) -> dict:
    """Per-call times of kernels 1, 2, 2-EMIT_Y and 3 (those of ``bases``)
    at the case's shapes, with its noise weights if it has them, and of
    their float32 plain versions (``plain`` = (warm, reps)), named by the
    rows of the instances they launch (``_large`` for m > 32, with
    ``_cluster`` or ``_scratch`` above the shared-memory body, ``_hetero``
    with weights)."""
    k, t, v, nu, jit = case.kernel, case.tab32, case.v32, case.nu, case.jitter
    args = (case.phi, case.alpha)
    params = fwd_ops.params_array(*args, jit, case.n, torch.float32, case.phi.device,
                                  fwd_ops.kernel_nu(k, nu))
    ys = case.y32_chains
    calls = {
        ("vecchia_suffstats", False): (
            lambda: fwd_ops.suffstats(k, t, *args, case.y32, jit, nu=nu, noise_v=v),
            lambda: fwd_ops.suffstats_reference(k, t, params, case.y32, v)),
        ("vecchia_grad", False): (
            lambda: diff_ops.value_and_grad_sums(k, t, *args, case.y32, jit, nu=nu,
                                                 noise_v=v),
            lambda: diff_ops.grad_reference(k, t, params, case.y32, noise_v=v)),
        ("vecchia_grad", True): (
            lambda: diff_ops.value_and_grad_sums(k, t, *args, ys, jit, emit_y=True, nu=nu,
                                                 noise_v=v),
            lambda: diff_ops.grad_reference(k, t, params, ys, emit_y=True, noise_v=v)),
        ("vecchia_bf", False): (
            lambda: bf_ops.bf_planes(k, t, *args, jit, nu=nu, noise_v=v),
            lambda: bf_ops.bf_reference(k, t, params, v)),
    }
    times = {}
    for (base, emit_y), (launch, plain_call) in calls.items():
        if base not in bases:
            continue
        name = fwd_ops.instance(base, k, t, emit_y, hetero=v is not None)
        times[name] = _time_ms(launch, warm, reps)
        times[name + "_plain"] = _time_ms(plain_call, *plain)
    print(f"kernel times by instance [{case.layout} n{case.n} m{case.m}]: "
          + json.dumps({**{f"{n}_ms": ms for n, ms in times.items()},
                        "chains": case.phi.shape[0]}), flush=True)
    return times


def hetero_parity(main: Case, small: Case) -> dict:
    """The closed-form instances of one layout launched with per-site noise
    weights (v ~ U(0.25, 4)) against their float64 plain versions with the
    same weights, with the homogeneous rows' own checks and limits, at the
    main path's shapes and at n=1,500, m=7; returns the max_abs_err of each
    hetero row.  At alpha = 0 the weights change nothing (alpha v = 0), so
    kernel 3 is held at the case's alpha only."""
    sfx, lay = _suffix(main), main.layout
    big, little = f"hetero {lay} n{main.n} m{main.m} sqexp", f"hetero {lay} n1500 m7 exponential"
    fwd = check_forward(main, big)
    check_forward(small, little)
    grad = check_grad(main, big, grad_rtol=2e-3)
    check_grad(small, little, grad_rtol=2e-4)
    bf = check_bf(main, big, zero_alpha=False, gated=True)
    check_bf(small, little, zero_alpha=False, gated=True)
    grad_y = check_grad_y(main, big, False, grad_rtol=2e-3)
    check_grad_y(main, big, True, grad_rtol=2e-3)
    check_grad_y(small, little, False, grad_rtol=2e-4)
    check_grad_y(small, little, True, grad_rtol=2e-4)
    return {f"vecchia_suffstats{sfx}_hetero": fwd["f_max_abs_err"],
            f"vecchia_grad{sfx}_hetero": grad["max_abs_err"],
            f"vecchia_bf{sfx}_hetero": bf["b_max_abs_err"],
            f"vecchia_grad_y{sfx}_hetero": grad_y["b_max_abs_err"]}


def four_dimensional_parity(dev) -> dict:
    """d = 4 on the closed-form coords instances (the fourth coordinate read
    where it is used) against their plain versions at n=1,500, m=7, with the
    dist rows' checks and limits; the sites uniform on the unit 4-cube."""
    rng = np.random.default_rng(3)
    coords = rng.uniform(size=(1500, 4))
    y = np.sin(4.0 * coords[:, 0] + 2.0 * coords[:, 3]) + 0.3 * rng.standard_normal(1500)
    case = Case(1500, 7, Exponential(), CHAINS, seed=3, dev=dev, field=(coords, y),
                layout="coords")
    _require(case.tab32.dim == 4, "the d=4 case has the wrong coordinate planes")
    label = "coords d4 n1500 m7 exponential"
    fwd = check_forward(case, label)
    grad = check_grad(case, label, grad_rtol=2e-4)
    bf = check_bf(case, label, zero_alpha=False, gated=True)
    check_bf(case, label, zero_alpha=True, gated=True)
    grad_y = check_grad_y(case, label, False, grad_rtol=2e-4)
    check_grad_y(case, label, True, grad_rtol=2e-4)
    return {"vecchia_suffstats_coords": fwd["f_max_abs_err"],
            "vecchia_grad_coords": grad["max_abs_err"],
            "vecchia_bf_coords": bf["b_max_abs_err"],
            "vecchia_grad_y_coords": grad_y["b_max_abs_err"]}


def m_between_instances(dev, exact15: Case) -> dict:
    """Any m <= 20 on the card: m = 12 runs on the M = 15 instances and
    m = 17 on M = 20 (slots k >= m identity rows that read nothing).  At the
    main path's n and sites: kernels 1, 2, 2-EMIT_Y (shared and per-chain y)
    and 3 against their plain versions with the main path's limits, on four
    of the 16 chains (as many a float64 plain call as plain_chunk allows); then all 16 chains timed in
    turns against the instance's own m (m, M, M, m), which is what running
    on the larger instance costs.  Returns the max_abs_err of each row."""
    errs, costs = {}, {}
    for m, built in ((12, 15), (17, 20)):
        _require(fwd_ops.cuda_instance_m(m) == built, f"m={m} is not run on M={built}")
        case = Case(N_MAIN, m, SqExp(), CHAINS, seed=0, dev=dev)
        sub = case.subset(slice(None, None, 4), chunk=None)
        label = f"n{N_MAIN} m{m} on M={built} sqexp"
        fwd = check_forward(sub, label)
        grad = check_grad(sub, label, grad_rtol=2e-3)
        bf = check_bf(sub, label, zero_alpha=False, gated=True)
        grad_y = check_grad_y(sub, label, False, grad_rtol=2e-3)
        check_grad_y(sub, label, True, grad_rtol=2e-3)
        for name, err in (("vecchia_suffstats", fwd["f_max_abs_err"]),
                          ("vecchia_grad", grad["max_abs_err"]),
                          ("vecchia_bf", bf["b_max_abs_err"]),
                          ("vecchia_grad_y", grad_y["b_max_abs_err"])):
            errs[name] = max(errs.get(name, 0.0), err)
        exact = exact15 if built == 15 else Case(N_MAIN, built, SqExp(), CHAINS, seed=0,
                                                 dev=dev)
        mean = {"m": {}, "M": {}}
        for which, c in (("m", case), ("M", exact), ("M", exact), ("m", case)):
            for name, ms in time_layout_kernels(c, 10, 50).items():
                mean[which][name] = mean[which].get(name, 0.0) + ms / 2
        costs[f"m{m}_on_M{built}"] = {
            "ms": mean["m"], f"ms_m{built}": mean["M"],
            "ratio": {name: mean["m"][name] / mean["M"][name] for name in mean["m"]}}
        del case, sub, exact
        torch.cuda.empty_cache()
    print("m between built instances [n100000, 16 chains]: " + json.dumps(costs),
          flush=True)
    return errs


def large_m_instances(dev) -> dict:
    """m = 25 and m = 32 on the card: the rolled instances of all three
    kernels (arrays for 32, loops to m) on both layouts at n=10,000, 16
    chains, against their plain versions on four of the chains (as many a
    float64 plain call as plain_chunk allows), closed form (kernels 1, 2, 2-EMIT_Y with a shared and a
    per-chain y, 3) and sampled nu; then all 16 chains timed.  Limits: the
    closed-form rows' (gradients rtol 2e-3, the limit of sums over 10^5
    float32 site terms, here 10^4) and NU_LIMITS.  Returns the max_abs_err of
    each closed-form row."""
    errs, times = {}, {}
    for m in (25, 32):
        _require(fwd_ops.cuda_instance_m(m) == 32, f"m={m} does not run rolled")
        for layout in LAYOUTS:
            case = Case(10_000, m, SqExp(), CHAINS, seed=0, dev=dev, layout=layout)
            sub = case.subset(slice(None, None, 4), chunk=None)
            label = f"{layout} n10000 m{m} rolled sqexp"
            fwd = check_forward(sub, label)
            grad = check_grad(sub, label, grad_rtol=2e-3)
            bf = check_bf(sub, label, zero_alpha=False, gated=True)
            grad_y = check_grad_y(sub, label, False, grad_rtol=2e-3)
            check_grad_y(sub, label, True, grad_rtol=2e-3)
            sfx = _suffix(case)
            for name, err in ((f"vecchia_suffstats{sfx}", fwd["f_max_abs_err"]),
                              (f"vecchia_grad{sfx}", grad["max_abs_err"]),
                              (f"vecchia_bf{sfx}", bf["b_max_abs_err"]),
                              (f"vecchia_grad_y{sfx}", grad_y["b_max_abs_err"])):
                errs[name] = max(errs.get(name, 0.0), err)
            times[f"{layout}_m{m}"] = time_layout_kernels(case, 3, 20)
            nu = Case(10_000, m, Matern(), CHAINS, seed=0, dev=dev, nu=nu_spread(CHAINS),
                      layout=layout)
            check_general_nu(nu.subset(slice(None, None, 4), chunk=None), f"{label} nu")
            del case, sub, nu
            torch.cuda.empty_cache()
    print("m above 20 on the rolled instances [n10000, 16 chains]: " + json.dumps(times),
          flush=True)
    return errs


LARGE_M = (40, 64)  # the large-m phase's m
N_LARGE = 10_000


def large_m_kernels(dev) -> tuple:
    """m = 40 and 64 on the large-m instances of all three kernels (m > 32:
    a warp a (site, chain) system in shared memory) on both layouts at
    n=10,000: against their plain versions on four of the 16
    chains (as many a float64 plain call as plain_chunk allows), with and without noise weights,
    closed form (kernels 1, 2, 2-EMIT_Y with a shared and a per-chain y, 3)
    at the closed-form limits (gradients rtol 2e-3, as at m = 25 and 32) and
    sampled nu at NU_LIMITS.  Then the ``_large`` rows timed with their
    plain versions and bounds: the closed forms at m = 64, 16 chains, the
    general-nu instances at m = 40, 4 chains (their float32 plain versions
    at m = 64 and 16 chains would hold tens of GB of Bessel intermediates).
    Then the factor-only yardstick (:func:`factor_only_ms`), the three
    kernels on their cluster body (:func:`cluster_body_check`) and each kernel at
    the first m of its scratch body (:func:`scratch_body_check`).  Returns
    (max_abs_err, ms, bound, library) by row, library the factor-only
    yardstick of the cluster and scratch rows."""
    errs, times, bounds = {}, {}, {}

    def record(c, fwd, grad, bf, grad_y):
        sfx = _suffix(c) + _large(c) + _hetero(c)
        for name, err in ((f"vecchia_suffstats{sfx}", fwd), (f"vecchia_grad{sfx}", grad),
                          (f"vecchia_bf{sfx}", bf), (f"vecchia_grad_y{sfx}", grad_y)):
            errs[name] = max(errs.get(name, 0.0), err)

    for m in LARGE_M:
        _require(geometry.large(m) and fwd_ops.cuda_instance_m(m) == m,
                 f"m={m} does not run the large-m instance")
        for layout in LAYOUTS:
            case = Case(N_LARGE, m, SqExp(), CHAINS, seed=0, dev=dev, layout=layout)
            for c in (case, case.with_noise(noise_weights(N_LARGE))):
                sub = c.subset(slice(None, None, 4), chunk=None)
                label = f"{layout}{_hetero(c)} n{N_LARGE} m{m} large sqexp"
                fwd = check_forward(sub, label)
                grad = check_grad(sub, label, grad_rtol=2e-3)
                bf = check_bf(sub, label, zero_alpha=False, gated=True)
                grad_y = check_grad_y(sub, label, False, grad_rtol=2e-3)
                check_grad_y(sub, label, True, grad_rtol=2e-3)
                record(c, fwd["f_max_abs_err"], grad["max_abs_err"], bf["b_max_abs_err"],
                       grad_y["b_max_abs_err"])
                if m == LARGE_M[-1]:
                    times.update(time_instances(c, 2, 5, (1, 1)))
                    bounds.update(kernel_bounds(c))
            nu = Case(N_LARGE, m, Matern(), CHAINS, seed=0, dev=dev, nu=nu_spread(CHAINS),
                      layout=layout)
            for c in (nu, nu.with_noise(noise_weights(N_LARGE))):
                label = f"{layout}{_hetero(c)} n{N_LARGE} m{m} large nu"
                err = check_general_nu(c.subset(slice(None, None, 4), chunk=None), label)
                sfx = _suffix(c) + _large(c) + _hetero(c)
                for name, key in (("vecchia_suffstats_nu", "f_max_abs_err"),
                                  ("vecchia_grad_nu", "sums_max_abs_err"),
                                  ("vecchia_grad_y_nu", "b_max_abs_err"),
                                  ("vecchia_bf_nu", "bf_b_max_abs_err")):
                    row = name.replace("_nu", "_nu" + _suffix(c), 1) + _large(c) + _hetero(c)
                    errs[row] = max(errs.get(row, 0.0), err[key])
                if m == LARGE_M[0]:
                    four = c.subset(slice(0, 4))
                    times.update(time_instances(four, 2, 5, (1, 1)))
                    bounds.update(kernel_bounds_nu(four))
            del case, nu
            torch.cuda.empty_cache()
    factor_ms = factor_only_ms(dev)
    print("large-m instances [n10000]: " + json.dumps(
        {"max_abs_err": errs, "ms": times, "factor_only_ms": factor_ms,
         "bound_ms": {k: v[0] for k, v in bounds.items()}}), flush=True)
    library = {}
    for check in (cluster_body_check, scratch_body_check):
        for into, got in zip((errs, times, bounds, library), check(dev)):
            into.update(got)
    return errs, times, bounds, library


def factor_only_ms(dev) -> dict:
    """The factor-only yardstick: ``torch.linalg.cholesky_ex`` on the
    (C n_pad, 64, 64) float64 correlation batch of the m = 64 rows (n=10,000,
    16 chains, sqexp, both layouts give the same systems; dist here), timed
    and printed beside them.  It factors only: no solves, no sums, no
    correlations; it is not the rows' library call (none computes their
    function) and the port never calls it."""
    case = Case(N_LARGE, LARGE_M[-1], SqExp(), CHAINS, seed=0, dev=dev)
    out = factor_only(case, 2, 5)
    print("factor-only yardstick [torch.linalg.cholesky_ex, m=64, n10000, 16 chains]: "
          + json.dumps(out), flush=True)
    del case
    torch.cuda.empty_cache()
    return out


def factor_only(case: Case, warm: int, reps: int) -> dict:
    """``torch.linalg.cholesky_ex`` timed on the case's (C n_pad, m, m)
    float64 batch of correlation matrices, built a chain at a time: the
    factor alone, which the port never calls."""
    t = case.tab64
    d_in, d_nn = unpack_distances(t)
    mask = fwd_ops.global_sites(t)[:, None] > torch.arange(case.m, device=t.device)
    chains = case.phi.shape[0]
    batch = torch.empty((chains, t.n_pad, case.m, case.m), dtype=torch.float64,
                        device=t.device)
    for c in range(chains):
        _, _, pr = case.params64(slice(c, c + 1))
        batch[c] = conditional_system(case.kernel, pr[:, 0:1], pr[:, 1:2], pr[:, 2:3], d_in,
                                      d_nn, mask, fused=True)[0][0]
    batch = batch.reshape(-1, case.m, case.m)
    del d_in, d_nn, mask
    torch.cuda.empty_cache()
    ms = _time_ms(lambda: torch.linalg.cholesky_ex(batch), warm, reps)
    out = {"label": "factor only", "batch": list(batch.shape), "dtype": "float64", "ms": ms}
    del batch
    return out


# the cluster body's checks: the first m of each cluster size (2, 4, 8
# blocks) and M_CLUSTER, each on one layout and with or without noise
# weights, so that every pair of the two comes once, closed form and sampled
# nu at each; kernel 2's first m (M_SMEM_GRAD + 1) is checked by path 19's
# models and timed below
CLUSTER_CHECKS = ((geometry.M_SMEM + 1, "dist", False), (313, "coords", True),
                  (441, "dist", True), (geometry.M_CLUSTER, "coords", False))
CLUSTER_CHECK_M = tuple(m for m, _, _ in CLUSTER_CHECKS)
# the shape the cluster rows are timed at: the kernel's first m on the body
# (M_SMEM + 1 for kernels 1 and 3, M_SMEM_GRAD + 1 for kernel 2), n=1,000,
# 4 chains
N_CLUSTER_TIMED = 1_000


def cluster_body_check(dev) -> tuple:
    """The three kernels on the cluster body (a thread-block cluster a
    (site, chain) system; M_SMEM < m <= M_CLUSTER for kernels 1 and 3,
    M_SMEM_GRAD < m <= M_CLUSTER_GRAD for kernel 2): at each m of
    CLUSTER_CHECKS (n = m + 100, 2 chains) on its layout and with or
    without noise weights, closed form (sqexp: the limits of check_forward,
    check_bf, check_grad, and check_grad_y with one y row a chain) and
    sampled nu (NU_LIMITS; kernel 2-EMIT_Y with kernel 2's shared y, so that
    one call of the float64 plain version, which takes half a minute at
    M_CLUSTER, serves both instances),
    against their float64 plain versions, each launch counted under
    ``_large_cluster``.  Then the ``_large_cluster`` rows timed at each
    kernel's first m on the body, n=1,000, 4 chains (the general-nu ones
    too) with their float32 plain versions, bounds and the factor-only
    yardstick on the same float64 batch as their library_ms.  Returns
    (max_abs_err, ms, bound, library) by row."""
    errs, times, bounds, library = {}, {}, {}, {}
    t0 = time.perf_counter()
    for m, layout, hetero in CLUSTER_CHECKS:
        _require(all(geometry.large_body(base, m) == "cluster"
                     for base in ("vecchia_suffstats", "vecchia_grad", "vecchia_bf")),
                 f"m={m} does not run the three kernels on the cluster body")
        sfx = _suffix_of(layout)
        rows = tuple(f"vecchia_{k}{nu}{sfx}_large_cluster" for nu in ("", "_nu")
                     for k in ("suffstats", "bf", "grad", "grad_y"))
        het = "_hetero" if hetero else ""
        counts = [_COUNTS[row + het] for row in rows]
        before = [c.launches for c in counts]
        case = Case(m + 100, m, SqExp(), 2, seed=0, dev=dev, layout=layout)
        nu = Case(m + 100, m, Matern(), 2, seed=0, dev=dev, nu=[0.5 - 1e-4, 2.4],
                  layout=layout)
        if hetero:
            case = case.with_noise(noise_weights(m + 100))
            nu = nu.with_noise(noise_weights(m + 100))
        label = f"{layout}{het} n{m + 100} m{m} cluster body (k={geometry.cluster_blocks(m)})"
        fwd = check_forward(case.subset(slice(None)), label)
        bf = check_bf(case.subset(slice(None)), label, zero_alpha=False, gated=True)
        grad = check_grad(case.subset(slice(None)), label, grad_rtol=2e-3)
        grad_y = check_grad_y(case.subset(slice(None)), label, True, grad_rtol=2e-3)
        gen = check_general_nu(nu.subset(slice(None)), label + " nu", per_chain_y=False)
        launches = [c.launches - b for c, b in zip(counts, before)]
        _require(launches == [1] * len(rows),
                 f"the cluster body was not launched once each [{label}]: {launches}")
        for row, err in zip(rows, (fwd["f_max_abs_err"], bf["b_max_abs_err"],
                                   grad["max_abs_err"], grad_y["b_max_abs_err"],
                                   gen["f_max_abs_err"], gen["bf_b_max_abs_err"],
                                   gen["sums_max_abs_err"], gen["b_max_abs_err"])):
            errs[row] = max(errs.get(row, 0.0), err)
        del case, nu
        torch.cuda.empty_cache()
    checks_s = time.perf_counter() - t0
    timed = {}
    for bases in (("vecchia_suffstats", "vecchia_bf"), ("vecchia_grad",)):
        m = geometry.SMEM_M[bases[0]] + 1
        timed[" ".join(bases)] = f"m{m} n{N_CLUSTER_TIMED} 4 chains"
        for layout in LAYOUTS:
            case = Case(N_CLUSTER_TIMED, m, SqExp(), 4, seed=0, dev=dev, layout=layout)
            mine = {row for row in CLUSTER_ROWS if row.startswith(bases)
                    and ("_coords" in row) == (layout == "coords")}
            times.update(time_instances(case, 1, 5, (1, 2), bases))
            bounds.update({row: b for row, b in kernel_bounds(case).items() if row in mine})
            yard = factor_only(case, 1, 3)
            nu = Case(N_CLUSTER_TIMED, m, Matern(), 4, seed=0, dev=dev,
                      nu=nu_spread(CHAINS)[::4], layout=layout)
            times.update(time_instances(nu, 1, 3, (0, 1), bases))
            bounds.update({row: b for row, b in kernel_bounds_nu(nu).items() if row in mine})
            library.update({row: yard for row in mine})
            del case, nu
            torch.cuda.empty_cache()
    out = {"checks": [f"m{m} {layout}{' hetero' if het else ''}" for m, layout, het in CLUSTER_CHECKS],
           "cluster_blocks": {m: geometry.cluster_blocks(m) for m in CLUSTER_CHECK_M},
           "block_bytes": {m: geometry.cluster_block_bytes(m, geometry.cluster_blocks(m))
                           for m in CLUSTER_CHECK_M},
           "max_abs_err": errs, "timed": timed,
           "ms": {row: times[row] for row in CLUSTER_ROWS},
           "plain_ms": {row: times[row + "_plain"] for row in CLUSTER_ROWS},
           "bound_ms": {row: bounds[row][0] for row in CLUSTER_ROWS},
           "factor_only_ms": {row: library[row]["ms"] for row in CLUSTER_ROWS},
           "check_seconds": checks_s, "seconds": time.perf_counter() - t0}
    print("cluster body of the three kernels [M_SMEM < m <= M_CLUSTER, kernel 2 from "
          "M_SMEM_GRAD]: " + json.dumps(out), flush=True)
    return errs, times, bounds, library


def _timed_launch(fn):
    """(fn's result, its card milliseconds): one call between CUDA events,
    as a launch too long to time twice is timed."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def scratch_body_check(dev) -> tuple:
    """Each kernel at the first m it runs on the scratch body: kernels 1 and
    3 at m = M_CLUSTER + 1, kernel 2 and its EMIT_Y instance at m =
    M_CLUSTER_GRAD + 1 (the same m), with the fewest sites and chains that
    run (n = m + 1, one chain: the body runs each site's system in one
    thread, so a launch takes one system's time), each launch timed between
    CUDA events and held to its float64 plain version at the closed-form
    limits; each counted under ``_large_scratch``.  (Launched at once on
    four streams they took twice as long each, and no less in all.)  Returns (max_abs_err,
    ms, bound, library) of the ``_large_scratch`` rows."""
    m13, m2 = geometry.M_CLUSTER + 1, geometry.M_CLUSTER_GRAD + 1
    _require(m13 == m2 and all(
        geometry.large_body(base, m13) == "scratch"
        and geometry.large_body(base, m13 - 1) == "cluster"
        for base in ("vecchia_suffstats", "vecchia_grad", "vecchia_bf")),
             f"m={m13} (kernels 1 and 3) or m={m2} (kernel 2) does not run the scratch body")
    counts = [_COUNTS[row] for row in SCRATCH_ROWS]
    before = [c.launches for c in counts]
    t0 = time.perf_counter()
    case = Case(m13 + 1, m13, SqExp(), 1, seed=0, dev=dev)
    label = f"n{m13 + 1} m{m13} scratch body sqexp, 1 chain"
    k, t = case.kernel, case.tab32
    out1, ms1 = _timed_launch(lambda: fwd_ops.suffstats(k, t, case.phi, case.alpha, case.y32,
                                                        case.jitter))
    fwd = check_forward(case, label, out=out1)
    out3, ms3 = _timed_launch(lambda: bf_ops.bf_planes(k, t, case.phi, case.alpha,
                                                       case.jitter))
    bf = check_bf(case, label, zero_alpha=False, gated=True, out=out3)
    out2, ms2 = _timed_launch(lambda: diff_ops.value_and_grad_sums(
        k, t, case.phi, case.alpha, case.y32, case.jitter))
    grad = check_grad(case, label, grad_rtol=2e-3, out=out2)
    out2y, ms2y = _timed_launch(lambda: diff_ops.value_and_grad_sums(
        k, t, case.phi, case.alpha, case.y32_chains, case.jitter, emit_y=True))
    grad_y = check_grad_y(case, label, True, grad_rtol=2e-3, out=out2y)
    params = fwd_ops.params_array(case.phi, case.alpha, case.jitter, case.n, torch.float32,
                                  case.phi.device)
    times = {"vecchia_suffstats_large_scratch": ms1, "vecchia_bf_large_scratch": ms3,
             "vecchia_grad_large_scratch": ms2, "vecchia_grad_y_large_scratch": ms2y,
             "vecchia_suffstats_large_scratch_plain": _time_ms(
                 lambda: fwd_ops.suffstats_reference(k, t, params, case.y32), 0, 1),
             "vecchia_bf_large_scratch_plain": _time_ms(
                 lambda: bf_ops.bf_reference(k, t, params), 0, 1),
             "vecchia_grad_large_scratch_plain": _time_ms(
                 lambda: diff_ops.grad_reference(k, t, params, case.y32), 0, 1),
             "vecchia_grad_y_large_scratch_plain": _time_ms(
                 lambda: diff_ops.grad_reference(k, t, params, case.y32_chains, emit_y=True),
                 0, 1)}
    bounds = {row: b for row, b in kernel_bounds(case).items() if row in SCRATCH_ROWS}
    yard = factor_only(case, 0, 1)
    library = {row: yard for row in SCRATCH_ROWS}
    errs = {"vecchia_suffstats_large_scratch": fwd["f_max_abs_err"],
            "vecchia_bf_large_scratch": bf["b_max_abs_err"],
            "vecchia_grad_large_scratch": grad["max_abs_err"],
            "vecchia_grad_y_large_scratch": grad_y["b_max_abs_err"]}
    launches = [c.launches - b for c, b in zip(counts, before)]
    _require(launches == [1, 1, 1, 1],
             f"the scratch body was not launched once each: {launches}")
    out = {"m": {"kernels 1 and 3": m13, "kernel 2": m2}, "launches": launches,
           "max_abs_err": errs,
           "ms": {row: times[row] for row in SCRATCH_ROWS},
           "plain_ms": {row: times[row + "_plain"] for row in SCRATCH_ROWS},
           "bound_ms": {row: bounds[row][0] for row in SCRATCH_ROWS},
           "factor_only_ms": yard["ms"],
           "seconds": time.perf_counter() - t0}
    print("scratch bodies above M_CLUSTER and M_CLUSTER_GRAD: " + json.dumps(out), flush=True)
    del case
    torch.cuda.empty_cache()
    return errs, times, bounds, library


def large_m_path(dev) -> dict:
    """Both models at m = 40 (the large-m instances) on config 2's field
    (n=10,000): the response NNGP's fit_map(50) and 8 chains of MWG, 100 +
    100 (kernels 2 and 1); with x @ [1, -2], fit_map(20) and MWG 50 + 50
    (kernel 2-EMIT_Y, and kernel 3 twice a step); the latent NNGP, 8 chains,
    50 + 50 (kernel 3; 100 + 100 until the script neared its time limit).
    Short runs: the gates are finite draws and the slope within 0.1 of -2.
    Then :func:`cluster_map_run`, the response model's MAP at m = 240."""
    n, m, chains = 10_000, 40, 8
    coords, y = config2_field(n, 10.0, np.random.default_rng(0))
    x = np.column_stack([np.ones(n), np.random.default_rng(1).standard_normal(n)])
    init = {"sigma2": float(np.var(y)) * 0.8, "phi": 0.1, "alpha": 0.2}
    _reset_counts()
    t0 = time.perf_counter()
    model = ResponseNNGP(coords, y, kernel="exponential", m=m, device=dev)
    mp = model.fit_map(n_steps=50)
    draws = model.sample(100, n_burn=100, n_chains=chains, seed=0, init=init)
    response_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fixed = ResponseNNGP(coords, y + x @ np.array([1.0, -2.0]), kernel="exponential",
                         m=m, x=x, device=dev)
    fixed.fit_map(n_steps=20)
    fixed_draws = fixed.sample(50, n_burn=50, n_chains=chains, seed=0, init=init)
    fixed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    latent = LatentNNGP(coords, y, kernel="exponential", m=m, device=dev)
    latent_draws = latent.sample(50, n_burn=50, n_chains=chains, seed=0,
                                 init={"sigma2": init["sigma2"], "phi": 0.1,
                                       "tau2": float(np.var(y)) * 0.15}, collect_w=False)
    latent_s = time.perf_counter() - t0
    launches = _read_counts("large m", ("vecchia_suffstats_large", "vecchia_grad_large",
                                        "vecchia_grad_y_large", "vecchia_bf_large"))
    slope = float(fixed_draws["beta"].mean(axis=(0, 1))[1])
    res = {
        "response_s": response_s, "fixed_effects_s": fixed_s, "latent_s": latent_s,
        "map_logpost": float(mp.value),
        "posterior_mean": {k: float(np.mean(draws[k])) for k in ("sigma2", "phi", "tau2")},
        "latent_posterior_mean": {k: float(np.mean(latent_draws[k]))
                                  for k in ("sigma2", "phi", "tau2")},
        "slope": slope, "launches": launches, "plain_calls": 0,
        "m240": cluster_map_run(dev),
    }
    print("large-m path [n10000 m40; n2000 m240]: " + json.dumps(res), flush=True)
    _require(all(np.isfinite(v).all() for d in (draws, fixed_draws, latent_draws)
                 for v in d.values()), "non-finite draws at m = 40")
    _require(abs(slope + 2.0) <= 0.1, f"posterior mean slope {slope} is not within 0.1 of -2")
    return res


def cluster_map_run(dev) -> dict:
    """The response NNGP with m = 240 (kernel 2 and 2-EMIT_Y on the cluster
    body) on config 2's field at n=2,000: fit_map(20), and with x @ [1, -2]
    fit_map(10).  Gates: finite values and a ``_large_cluster`` launch of
    both kernel-2 instances, and no plain version."""
    n, m = 2_000, 240
    coords, y = config2_field(n, 10.0, np.random.default_rng(0))
    x = np.column_stack([np.ones(n), np.random.default_rng(1).standard_normal(n)])
    _reset_counts()
    t0 = time.perf_counter()
    model = ResponseNNGP(coords, y, kernel="exponential", m=m, device=dev)
    built_s = time.perf_counter() - t0
    mp = model.fit_map(n_steps=20)
    fixed = ResponseNNGP(coords, y + x @ np.array([1.0, -2.0]), kernel="exponential", m=m,
                         x=x, device=dev)
    mp_fixed = fixed.fit_map(n_steps=10)
    torch.cuda.synchronize()
    launches = _read_counts("m = 240", ("vecchia_grad_large_cluster",
                                        "vecchia_grad_y_large_cluster"))
    res = {"layout": model.tables.layout, "build_s": built_s,
           "seconds": time.perf_counter() - t0, "map_logpost": float(mp.value),
           "fixed_map_logpost": float(mp_fixed.value),
           "map_u": [float(v) for v in mp.u],
           "launches": {k: v for k, v in launches.items() if v}}
    _require(np.isfinite(res["map_logpost"]) and np.isfinite(res["fixed_map_logpost"])
             and all(np.isfinite(v) for v in res["map_u"]),
             f"non-finite MAP at m = 240: {res}")
    return res


def tile_resources(info: dict) -> dict:
    """Registers, stack and static shared bytes of every tile instance of
    the three kernels (``cuobjdump -res-usage`` of the built library), the
    tile ring's bytes at 16 chains with a shared y (none for kernel 3;
    ops/geometry.py; the rolled instances at m = 25) and the warps an SM
    those allow by the card's occupancy rules
    (65,536 registers an SM given out 256 to a warp, 233,472 bytes of shared
    memory an SM with 1,024 reserved a block, 64 warps and 32 blocks an
    SM).  cuobjdump's SHARED already holds the 1,024 reserved bytes (a
    kernel without static shared arrays reads 1024), so a block takes the
    dynamic bytes plus SHARED."""
    usage = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-res-usage", info["lib"]],
                           capture_output=True, text=True, timeout=300,
                           check=True).stdout.splitlines()
    out = {}
    for line, res in zip(usage, usage[1:]):
        found = re.search(r"(suffstats|grad|bf)(?:_nu)?_kernelILi(\d+)E((?:Lb[01]E)+)", line)
        if "Function" not in line or not found:
            continue
        name, big_m = found.group(1), int(found.group(2))
        flags = re.findall(r"Lb([01])E", found.group(3))
        core = 1 if name == "grad" else 0  # kernel 2's first flag is EMIT_Y
        if name == "grad" and flags[0] == "1":
            name = "grad_y"
        # kernel 3 alone has a fourth flag, HETERO (its launches with noise weights)
        general, coords, rolled, hetero = (flags[core:core + 4] + ["0"] * 4)[:4]
        name += ("_nu" if general == "1" else "") + ("_coords" if coords == "1" else "")
        name += "_hetero" if hetero == "1" else ""
        stats = dict(re.findall(r"(REG|STACK|SHARED):(\d+)", res))
        regs, stack, static = (int(stats.get(k, 0)) for k in ("REG", "STACK", "SHARED"))
        m = 25 if rolled == "1" else big_m
        dim = 2 if coords == "1" else 0
        geo = geometry.geometry(100_096, m, CHAINS, "coords" if dim else "dist", dim,
                                hetero=hetero == "1", with_y=not name.startswith("bf"))
        warps = geo.block // 32
        per_warp = -(-regs * 32 // 256) * 256
        blocks = min(65_536 // per_warp // warps, 233_472 // (geo.smem_bytes + static),
                     64 // warps, 32)
        key = f"{name}<{'rolled' if rolled == '1' else big_m}>"
        out[key] = {"registers": regs, "stack": stack, "static_shared": static,
                    "ring_bytes": geo.smem_bytes, "warps_per_sm": blocks * warps}
    for line, res in zip(usage, usage[1:]):
        # the M = 20 team bodies: <M, T, flags> (team_name), T the lanes a
        # (site, chain) system
        found = re.search(r"(suffstats|grad|bf)_team_kernelILi(\d+)ELi(\d+)E((?:Lb[01]E)*)",
                          line)
        if "Function" not in line or not found:
            continue
        big_m, lanes = int(found.group(2)), int(found.group(3))
        name = team_name(found.group(1), re.findall(r"Lb([01])E", found.group(4)))
        coords = "_coords" in name
        stats = dict(re.findall(r"(REG|STACK|SHARED):(\d+)", res))
        regs, stack, static = (int(stats.get(k, 0)) for k in ("REG", "STACK", "SHARED"))
        geo = geometry.geometry(100_096, big_m, CHAINS, "coords" if coords else "dist",
                                2 if coords else 0, hetero=name.endswith("_hetero"),
                                with_y=not name.startswith("bf"))
        warps = geo.block // 32
        per_warp = -(-regs * 32 // 256) * 256
        blocks = min(65_536 // per_warp // warps, 233_472 // (geo.smem_bytes + static),
                     64 // warps, 32)
        out[f"{name}_team<{big_m}>"] = {
            "registers": regs, "stack": stack, "static_shared": static,
            "ring_bytes": geo.smem_bytes, "warps_per_sm": blocks * warps,
            "team_lanes": lanes}
    print("tile kernels' resources [16 chains, shared y; ring at m = 25 for the rolled; "
          "the M = 20 team bodies as <name>_team<20>]: " + json.dumps(out), flush=True)
    # 93 instances a lane a (site, chain) and the 7 team instances, which
    # take the closed-form M = 20 instances of kernel 2 and of kernels 1 and
    # 3 on coords
    _require(len(out) == 100, f"expected 100 tile instances of the three kernels, found "
             f"{len(out)}")
    _require(sum(key.endswith("_team<20>") for key in out) == 7,
             f"expected the 7 M = 20 team instances, found {sorted(out)}")
    smem = {}
    for line, res in zip(usage, usage[1:]):
        # kernels 1 and 3: <GENERAL, COORDS>; kernel 2: <EMIT_Y, GENERAL, COORDS>
        found = re.search(r"(suffstats|bf|grad)_smem_kernelI((?:Lb[01]E)+)", line)
        if "Function" not in line or not found:
            continue
        flags = re.findall(r"Lb([01])E", found.group(2))
        if found.group(1) == "grad":
            emit_y, flags = flags[0], flags[1:]
        name = (found.group(1) + ("_y" if found.group(1) == "grad" and emit_y == "1" else "")
                + ("_nu" if flags[0] == "1" else "") + ("_coords" if flags[1] == "1" else ""))
        base = "vecchia_" + found.group(1)
        stats = dict(re.findall(r"(REG|STACK|SHARED):(\d+)", res))
        regs, stack, static = (int(stats.get(k, 0)) for k in ("REG", "STACK", "SHARED"))
        row = {"registers": regs, "stack": stack, "static_shared": static}
        for m in LARGE_M:
            geo = geometry.smem_geometry(10_112, m, CHAINS, base)
            warps = geo.block // 32
            per_warp = -(-regs * 32 // 256) * 256
            blocks = min(65_536 // per_warp // warps,
                         233_472 // (geo.smem_bytes + static), 64 // warps, 32)
            row[f"m{m}"] = {"group": geo.group, "dynamic_shared": geo.smem_bytes,
                            "warps_per_sm": blocks * warps}
        smem[name] = row
    print("shared-memory bodies' resources [kernels 1 and 3, 32 < m <= "
          f"{geometry.M_SMEM}; kernel 2, 32 < m <= {geometry.M_SMEM_GRAD}; 16 chains]: "
          + json.dumps(smem), flush=True)
    _require(len(smem) == 16, f"expected 16 shared-memory kernels, found {len(smem)}")
    cluster = {}
    for line, res in zip(usage, usage[1:]):
        # the cluster body: kernels 1 and 3 <GENERAL, COORDS>, kernel 2
        # <EMIT_Y, GENERAL, COORDS>
        found = re.search(r"(suffstats|bf|grad)_cluster_kernelI((?:Lb[01]E)+)", line)
        if "Function" not in line or not found:
            continue
        flags = re.findall(r"Lb([01])E", found.group(2))
        if found.group(1) == "grad":
            emit_y, flags = flags[0], flags[1:]
        name = (found.group(1) + ("_y" if found.group(1) == "grad" and emit_y == "1" else "")
                + ("_nu" if flags[0] == "1" else "") + ("_coords" if flags[1] == "1" else ""))
        stats = dict(re.findall(r"(REG|STACK|SHARED):(\d+)", res))
        cluster[name] = {"registers": int(stats.get("REG", 0)),
                         "stack": int(stats.get("STACK", 0)),
                         "static_shared": int(stats.get("SHARED", 0)),
                         **{f"m{m}": {"cluster_blocks": geometry.cluster_blocks(m),
                                      "dynamic_shared": geometry.cluster_block_bytes(
                                          m, geometry.cluster_blocks(m))}
                            for m in CLUSTER_CHECK_M}}
    print(f"cluster bodies' resources [kernels 1 and 3, {geometry.M_SMEM} < m <= "
          f"{geometry.M_CLUSTER}; kernel 2, {geometry.M_SMEM_GRAD} < m <= "
          f"{geometry.M_CLUSTER_GRAD}; {geometry.CLUSTER_THREADS} threads a block]: "
          + json.dumps(cluster), flush=True)
    _require(len(cluster) == 16, f"expected 16 cluster-body kernels, found {len(cluster)}")
    return out


def team_resources(resources: dict, row: str) -> dict:
    """An M = 20 team row's registers, stack and lanes a system (its
    instance without noise weights, from :func:`tile_resources`); {} for
    any other row."""
    if "_m20" not in row:
        return {}
    res = resources[row.removeprefix("vecchia_").split("_m20")[0] + "_team<20>"]
    return {key: res[key] for key in ("registers", "stack", "team_lanes")}


def hetero_main_path(dev) -> dict:
    """Heterogeneous noise on the main path: bench_field's n=100,000 signal
    plus N(0, 0.09 v_i) noise from the same draws, v ~ U(0.25, 4)
    (noise_weights), ResponseNNGP(noise=HeterogeneousNoise(v)), m=15, sqexp;
    bench_ess's MWG recipe with the main path's fit_map(250), the pilot cut
    to 16 x (400 + 600) and the run to 16 x (250 + 750) (the recipe has
    800 + 1200 and 500 + 6000; 800 + 1200 and 500 + 1500 until the script
    neared its time limit).  Kernel 1's hetero instance per proposal, kernel
    2's in MAP."""
    v = noise_weights(N_MAIN)
    coords, y = bench_field(N_MAIN, seed=0, noise_v=v)
    _reset_counts()
    t0 = time.perf_counter()
    model = ResponseNNGP(coords, y, kernel="sqexp", m=M_MAIN,
                         noise=HeterogeneousNoise(v), device=dev)
    setup_s = time.perf_counter() - t0
    res = {"setup_s": setup_s,
           **_mwg_recipe(model, (400, 600), (250, 750), f"hetero_n{N_MAIN}_m{M_MAIN}")}
    draws = res.pop("draws")
    del res["map_fit"], res["init"]
    launches = _read_counts("hetero response",
                            ("vecchia_suffstats_hetero", "vecchia_grad_hetero"))
    res.update(launches=launches, plain_calls=0)
    print("hetero main path: " + json.dumps(res), flush=True)
    _require(all(np.isfinite(v).all() for v in draws.values()), "non-finite hetero draws")
    _require(draws["phi"].shape == (CHAINS, 750), "hetero draws have the wrong shape")
    tau2 = res["posterior_mean"]["tau2"]
    _require(TAU2_TRUE / 2 <= tau2 <= TAU2_TRUE * 2,
             f"hetero posterior mean tau2 {tau2} is not within 2x of 0.09")
    return res


def hetero_fixed_effects_path(dev) -> dict:
    """Path 16's data plus x @ [1, -2]: MWG with 16 chains cut to 100 + 100
    steps (kernel 3's hetero instance at each of the two proposals of a
    step), then fit_map(150) with x= and NUTS with 4 chains cut to 50 + 50 at
    max_depth 6 from the Laplace fit (kernel 2's EMIT_Y hetero instance and
    the y-cotangent gather per leapfrog).  Gate: the slope within 0.1 of -2
    from both."""
    v = noise_weights(N_MAIN)
    coords, y = bench_field(N_MAIN, seed=0, noise_v=v)
    x = np.column_stack([np.ones(N_MAIN), np.random.default_rng(1).standard_normal(N_MAIN)])
    beta_true = np.array([1.0, -2.0])
    _reset_counts()
    model = ResponseNNGP(coords, y + x @ beta_true, kernel="sqexp", m=M_MAIN, x=x,
                         noise=HeterogeneousNoise(v), device=dev)
    t0 = time.perf_counter()
    mwg = model.sample(100, n_burn=100, n_chains=CHAINS, seed=0,
                       init={"sigma2": 1.0, "phi": 0.1, "alpha": 0.1})
    mwg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mp = model.fit_map(n_steps=150)
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    map_launches = diff_ops.COUNTS["vecchia_grad_y_hetero"].launches
    t0 = time.perf_counter()
    draws = model.sample_nuts(50, n_burn=50, n_chains=4, seed=0, max_depth=6,
                              init_u=mp.u, init_inv_mass=mp.laplace_cov, init_jitter=2.0)
    nuts_s = time.perf_counter() - t0
    launches = _read_counts("hetero fixed effects",
                            ("vecchia_bf_hetero", "vecchia_grad_y_hetero"))
    slopes = {"mwg": float(mwg["beta"][..., 1].mean()),
              "nuts": float(draws["beta"][..., 1].mean())}
    res = {
        "mwg_s": mwg_s, "mwg_ms_per_step": mwg_s * 1e3 / 200, "map_s": map_s,
        "nuts_s": nuts_s,
        **_nuts_summary(draws, 50, "vecchia_grad_y_hetero",
                        launches["vecchia_grad_y_hetero"] - map_launches),
        "slope_mean": slopes, "beta_true": beta_true.tolist(),
        "mwg_posterior_mean": {k: float(np.mean(mwg[k])) for k in ("sigma2", "phi", "tau2")},
        "launches": launches, "plain_calls": 0,
    }
    print("hetero fixed-effects path: " + json.dumps(res), flush=True)
    _require(all(np.isfinite(a).all() for out in (mwg, draws) for a in out.values()),
             "non-finite hetero fixed-effects draws")
    _require(launches["vecchia_bf_hetero"] >= 2 * 200,
             "fewer kernel-3 launches than two a MWG step")
    for sampler, slope in slopes.items():
        _require(abs(slope - beta_true[1]) <= 0.1,
                 f"hetero {sampler} posterior mean slope {slope} is not within 0.1 of -2")
    return res


def hetero_latent_path(dev) -> dict:
    """LatentNNGP(exponential, m=15) on config 2's shapes (n=10,000, its
    field from default_rng(0)) with N(0, 0.09 v_i) noise from the same draws,
    v ~ U(0.25, 4): 8 chains cut to 150 + 150 steps (300 + 300 before, halved
    to keep the script under its time limit), w_every=8 (config 2's recipe
    has 500 + 1000); then the same data plus x @ [1, -2], 8 chains
    150 + 150 from the first run's posterior means, through the V^-1-weighted
    beta update.  Kernel 3 runs at alpha = 0 without the weights.  Gates:
    all draws finite, tau2 within 2x of 0.09 in both, the slope within 0.1
    of -2."""
    n, chains = 10_000, 8
    v = noise_weights(n)
    coords, y = config2_field(n, 10.0, np.random.default_rng(0), noise_v=v)
    noise = HeterogeneousNoise(v)
    _reset_counts()
    t0 = time.perf_counter()
    model = LatentNNGP(coords, y, kernel="exponential", m=M_MAIN, noise=noise, device=dev)
    setup_s = time.perf_counter() - t0
    init = {"sigma2": float(np.var(y)) * 0.8, "phi": 0.1, "tau2": float(np.var(y)) * 0.15}
    t0 = time.perf_counter()
    draws = model.sample(150, n_burn=150, n_chains=chains, seed=0, init=init, w_every=8)
    run_s = time.perf_counter() - t0
    means = {k: float(np.mean(draws[k])) for k in ("sigma2", "phi", "tau2")}
    x = np.column_stack([np.ones(n), np.random.default_rng(1).standard_normal(n)])
    beta_true = np.array([1.0, -2.0])
    fixed = LatentNNGP(coords, y + x @ beta_true, kernel="exponential", m=M_MAIN, x=x,
                       noise=noise, device=dev)
    t0 = time.perf_counter()
    with_x = fixed.sample(150, n_burn=150, n_chains=chains, seed=1, init=means,
                          collect_w=False)
    x_s = time.perf_counter() - t0
    launches = _read_counts("hetero latent", ("vecchia_bf",))
    means_x = {k: float(np.mean(with_x[k])) for k in ("sigma2", "phi", "tau2")}
    slope = float(with_x["beta"][..., 1].mean())
    res = {
        "setup_s": setup_s, "run_s": run_s, "ms_per_step": run_s * 1e3 / 300,
        "colors": model.n_colors, "posterior_mean": means,
        "fixed_effects": {"run_s": x_s, "posterior_mean": means_x, "slope_mean": slope,
                          "intercept_mean": float(with_x["beta"][..., 0].mean())},
        "launches": launches, "plain_calls": 0, "w_shape": list(draws["w"].shape),
    }
    res["min_ess"], res["rhat_max"] = _chain_stats(draws)
    print("hetero latent path [n10000]: " + json.dumps(res), flush=True)
    _require(all(np.isfinite(a).all() for out in (draws, with_x) for a in out.values()),
             "non-finite hetero latent draws")
    _require(draws["w"].shape == (chains, -(-150 // 8), n),
             f"w draws have the wrong shape {draws['w'].shape}")
    for label, m_ in (("", means), (" with fixed effects", means_x)):
        _require(TAU2_TRUE / 2 <= m_["tau2"] <= TAU2_TRUE * 2,
                 f"hetero latent posterior mean tau2{label} {m_['tau2']} is not within "
                 "2x of 0.09")
    _require(abs(slope - beta_true[1]) <= 0.1,
             f"hetero latent posterior mean slope {slope} is not within 0.1 of -2")
    return res


# ---- tempered SMC, ADVI and checkpoint / resume (slice 9) ----------------

N_C4, M_C4, PARTICLES_C4, MOVES_C4 = 50_000, 10, 512, 3  # bench.py's config 4
# the reference's config-4 run (CONFIGS_r05.json), printed beside the port's:
# how many tempering stages the adaptive schedule takes on this data, and the
# evidence it ends with
REFERENCE_C4 = {"stages": 147, "log_z": -14967.27}


def config4_field():
    """bench.py's full-run data stream (l.722-730): ``default_rng(0)``, whose
    first two fields are config 2's (n=10,000, scale 10) and config 3's
    discarded one (n=25,000, scale 15), then config 4's (n=50,000, scale
    18; l.900)."""
    rng = np.random.default_rng(0)
    config2_field(10_000, 10.0, rng)
    config2_field(25_000, 15.0, rng)
    return config2_field(N_C4, 18.0, rng)


def _weighted_means(draws) -> dict:
    w = np.exp(draws["logw"] - np.logaddexp.reduce(draws["logw"]))
    return {k: float(np.sum(w * draws[k])) for k in ("sigma2", "phi", "tau2")}


def config4_path(dev) -> dict:
    """bench.py's config 4 (l.897-918), uncut: ResponseNNGP(sqexp, m=10) at
    n=50,000, then sample_smc(n_particles=512, n_move=3, seed=0), timed from
    the model's construction as bench.py times it.  Each stage's three moves
    evaluate all 512 particles in one launch of kernel 1 each.  Gates: beta
    reaches 1 within max_stages, log Z finite, the weighted tau2 mean within
    2x of 0.09, kernel 1 launched 1 + 3 x stages times and kernel 2 never.
    Then the device idle share of a stage, and kernel 1 at this launch's
    shape against its plain version and timed beside its bound."""
    coords, y = config4_field()
    _reset_counts()
    t0 = time.perf_counter()
    model = ResponseNNGP(coords, y, kernel="sqexp", m=M_C4, device=dev)
    draws, infos = model.sample_smc(n_particles=PARTICLES_C4, n_move=MOVES_C4, seed=0)
    seconds = time.perf_counter() - t0
    launches = _read_counts("config 4 SMC", ("vecchia_suffstats",))
    stages = len(infos)
    means = _weighted_means(draws)
    res = {
        f"config4_smc_particles_per_sec_n{N_C4}": PARTICLES_C4 * stages / seconds,
        "seconds": seconds, "stages": stages, "log_z": draws["log_z"],
        "reference_run": REFERENCE_C4, "final_beta": float(infos[-1]["beta"]),
        "final_ess": float(infos[-1]["ess"]),
        "mean_accept": float(np.mean([float(i["accept"]) for i in infos])),
        "resampled_stages": int(sum(bool(i["resampled"]) for i in infos)),
        "weighted_posterior_mean": means, "launches": launches, "plain_calls": 0,
    }
    print("config 4 SMC path: " + json.dumps(res), flush=True)
    _require(res["final_beta"] >= 1.0 - 1e-9,
             f"SMC stopped at beta {res['final_beta']} after {stages} stages")
    _require(np.isfinite(draws["log_z"]), "config 4's log Z is not finite")
    _require(all(np.isfinite(draws[k]).all() for k in ("sigma2", "phi", "tau2", "logw")),
             "non-finite SMC particles")
    _require(TAU2_TRUE / 2 <= means["tau2"] <= TAU2_TRUE * 2,
             f"SMC weighted mean tau2 {means['tau2']} is not within 2x of 0.09")
    _require(launches["vecchia_suffstats"] == 1 + MOVES_C4 * stages,
             f"kernel 1 launched {launches['vecchia_suffstats']} times, not "
             f"1 + {MOVES_C4} x {stages}")
    _require(sum(v for k, v in launches.items() if k != "vecchia_suffstats") == 0,
             f"the SMC launched another kernel than kernel 1: {launches}")

    # where a stage's time goes, from a fresh cloud at beta = 0
    gen = torch.Generator().manual_seed(1)
    stage = smc.make_smc_stage(model.full_logprior, model.full_loglik, MOVES_C4)
    with torch.no_grad():
        u0 = model.sample_prior_u(gen, PARTICLES_C4)
        zero = torch.zeros((), dtype=u0.dtype)
        state = smc.SMCState(u=u0, loglik=model.full_loglik(u0),
                             logprior=model.full_logprior(u0),
                             logw=torch.zeros(PARTICLES_C4, dtype=u0.dtype), beta=zero,
                             log_z=zero, scale=torch.ones((), dtype=u0.dtype))
        prof = profile_steps(lambda g, s: stage(g, s)[0], state, gen)
    print("config 4 SMC stage profile: " + json.dumps(prof), flush=True)
    res["stage_profile"] = prof

    # kernel 1 at the shape the stages launch it: 512 chains over n=50,000,
    # m=10, against its plain version (float64 on the card, 16 chains a
    # call) and timed beside its bound
    case = Case(N_C4, M_C4, SqExp(), PARTICLES_C4, seed=0, dev=dev, field=(coords, y))
    case.chunk = 16
    res["parity"] = check_forward(case, f"n{N_C4} m{M_C4} {PARTICLES_C4} chains")
    res["kernel_ms"] = _time_ms(lambda: fwd_ops.suffstats(
        case.kernel, case.tab32, case.phi, case.alpha, case.y32, case.jitter), 5, 50)
    res["bound_ms"], res["bound_by"] = kernel_bounds(case)["vecchia_suffstats"]
    print(f"kernel 1 at config 4's launch [n{N_C4} m{M_C4}, {PARTICLES_C4} chains]: "
          + json.dumps({k: res[k] for k in ("kernel_ms", "bound_ms", "bound_by")}),
          flush=True)
    return res


def advi_path(dev, mwg_means: dict) -> dict:
    """ADVI on the main path's model and data (n=100,000, m=15, sqexp):
    fit_advi(n_steps=1000, n_mc=8, seed=0), then a full-rank fit of 250
    steps (2000 and 500 until the script neared its time limit); each step
    one launch of kernel 2 for its eight points.  Gates:
    each fit's ELBO higher over its last 100 steps than over its first 100,
    the mean-field draws' tau2 within 2x of 0.09, kernel 2 launched once a
    step and no other kernel, every draw finite."""
    coords, y = bench_field(N_MAIN, seed=0)
    model = ResponseNNGP(coords, y, kernel="sqexp", m=M_MAIN, device=dev)
    _reset_counts()
    fits, seconds = {}, {}
    for name, steps, full_rank in (("mean_field", 1000, False), ("full_rank", 250, True)):
        t0 = time.perf_counter()
        fits[name] = model.fit_advi(n_steps=steps, n_mc=8, full_rank=full_rank, seed=0)
        seconds[name] = time.perf_counter() - t0
    launches = _read_counts("ADVI", ("vecchia_grad",))
    res = {"launches": launches, "plain_calls": 0, "mwg_posterior_mean": mwg_means}
    for name, (draws, fit) in fits.items():
        elbo = fit.elbo_trace.numpy()
        steps = len(elbo)
        res[name] = {
            "seconds": seconds[name], "steps": steps,
            "ms_per_step": seconds[name] * 1e3 / steps,
            "elbo_first_100": float(elbo[:100].mean()),
            "elbo_last_100": float(elbo[-100:].mean()),
            "posterior_mean": {k: float(np.mean(draws[k])) for k in ("sigma2", "phi", "tau2")},
            "posterior_sd": {k: float(np.std(draws[k])) for k in ("sigma2", "phi", "tau2")},
        }
    print("ADVI path: " + json.dumps(res), flush=True)
    for name, (draws, fit) in fits.items():
        _require(all(np.isfinite(v).all() for v in draws.values())
                 and bool(torch.isfinite(fit.elbo_trace).all()),
                 f"non-finite ADVI draws or ELBO ({name})")
        _require(res[name]["elbo_last_100"] > res[name]["elbo_first_100"],
                 f"the {name} ELBO did not rise")
    tau2 = res["mean_field"]["posterior_mean"]["tau2"]
    _require(TAU2_TRUE / 2 <= tau2 <= TAU2_TRUE * 2,
             f"ADVI posterior mean tau2 {tau2} is not within 2x of 0.09")
    _require(launches["vecchia_grad"] == 1250
             and sum(launches.values()) == launches["vecchia_grad"],
             f"ADVI's 1,250 steps made other launches than one of kernel 2 each: {launches}")
    # where a step's time goes: one-step fits from the mean-field result
    gen = torch.Generator().manual_seed(1)
    mu = fits["mean_field"][1].mu
    step = lambda g, u: vi.advi_fit(model.full_logpost, model.full_dim(), g, n_steps=1,
                                    n_mc=8, init_mu=u, dtype=model.dtype).mu
    res["step_profile"] = profile_steps(step, mu, gen)
    print("ADVI step profile: " + json.dumps(res["step_profile"]), flush=True)
    return res


class _Interrupt(Exception):
    pass


class _StopAfter:
    """Stands in for ``obj.name`` and raises on the call after ``limit``
    calls: a run stopped mid-chunk, as a preemption stops it."""

    def __init__(self, obj, name, limit):
        self.obj, self.name, self.orig = obj, name, getattr(obj, name)
        self.calls, self.limit = 0, limit
        setattr(obj, name, self)

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.calls > self.limit:
            raise _Interrupt
        return self.orig(*args, **kwargs)

    def restore(self):
        delattr(self.obj, self.name)


def _stopped_and_resumed(run, obj, name, limit, ckpt_kw) -> dict:
    """``run(**kw)`` stopped at ``obj.name``'s call ``limit + 1``, then run
    again with the same arguments, which resumes from the checkpoint."""
    stop = _StopAfter(obj, name, limit)
    try:
        run(**ckpt_kw)
        raise SmokeFailure(f"the run did not stop after {limit} calls of {name}")
    except _Interrupt:
        pass
    finally:
        stop.restore()
    return run(**ckpt_kw)


def _same_draws(want: dict, got: dict, label: str) -> None:
    _require(want.keys() == got.keys()
             and all(np.array_equal(want[k], got[k]) for k in want),
             f"the resumed {label} run's draws differ from the uninterrupted run's")


def resume_path(dev, tmp: str) -> dict:
    """Interrupt and resume on the card, every checkpoint under ``tmp``: the
    main path's model with 16 chains of MWG, 200 + 400 steps in chunks of
    100, checkpointed every chunk, stopped after 450 steps and resumed; NUTS
    on the same model (path 5's recipe cut to 4 chains x (20 + 20), chunks
    of 10) and the latent model on config 2's field (n=10,000, 8 chains, 50
    + 100, w_every=8, chunks of 25), each stopped inside its last chunk.
    Gates: each resumed run's draws equal to the uninterrupted run's bit for
    bit; a resume with another thin, collect_every or config raises a
    ValueError naming it."""
    from pynngp_tpu_torch.config import NNGPConfig

    coords, y = bench_field(N_MAIN, seed=0)
    _reset_counts()
    model = ResponseNNGP(coords, y, kernel="sqexp", m=M_MAIN, device=dev)
    cfg = NNGPConfig(model="response", kernel="sqexp", m=M_MAIN, sampler="mwg",
                     n_samples=400, n_burn=200, n_chains=CHAINS)
    mwg = lambda **kw: model.sample(400, n_burn=200, n_chains=CHAINS, seed=3,
                                    chunk=100, **kw)
    ck = os.path.join(tmp, "mwg")
    ckpt_kw = dict(checkpoint_path=ck, checkpoint_every=1, config=cfg)
    res = {}
    t0 = time.perf_counter()
    want = mwg()
    res["mwg_run_s"] = time.perf_counter() - t0
    digests = {"mwg": _digest(want)}
    t0 = time.perf_counter()
    got = _stopped_and_resumed(mwg, model, "step", 450, ckpt_kw)
    res["mwg_stopped_and_resumed_s"] = time.perf_counter() - t0
    _same_draws(want, got, "MWG")
    refusals = {}
    for label, key, other in (
            ("thin", "thin", dict(thin=2)),
            ("collect_every", "collect_every", dict(collect_every={"loglik": 2})),
            ("config", "n_chains", dict(config=dataclasses.replace(cfg, n_chains=8)))):
        try:
            mwg(**{**ckpt_kw, **other})
            raise SmokeFailure(f"a resume with another {label} did not raise")
        except ValueError as err:
            _require(key in str(err), f"the refusal does not name {key}: {err}")
            refusals[label] = str(err)[:160]
    res["refusals"] = refusals

    mp = model.fit_map(n_steps=250)
    nuts = lambda **kw: model.sample_nuts(20, n_burn=20, n_chains=4, seed=0, max_depth=6,
                                          init_u=mp.u, init_inv_mass=mp.laplace_cov,
                                          init_jitter=2.0, chunk=10, **kw)
    count = _StopAfter(model, "full_value_and_grad", 10**9)
    try:
        want = nuts()
    finally:
        count.restore()
    got = _stopped_and_resumed(nuts, model, "full_value_and_grad", count.calls - 5,
                               dict(checkpoint_path=os.path.join(tmp, "nuts"),
                                    checkpoint_every=1))
    _same_draws(want, got, "NUTS")
    res["nuts_value_and_grad_calls"] = count.calls
    digests["nuts"] = _digest(want)

    n = 10_000
    lat_coords, lat_y = config2_field(n, 10.0, np.random.default_rng(0))
    latent = LatentNNGP(lat_coords, lat_y, kernel="exponential", m=M_MAIN, device=dev)
    init = {"sigma2": float(np.var(lat_y)) * 0.8, "phi": 0.1,
            "tau2": float(np.var(lat_y)) * 0.15}
    lat = lambda **kw: latent.sample(100, n_burn=50, n_chains=8, seed=0, init=init,
                                     w_every=8, chunk=25, **kw)
    want = lat()
    got = _stopped_and_resumed(lat, latent, "step", 140,
                               dict(checkpoint_path=os.path.join(tmp, "latent"),
                                    checkpoint_every=1))
    _same_draws(want, got, "latent")
    res["latent_w_shape"] = list(got["w"].shape)
    digests["latent"] = _digest(want)
    res["launches"] = _read_counts("resume", ("vecchia_suffstats", "vecchia_grad",
                                              "vecchia_bf"))
    res["plain_calls"] = 0
    res["draws_sha256"] = digests
    print("resume path: " + json.dumps(res), flush=True)
    return res


# ---- prediction, the facade, the orderings, the dot-product distance -----
# (slice 10)


N_PRED = 10_000  # path 23's new sites
N_SPHERE, N_SPHERE_HELD = 20_000, 2_000  # path 26's training and held-out sites


def bench_surface(coords0, n: int = N_MAIN, seed: int = 0):
    """bench_field(n, seed)'s noiseless RFF field evaluated at ``coords0``:
    the same frequencies and phases, drawn after the n sites."""
    rng = np.random.default_rng(seed)
    rng.uniform(size=(n, 2))
    freqs = rng.normal(scale=20.0, size=(256, 2))
    phases = rng.uniform(0, 2 * np.pi, 256)
    return np.sqrt(2 / 256) * np.cos(coords0 @ freqs.T + phases).sum(axis=1)


def sphere_field(n: int, seed: int = 0):
    """n sites on the unit sphere (unit vectors in R^3, uniform) and a
    256-feature RFF draw of a GP over their 3-D coordinates with frequencies
    N(0, 5^2 I) (a Gaussian kernel of the chord, lengthscale sqrt(2)/5),
    plus N(0, 0.3^2) noise; returns (coords, y, the noiseless field).  On
    unit vectors the cosine dissimilarity is half the squared chord, so that
    kernel is the exponential kernel of the dissimilarity with phi = 1/25."""
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((n, 3))
    xyz /= np.linalg.norm(xyz, axis=1, keepdims=True)
    freqs = rng.normal(scale=5.0, size=(256, 3))
    phases = rng.uniform(0, 2 * np.pi, 256)
    w = np.sqrt(2 / 256) * np.cos(xyz @ freqs.T + phases).sum(axis=1)
    return xyz, w + 0.3 * rng.standard_normal(n), w


def _coverage(samples, y0) -> float:
    """Share of sites whose y0 lies in the central 95% interval of their
    predictive samples ((S, n0), on any device)."""
    q = torch.quantile(samples.double(), torch.tensor([0.025, 0.975], dtype=torch.float64,
                                                      device=samples.device), dim=0)
    y0 = torch.as_tensor(y0, device=samples.device)
    return float(((y0 >= q[0]) & (y0 <= q[1])).double().mean())


# Limits of the card's float32 prediction against the port's float64 CPU
# run on the same draws (path 23).  The response model's C_N carries the
# relative nugget alpha = tau2 / sigma2 (~0.09 here), so its condition number
# is below (m + alpha) / alpha ~ 170, and a float32 factor and solves lose
# about 170 x 6e-8 x m ~ 2e-4 of the weights; the mean sums 15 of them times
# |y| <= ~2: mean atol 2e-3.  The variance is sigma2 (1 - c' C^-1 c) + tau2
# >= tau2 = 0.09, whose cancellation loses ~2e-4 sigma2: var rtol 1e-3.
PRED_MEAN_ATOL, PRED_VAR_RTOL = 2e-3, 1e-3


def _prediction_parity(kernel, gp, coords0, param_draws, out, sites: int, draws: int,
                       label: str) -> dict:
    """The card's float32 ``mean`` / ``var`` on the first ``sites`` sites and
    ``draws`` draws against predict_draws in float64 on the CPU, on the same
    float32-rounded training coordinates and y."""
    table64 = build_prediction_table(gp._train_coords, coords0[:sites], gp.m,
                                     metric=gp.distance, dtype=torch.float64,
                                     device="cpu")
    first = {k: v[:draws] for k, v in param_draws.items()}
    want = predict_draws(kernel, table64, gp.model.y.double().cpu(), first)
    res = {
        "mean_max_abs_err": float((out["mean"][:draws, :sites].double().cpu()
                                   - want["mean"]).abs().max()),
        "var_max_rel_err": float(((out["var"][:draws, :sites].double().cpu()
                                   - want["var"]) / want["var"]).abs().max()),
        "mean_atol": PRED_MEAN_ATOL, "var_rtol": PRED_VAR_RTOL,
    }
    print(f"prediction parity [{label}]: " + json.dumps(res), flush=True)
    _require(res["mean_max_abs_err"] <= PRED_MEAN_ATOL
             and res["var_max_rel_err"] <= PRED_VAR_RTOL,
             f"the card's prediction disagrees with the float64 CPU run [{label}]")
    return res


def _flat_thinned(draws: dict, thin: int) -> dict:
    """(sigma2, tau2, phi) over the flattened chains, one in ``thin``: the
    draws the facade's predict takes."""
    return {k: np.asarray(draws[k]).reshape(-1)[::thin] for k in ("sigma2", "tau2", "phi")}


def prediction_path(dev, draws) -> dict:
    """Path 23: prediction at the main path's full width through the
    facade.  SeqNNGP(sqexp, m=15, response) on path 1's data; predict at
    10,000 new sites (uniform, default_rng(1)) from path 1's 16 x 3,000
    draws, one in 50 (960 draws), with samples.  Gates: finite outputs on
    the card, the central 95% predictive intervals covering y0 (the field
    there plus N(0, 0.09) from default_rng(2)) at 0.93-0.97, the posterior
    mean's RMSE against the noiseless field below the noise sd 0.3, and the
    float32 mean and var against the float64 CPU run on 500 sites x 16
    draws (PRED_MEAN_ATOL, PRED_VAR_RTOL)."""
    coords, y = bench_field(N_MAIN, seed=0)
    coords0 = np.random.default_rng(1).uniform(size=(N_PRED, 2))
    truth = bench_surface(coords0)
    y0 = truth + 0.3 * np.random.default_rng(2).standard_normal(N_PRED)
    thin = 50
    _reset_counts()
    t0 = time.perf_counter()
    gp = SeqNNGP(y, coords, m=M_MAIN, cov_model="sqexp", model="response", device=dev)
    setup_s = time.perf_counter() - t0
    # first linear-algebra calls of the process load their libraries: warm up
    gp.predict(coords0[:100], draws=draws, thin=6_000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    build_prediction_table(gp._train_coords, coords0, M_MAIN, device=dev)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(3)
    t0 = time.perf_counter()
    out = gp.predict(coords0, draws=draws, thin=thin, generator=gen)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    n_draws = out["mean"].shape[0]
    _require(all(v.is_cuda for v in out.values()), "prediction left the card")
    finite = all(bool(torch.isfinite(v).all()) for v in out.values())
    pm = out["mean"].mean(0).double().cpu().numpy()
    res = {
        "setup_s": setup_s, "table_s": table_s, "predict_s": predict_s,
        "draws": n_draws, "sites": N_PRED, "m": M_MAIN,
        "ms_per_draw": (predict_s - table_s) * 1e3 / n_draws,
        "rmse_vs_field": float(np.sqrt(np.mean((pm - truth) ** 2))), "noise_sd": 0.3,
        "coverage_95": _coverage(out["samples"], y0), "finite": finite,
        "parity": _prediction_parity(gp.kernel, gp, coords0, _flat_thinned(draws, thin),
                                     out, 500, 16, "path 23"),
        "launches": _read_counts("prediction", ()), "plain_calls": 0,
    }
    print("prediction path: " + json.dumps(res), flush=True)
    _require(finite, "non-finite predictions")
    _require(n_draws == 960, f"{n_draws} prediction draws, not 960")
    _require(0.93 <= res["coverage_95"] <= 0.97,
             f"95% interval coverage {res['coverage_95']} outside 0.93-0.97")
    _require(res["rmse_vs_field"] < 0.3,
             f"posterior-mean RMSE {res['rmse_vs_field']} is not below 0.3")
    return res


def facade_path(dev) -> dict:
    """Path 24: the facade's defaults end to end.  Config 2's field at n =
    11,000 (default_rng(0)); SeqNNGP(y, coords) on the first 10,000 (the
    latent model, exponential, m = 15: kernel 3), sample(250, n_burn=250,
    n_chains=8) (halved from 500 + 500 to keep the script under its time
    limit; 125 + 125 left tau2 at 0.28, R-hat 1.8), summary(), predict at the 1,000 held out.  Gates: finite
    draws and predictions, tau2 within 2x of 0.09, the predictive mean's
    correlation with the held-out y above 0.7 (tests/test_seq_facade.py:27)."""
    coords, y = config2_field(11_000, 10.0, np.random.default_rng(0))
    train, test = slice(0, 10_000), slice(10_000, 11_000)
    _reset_counts()
    t0 = time.perf_counter()
    gp = SeqNNGP(y[train], coords[train], device=dev)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    draws = gp.sample(250, n_burn=250, n_chains=8)
    sample_s = time.perf_counter() - t0
    summary = gp.summary()
    t0 = time.perf_counter()
    out = gp.predict(coords[test], generator=torch.Generator(device=dev).manual_seed(4))
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    pm = out["mean"].mean(0).double().cpu().numpy()
    res = {
        "setup_s": setup_s, "sample_s": sample_s, "predict_s": predict_s,
        "summary": {k: {q: v[q] for q in ("mean", "q2.5", "q97.5", "ess", "rhat")}
                    for k, v in summary.items() if k in ("sigma2", "tau2", "phi")},
        "prediction_draws": out["mean"].shape[0],
        "corr_heldout": float(np.corrcoef(pm, y[test])[0, 1]),
        "rmse_heldout": float(np.sqrt(np.mean((pm - y[test]) ** 2))),
        "coverage_95": _coverage(out["samples"], y[test]),
        "launches": _read_counts("facade", ("vecchia_bf",)), "plain_calls": 0,
    }
    print("facade path: " + json.dumps(res), flush=True)
    _require(all(np.isfinite(v).all() for v in draws.values()), "non-finite draws")
    _require(all(bool(torch.isfinite(v).all()) for v in out.values()),
             "non-finite predictions")
    tau2 = summary["tau2"]["mean"]
    _require(TAU2_TRUE / 2 <= tau2 <= TAU2_TRUE * 2,
             f"posterior mean tau2 {tau2} is not within 2x of 0.09")
    _require(res["corr_heldout"] > 0.7,
             f"predictive mean correlation {res['corr_heldout']} is not above 0.7")
    return res


def _map_init(model, mp) -> dict:
    """MWG's start at a MAP fit (as _mwg_recipe takes it)."""
    u0 = mp.u.cpu().numpy()
    sig0, tau0 = float(np.exp(u0[0])), float(np.exp(u0[2]))
    return {"sigma2": sig0, "phi": float(model._t_phi.forward(torch.as_tensor(u0[1]))),
            "alpha": tau0 / sig0}


def orderings_path(dev) -> dict:
    """Path 25: the max-min and natural orderings at full width, on path 1's
    data (n=100,000, m=15, sqexp).  ResponseNNGP(ordering="maxmin") (the
    native max-min order), fit_map(250), then 16 chains of correlated-RW MWG
    from the MAP, 100 + 200 (halved from 200 + 400 to keep the script under
    its time limit; kernels 1 and 2); ordering="none" and
    "coordinate": the value and gradient at the max-min MAP (kernel 2).
    Gates: tau2 within 2x of 0.09; the other orders' values and gradients
    finite (they are other models, so they are printed, not compared)."""
    coords, y = bench_field(N_MAIN, seed=0)
    t0 = time.perf_counter()
    neighbors.order_maxmin(coords)
    order_s = time.perf_counter() - t0
    _reset_counts()
    t0 = time.perf_counter()
    model = ResponseNNGP(coords, y, kernel="sqexp", m=M_MAIN, ordering="maxmin",
                         device=dev)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mp = model.fit_map(n_steps=250)
    map_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    draws = model.sample(200, n_burn=100, n_chains=CHAINS, seed=5,
                         init=_map_init(model, mp),
                         proposal_cov=model.theta_proposal_cov(mp.laplace_cov))
    run_s = time.perf_counter() - t0
    min_ess, max_rhat = _chain_stats(draws)
    means = {k: float(np.mean(draws[k])) for k in ("sigma2", "phi", "tau2")}
    at_map = {"maxmin": float(mp.value)}
    finite = True
    for ordering in ("none", "coordinate"):
        t0 = time.perf_counter()
        other = ResponseNNGP(coords, y, kernel="sqexp", m=M_MAIN, ordering=ordering,
                             device=dev)
        other_setup_s = time.perf_counter() - t0
        value, grad = other.full_value_and_grad(mp.u[None].to(dev))
        value, grad = value.double().cpu(), grad.double().cpu()
        finite &= bool(torch.isfinite(value).all() and torch.isfinite(grad).all())
        at_map[ordering] = {"value": float(value[0]), "grad": grad[0].tolist(),
                            "setup_s": other_setup_s}
        del other
    res = {
        "maxmin_order_s": order_s, "setup_s": setup_s, "map_s": map_s, "run_s": run_s,
        "min_ess": min_ess, "rhat_max": max_rhat, "posterior_mean": means,
        "value_at_map": at_map,
        "launches": _read_counts("orderings", ("vecchia_suffstats", "vecchia_grad")),
        "plain_calls": 0,
    }
    print("orderings path: " + json.dumps(res), flush=True)
    _require(all(np.isfinite(v).all() for v in draws.values()), "non-finite draws")
    _require(finite, "a non-finite value or gradient at the MAP on another order")
    _require(TAU2_TRUE / 2 <= means["tau2"] <= TAU2_TRUE * 2,
             f"posterior mean tau2 {means['tau2']} is not within 2x of 0.09")
    return res


def dotproduct_path(dev, tmp: str) -> dict:
    """Path 26: the dot-product distance on the sphere.  sphere_field(22,000);
    the first 20,000 sites train ResponseNNGP(distance="dotproduct",
    exponential, m=15) through the facade (the dist layout: the tables hold
    the cosine dissimilarities), fit_map(150), 16 chains of correlated-RW
    MWG from the MAP, 200 + 400, and predict at the 2,000 held out (one
    draw in 10).  Before the model, kernels 1-3 on these tables against
    their float64 plain versions at the closed-form rows' limits, timed at
    16 chains beside their bounds.  Gates: those, tau2 within 2x of 0.09,
    the 95% coverage of path 23, and the cache: the same table built twice
    with the cache in ``tmp``, the second loaded from its file, bit for
    bit."""
    coords, y, truth = sphere_field(N_SPHERE + N_SPHERE_HELD)
    train, test = slice(0, N_SPHERE), slice(N_SPHERE, None)
    case = Case(N_SPHERE, M_MAIN, Exponential(), CHAINS, seed=0, dev=dev,
                field=(coords[train], y[train]), distance="dotproduct")
    label = f"dotproduct n{N_SPHERE} m{M_MAIN}"
    parity = {"forward": check_forward(case, label),
              "grad": check_grad(case, label, grad_rtol=2e-3),
              "bf": check_bf(case, label, zero_alpha=False, gated=True)}
    k, t = case.kernel, case.tab32
    times = {
        "vecchia_suffstats": _time_ms(lambda: fwd_ops.suffstats(
            k, t, case.phi, case.alpha, case.y32, case.jitter), 20, 200),
        "vecchia_grad": _time_ms(lambda: diff_ops.value_and_grad_sums(
            k, t, case.phi, case.alpha, case.y32, case.jitter), 20, 200),
        "vecchia_bf": _time_ms(lambda: bf_ops.bf_planes(
            k, t, case.phi, case.alpha, case.jitter), 20, 200),
    }
    bounds = kernel_bounds(case)
    kernels_res = {name: {"ms": ms, "bound_ms": bounds[name][0],
                          "share_of_bound": bounds[name][0] / ms}
                   for name, ms in times.items()}
    print(f"dot-product kernels [{label}, {CHAINS} chains]: " + json.dumps(kernels_res),
          flush=True)
    del case, t
    torch.cuda.empty_cache()

    _reset_counts()
    t0 = time.perf_counter()
    gp = SeqNNGP(y[train], coords[train], m=M_MAIN, cov_model="exponential",
                 model="response", distance="dotproduct", device=dev)
    setup_s = time.perf_counter() - t0
    model = gp.model
    _require(model.lane_layout == "dist", f"the dot-product model took {model.lane_layout}")
    t0 = time.perf_counter()
    mp = model.fit_map(n_steps=150)
    map_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    draws = gp.sample(400, n_burn=200, n_chains=CHAINS, seed=6, init=_map_init(model, mp),
                      proposal_cov=model.theta_proposal_cov(mp.laplace_cov))
    run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = gp.predict(coords[test], thin=10,
                     generator=torch.Generator(device=dev).manual_seed(8))
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    _require(all(v.is_cuda for v in out.values()), "prediction left the card")
    launches = _read_counts("dot-product", ("vecchia_suffstats", "vecchia_grad"))
    min_ess, max_rhat = _chain_stats(draws)
    means = {k: float(np.mean(draws[k])) for k in ("sigma2", "phi", "tau2")}
    pm = out["mean"].mean(0).double().cpu().numpy()

    # the cache: one build stores the table, the next loads it
    env = os.environ.get("PYNNGP_NEIGHBOR_CACHE")
    os.environ["PYNNGP_NEIGHBOR_CACHE"] = tmp
    build = neighbors._build_neighbor_table_impl
    try:
        t0 = time.perf_counter()
        first = neighbors.build_neighbor_table(coords[train], M_MAIN, metric="dotproduct")
        cache_first_s = time.perf_counter() - t0
        stored = os.listdir(tmp)

        def rebuilt(*args, **kwargs):
            raise SmokeFailure("the cached neighbor table was rebuilt, not loaded")

        neighbors._build_neighbor_table_impl = rebuilt
        t0 = time.perf_counter()
        second = neighbors.build_neighbor_table(coords[train], M_MAIN, metric="dotproduct")
        cache_second_s = time.perf_counter() - t0
    finally:
        neighbors._build_neighbor_table_impl = build
        os.environ["PYNNGP_NEIGHBOR_CACHE"] = env
    same = all(np.array_equal(a, b) for a, b in zip(first, second))
    without_tables = dotproduct_without_tables(dev, coords[train], y[train], tmp)
    res = {
        "kernels": kernels_res, "setup_s": setup_s, "map_s": map_s, "run_s": run_s,
        "predict_s": predict_s, "prediction_draws": out["mean"].shape[0],
        "min_ess": min_ess, "rhat_max": max_rhat, "posterior_mean": means,
        "rmse_vs_field": float(np.sqrt(np.mean((pm - truth[test]) ** 2))),
        "coverage_95": _coverage(out["samples"], y[test]),
        "cache": {"first_s": cache_first_s, "second_s": cache_second_s,
                  "files": stored, "bitwise_equal": same},
        "parity_max_abs_err": {"suffstats_f": parity["forward"]["f_max_abs_err"],
                               "grad": parity["grad"]["max_abs_err"],
                               "bf_b": parity["bf"]["b_max_abs_err"]},
        "launches": launches, "plain_calls": 0, "without_tables": without_tables,
    }
    print("dot-product path: " + json.dumps(res), flush=True)
    _require(all(np.isfinite(v).all() for v in draws.values()), "non-finite draws")
    _require(all(bool(torch.isfinite(v).all()) for v in out.values()),
             "non-finite predictions")
    _require(TAU2_TRUE / 2 <= means["tau2"] <= TAU2_TRUE * 2,
             f"posterior mean tau2 {means['tau2']} is not within 2x of 0.09")
    _require(0.93 <= res["coverage_95"] <= 0.97,
             f"95% interval coverage {res['coverage_95']} outside 0.93-0.97")
    _require(len(stored) == 1 and same, f"the cache check failed: {res['cache']}")
    return res


def _built_with_peak(build):
    """(object, seconds, peak MB of numpy's host allocations) of ``build()``
    (tracemalloc: the distance tables are numpy arrays)."""
    import tracemalloc

    tracemalloc.start()
    try:
        t0 = time.perf_counter()
        out = build()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = tracemalloc.get_traced_memory()[1] / 1e6
    finally:
        tracemalloc.stop()
    return out, seconds, peak


def dotproduct_without_tables(dev, coords, y, tmp: str) -> dict:
    """Path 26's second half: ``ResponseNNGP`` and ``LatentNNGP``
    with distance="dotproduct" (exponential, m=15) on path 26's 20,000
    training sites, with precomputed tables and with
    ``precompute_distances=False`` (the tables computed from the float64
    coordinates under the model's metric, block by block), all four on the
    same neighbor table (loaded from the cache in ``tmp`` that path 26's
    check filled).  Gates: the recomputed planes equal the precomputed ones
    within one float32 rounding; kernel 1's sums, kernel 2's value and
    gradient and kernel 3's B / F on the recomputed tables equal those on
    the precomputed ones within the closed-form rows' limits (kernel 3 also
    at alpha = 0 on the latent model's tables).  Prints each model's set-up
    seconds and the peak of its numpy host allocations."""
    env = os.environ.get("PYNNGP_NEIGHBOR_CACHE")
    os.environ["PYNNGP_NEIGHBOR_CACHE"] = tmp
    build = neighbors._build_neighbor_table_impl

    def rebuilt(*args, **kwargs):
        raise SmokeFailure("path 26's cached neighbor table was rebuilt, not loaded")

    neighbors._build_neighbor_table_impl = rebuilt
    models, setup = {}, {}
    try:
        for name, cls in (("response", ResponseNNGP), ("latent", LatentNNGP)):
            for pre in (True, False):
                key = f"{name}_{'precomputed' if pre else 'recomputed'}"
                models[key], secs, peak = _built_with_peak(lambda: cls(
                    coords, y, kernel="exponential", m=M_MAIN, distance="dotproduct",
                    precompute_distances=pre, device=dev))
                setup[key] = {"setup_s": secs, "peak_numpy_mb": peak}
    finally:
        neighbors._build_neighbor_table_impl = build
        os.environ["PYNNGP_NEIGHBOR_CACHE"] = env
    res = {"setup": setup, "planes_max_ulps": {}, "kernels": {}}
    for name in ("response", "latent"):
        pre, rec = models[f"{name}_precomputed"], models[f"{name}_recomputed"]
        _require(rec.tables.layout == pre.tables.layout == "dist"
                 and np.array_equal(rec.table.nn_idx, pre.table.nn_idx),
                 f"the {name} models do not share the dist layout and neighbor table")
        for plane in ("tab_a", "tab_b"):
            a, b = getattr(rec.tables, plane), getattr(pre.tables, plane)
            ulps = float(((a.double() - b.double()).abs()
                          / (b.double().abs() * 2.0**-24).clamp(min=2.0**-149)).max())
            res["planes_max_ulps"][f"{name}_{plane}"] = ulps
            _require(ulps <= 1.0, f"the {name} model's recomputed {plane} is {ulps} "
                     "float32 roundings from the precomputed one")
    kern = Exponential()
    phi = torch.linspace(0.02, 0.08, CHAINS, device=dev)  # the field's phi, 1/25
    alpha = torch.full((CHAINS,), TAU2_TRUE, device=dev)
    y32 = models["response_precomputed"].y
    out = {}
    for key in ("response_precomputed", "response_recomputed"):
        t = models[key].tables
        ld, q, f, _ = fwd_ops.suffstats(kern, t, phi, alpha, y32, 1e-6)
        sums = diff_ops.value_and_grad_sums(kern, t, phi, alpha, y32, 1e-6)
        b, fb = bf_ops.bf_planes(kern, t, phi, alpha, 1e-6)
        out[key] = (ld.double(), q.double(), f.double(), sums.double(), b.double(),
                    fb.double())
    for key in ("latent_precomputed", "latent_recomputed"):
        b, fb = bf_ops.bf_planes(kern, models[key].tables, phi, torch.zeros_like(alpha),
                                 1e-6)
        out[key] = (b.double(), fb.double())
    torch.cuda.synchronize()
    (ld0, q0, f0, s0, b0, fb0), (ld1, q1, f1, s1, b1, fb1) = (
        out["response_precomputed"], out["response_recomputed"])
    lb0, lf0 = out["latent_precomputed"]
    lb1, lf1 = out["latent_recomputed"]
    k = res["kernels"]
    k["suffstats_logdet_rel"], k["suffstats_quad_rel"] = _rel(ld1, ld0), _rel(q1, q0)
    k["suffstats_f_ratio"] = _allclose_ratio(f1, f0, 1e-4, 1e-6)
    k["grad_value_rel"], k["grad_dphi_rel"], k["grad_dalpha_rel"] = (
        _rel(s1[:2], s0[:2]), _rel(s1[2:4], s0[2:4]), _rel(s1[4:6], s0[4:6]))
    k["bf_b_max_abs_err"] = float((b1 - b0).abs().max())
    k["bf_f_max_rel_err"] = float(((fb1 - fb0).abs() / fb0.abs()).max())
    k["bf_alpha0_b_max_abs_err"] = float((lb1 - lb0).abs().max())
    k["bf_alpha0_f_max_rel_err"] = float(((lf1 - lf0).abs() / lf0.abs()).max())
    print("dot-product without tables: " + json.dumps(res), flush=True)
    _require(k["suffstats_logdet_rel"] <= 3e-4 and k["suffstats_quad_rel"] <= 3e-4
             and k["suffstats_f_ratio"] <= 1.0,
             "kernel 1 on recomputed dot-product tables differs from the precomputed")
    _require(k["grad_value_rel"] <= 5e-4 and k["grad_dphi_rel"] <= 2e-3
             and k["grad_dalpha_rel"] <= 2e-3,
             "kernel 2 on recomputed dot-product tables differs from the precomputed")
    _require(max(k["bf_b_max_abs_err"], k["bf_f_max_rel_err"],
                 k["bf_alpha0_b_max_abs_err"], k["bf_alpha0_f_max_rel_err"]) <= 3e-5,
             "kernel 3 on recomputed dot-product tables differs from the precomputed")
    del models, out
    torch.cuda.empty_cache()
    return res


# ---- the shard offset, meshes on one card, processes (slice 11) ----------


def _sum_launches(*counts: dict) -> dict:
    """Launch counts of several phases of one path, added name by name."""
    out = {}
    for c in counts:
        for name, launches in c.items():
            out[name] = out.get(name, 0) + launches
    return out


# the meshes of path 27, all of them cuda:0 repeated (one card runs every
# shard in turn); tables built for 4 site shards cut into 2 as well
OFFSET_MESHES = ((1, 2), (1, 4), (2, 2))
# Bound on a sum of the sharded call against the unsharded launch, in units
# of 2^-24 (float32's unit roundoff) of the sum of |per-site terms|.  The
# per-site terms of the two are the same bits (gated).  The tile kernels sum
# them in float32 within a block: a term passes through at most 9 float32
# additions on its way to a partial (at most 4 sites a lane, then a 5-level
# warp tree); the shared-memory bodies of the m = 40 case (kernels 1 and 2)
# sum in float64 and round each partial once.  Both launches then add the
# blocks' partials in float64 and round to float32 once, so each sum is
# within 9 u sum|terms| + u |sum| of the exact one: the two within twice
# 10 u sum|terms|.
SUM_ULPS = 20
U32 = 2.0**-24


def _offset_launches(case: Case, tables, grad: bool = True) -> dict:
    """Every kernel of the case on ``tables`` (unsharded or sharded): kernel
    1 and kernel 2 with the per-chain y, kernel 2's EMIT_Y instances and
    kernel 3 (kernels 1 and 3 alone without ``grad``).  Per-site outputs and
    the float64 sums."""
    k, y, nu, v = case.kernel, case.y32_chains, case.nu, case.v32
    ld, q, f, r = fwd_ops.suffstats(k, tables, case.phi, case.alpha, y, case.jitter,
                                    nu, v)
    b3, f3 = bf_ops.bf_planes(k, tables, case.phi, case.alpha, case.jitter, nu, v)
    if not grad:
        torch.cuda.synchronize()
        return {"sums1": torch.stack([ld, q]).double(), "f": f, "r": r, "bf_b": b3,
                "bf_f": f3}
    sums = diff_ops.value_and_grad_sums(k, tables, case.phi, case.alpha, y,
                                        case.jitter, nu=nu, noise_v=v)
    sums_y, b, rof = diff_ops.value_and_grad_sums(k, tables, case.phi, case.alpha, y,
                                                  case.jitter, emit_y=True, nu=nu,
                                                  noise_v=v)
    torch.cuda.synchronize()
    return {"sums1": torch.stack([ld, q]).double(), "f": f, "r": r,
            "sums2": sums.double(), "sums2_y": sums_y.double(), "b": b, "rof": rof,
            "bf_b": b3, "bf_f": f3}


def _abs_term_sums(case: Case, grad: bool = True) -> dict:
    """sum over the valid sites of |per-site term| of each sum, in float64:
    kernel 2's from its plain version on the card (chunked over chains),
    kernel 1's (the same two as kernel 2's first) from it too; without
    ``grad`` kernel 1's alone, from its float64 plain version."""
    if not grad:
        parts = []
        for sl in case.chunks():
            _, _, pr = case.params64(sl)
            _, _, f, r = fwd_ops.suffstats_reference(case.kernel, case.tab64, pr,
                                                     case.y32_chains[sl].double(), case.v64)
            valid = fwd_ops.global_sites(case.tab64) < case.n
            parts.append(torch.stack([(torch.log(f).abs() * valid).sum(-1),
                                      (r * r / f * valid).abs().sum(-1)]))
        return {"sums1": torch.cat(parts, dim=1)}
    parts = []
    for sl in case.chunks():
        _, _, pr = case.params64(sl)
        terms, _, _ = diff_ops.grad_terms(case.kernel, case.tab64, pr,
                                          case.y32_chains[sl].double(), case.v64)
        parts.append(terms.abs().sum(-1))
    t2 = torch.cat(parts, dim=1)
    return {"sums1": t2[:2], "sums2": t2, "sums2_y": t2}


def shard_offset_case(case: Case, label: str, times: bool = False, grad: bool = True) -> dict:
    """Path 27 on one case: every instance's per-site outputs (kernels 1
    and 3 alone without ``grad``) on meshes OFFSET_MESHES of cuda:0 against
    the unsharded launch on the same tables, bit for bit, and the sums
    within SUM_ULPS; the last shard holds padded sites past n."""
    dev = case.y32.device
    _reset_counts()
    want = _offset_launches(case, case.tab32, grad)
    terms = _abs_term_sums(case, grad)
    res = {"n": case.n, "m": case.m, "layout": case.layout,
           "hetero": case.v32 is not None, "n_pad": case.tab32.n_pad}
    per_site = ("f", "r", "b", "rof", "bf_b", "bf_f") if grad else ("f", "r", "bf_b", "bf_f")
    for shape in OFFSET_MESHES:
        mesh = make_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))
        sharded = shard_site_tables(case.tab32, mesh)
        last = sharded.cells[0][-1]
        _require(last.off + last.n_pad > case.n >= last.off,
                 f"the last shard holds no padded site past n [{label} {shape}]")
        got = _offset_launches(case, sharded, grad)
        # the same bits (NaN included), compared as integers
        same = {key: bool(torch.equal(got[key].view(torch.int32),
                                      want[key].view(torch.int32))) for key in per_site}
        worst = 0.0
        for key in terms:
            bound = (SUM_ULPS * U32 * terms[key]
                     + U32 * (got[key].abs() + want[key].abs()))
            worst = max(worst, float(((got[key] - want[key]).abs() / bound).max()))
        key = f"mesh_{shape[0]}x{shape[1]}"
        res[key] = {"bitwise": same, "sums_over_bound": worst,
                    "sums_max_abs_diff": max(float((got[k] - want[k]).abs().max())
                                             for k in terms),
                    "shard_sites": last.n_pad, "last_shard_padded": last.reach - case.n}
        _require(all(same.values()),
                 f"sharded per-site outputs differ from the unsharded launch "
                 f"[{label} {shape}]: {same}")
        _require(worst <= 1.0, f"sharded sums beyond {SUM_ULPS} ulps of sum|terms| "
                 f"[{label} {shape}]: {worst}")
        if times:  # one call of each kernel, unsharded and on this mesh
            k, y = case.kernel, case.y32_chains
            for name, tab in (("unsharded", case.tab32), (key, sharded)):
                res.setdefault("ms", {})[name] = {
                    "suffstats": _time_ms(lambda: fwd_ops.suffstats(
                        k, tab, case.phi, case.alpha, y, case.jitter), 10, 50),
                    "grad": _time_ms(lambda: diff_ops.value_and_grad_sums(
                        k, tab, case.phi, case.alpha, y, case.jitter), 10, 50),
                    "grad_y": _time_ms(lambda: diff_ops.value_and_grad_sums(
                        k, tab, case.phi, case.alpha, y, case.jitter, emit_y=True),
                        10, 50),
                    "bf": _time_ms(lambda: bf_ops.bf_planes(
                        k, tab, case.phi, case.alpha, case.jitter), 10, 50)}
        del sharded, got
    res["launches"] = _read_counts(f"shard offset {label}", ())
    _require(any(name.endswith("_sharded") for name in res["launches"]),
             f"no sharded launch was counted [{label}]")
    print(f"shard offset [{label}]: " + json.dumps(
        {**res, "launches": {k: v for k, v in res["launches"].items() if v}}), flush=True)
    return res


def shard_offset_path(dev, field3) -> dict:
    """Path 27: the shard offset of all three kernels and the large-m body
    on one card, on meshes (1, 2), (1, 4) and (2, 2) of cuda:0: the main
    case (n=100,000, m=15, sqexp, 16 chains), config 3's general-nu case
    (n=25,000, m=10, sampled nu), the coords layout at the main case's
    shapes, the main case with noise weights, m=40 (n=10,000, the
    large-m instances), the three kernels at m = M_SMEM + 1 (n=1,000, 4
    chains, the cluster body) and m=20 on both layouts
    (n=10,000, 4 chains, the M = 20 team bodies, their unsharded launches of
    four chains).  Tables built for 4 site shards."""
    t0 = time.perf_counter()
    out = {}
    main = Case(N_MAIN, M_MAIN, SqExp(), CHAINS, seed=0, dev=dev, shards=4)
    out["main"] = shard_offset_case(main, "main", times=True)
    out["hetero"] = shard_offset_case(main.with_noise(noise_weights(N_MAIN)), "hetero")
    del main
    out["coords"] = shard_offset_case(
        Case(N_MAIN, M_MAIN, SqExp(), CHAINS, seed=0, dev=dev, layout="coords",
             shards=4), "coords")
    out["general_nu"] = shard_offset_case(
        Case(N_NU, M_NU, Matern(), CHAINS, seed=5, dev=dev, field=field3,
             nu=nu_spread(CHAINS), shards=4), "general nu")
    out["m40"] = shard_offset_case(
        Case(N_LARGE, 40, SqExp(), CHAINS, seed=0, dev=dev, shards=4), "m40")
    m = geometry.M_SMEM + 1
    out["cluster"] = shard_offset_case(
        Case(N_CLUSTER_TIMED, m, SqExp(), 4, seed=0, dev=dev, shards=4),
        f"m{m} cluster body")
    _require(all(out["cluster"]["launches"].get(f"vecchia_{k}_large_cluster{s}", 0) > 0
                 for k in ("suffstats", "grad", "grad_y", "bf") for s in ("", "_sharded")),
             "path 27's cluster case ran no cluster body of a kernel, sharded or not")
    for layout in LAYOUTS:
        out[f"m20_{layout}"] = shard_offset_case(
            Case(N_LARGE, 20, SqExp(), 4, seed=0, dev=dev, layout=layout, shards=4),
            f"m20 {layout}")
        row = "vecchia_grad" + _suffix_of(layout) + "_m20"
        _require(all(out[f"m20_{layout}"]["launches"].get(name, 0) > 0
                     for name in (row, row + "_4_chains")),
                 f"path 27's m = 20 case ran no team body of four chains [{layout}]")
        if layout == "coords":
            rows = [f"vecchia_{k}_coords_m20{s}" for k in ("suffstats", "bf")
                    for s in ("", "_sharded")]
            _require(all(out["m20_coords"]["launches"].get(name, 0) > 0 for name in rows),
                     "path 27's m = 20 case ran no team body of kernel 1 or 3 [coords]")
    torch.cuda.empty_cache()
    out["launches"] = _sum_launches(*(case["launches"] for case in out.values()))
    out["seconds"] = time.perf_counter() - t0
    print(f"path 27: {out['seconds']:.1f} s", flush=True)
    return out


def _loglik_rate(model, u, warm: int = 5) -> tuple:
    """(log-likelihoods (k,), evaluations a second) of ``model`` at the k
    points u, one point a call (kernel 1, no gradient), after ``warm``
    calls."""
    with torch.no_grad():
        for i in range(warm):
            model.full_loglik(u[i:i + 1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = torch.cat([model.full_loglik(u[i:i + 1]) for i in range(u.shape[0])])
        torch.cuda.synchronize()
    return out.double(), u.shape[0] / (time.perf_counter() - t0)


# Path 28's limits on the mesh model against the unsharded one (float32 on
# the card): the log-likelihood and the value with fixed effects rtol 1e-5,
# as path 27 bounds a sum by SUM_ULPS ulps of the sum of |terms| and here those
# are within a few times |log-likelihood|; the gradient 1e-4 of the largest
# entry (its phi and alpha entries are such sums with cancellation, its beta
# entries the same gather of the same planes); one latent step's w 1e-3 of
# max |w| and its scalars rtol 1e-3 (the sharded sweep sums a site's child
# terms in another order, over ~20-40 colour passes).
MESH_LL_RTOL, MESH_GRAD_TOL, MESH_STEP_TOL = 1e-5, 1e-4, 1e-3


def config5_mesh_path(dev) -> dict:
    """Path 28: config 5 (n=500,000, m=20, sqexp, the coords layout) on a
    (1, 4) mesh of cuda:0 against the unsharded model: 50 log-likelihoods
    and their rate (the ratio is the cost of the partitioning on one card,
    printed, not gated), a cut MWG run (16 chains, 150 + 150 steps from near
    the generator's values; tau2 within 2x of 0.09), the value and gradient
    with x @ [1, -2] at 4 points, and the latent model (exponential, the
    coords layout as config5_latent_path builds it): one step against the
    unsharded step from the same generator state, then a cut run (8 chains,
    10 + 10 steps; 20 + 20 before, halved to keep the script under its time
    limit)."""
    t_all = time.perf_counter()
    coords, y = bench_field(N_C5, seed=0)
    mesh = make_mesh(1, 4, devices=[dev] * 4)
    res = {"mesh": mesh.shape}
    one = ResponseNNGP(coords, y, kernel="sqexp", m=M_C5, device=dev, lane_layout="coords")
    _reset_counts()
    t0 = time.perf_counter()
    model = ResponseNNGP(coords, y, kernel="sqexp", m=M_C5, device=dev,
                         lane_layout="coords", mesh=mesh)
    res["setup_s"] = time.perf_counter() - t0
    k = 50
    u = torch.zeros((k, 3), dtype=torch.float32, device=dev)
    u[:, 1] = one._t_phi.inverse(torch.linspace(0.04, 0.1, k, device=dev))
    u[:, 2] = math.log(TAU2_TRUE)
    ll_one, rate_one = _loglik_rate(one, u)
    ll_mesh, rate_mesh = _loglik_rate(model, u)
    ll_rel = float(((ll_mesh - ll_one).abs() / ll_one.abs()).max())
    res.update(loglik_max_rel_diff=ll_rel, evals_per_sec_unsharded=rate_one,
               evals_per_sec_mesh=rate_mesh, partition_overhead=rate_one / rate_mesh)
    _require(ll_rel <= MESH_LL_RTOL, f"mesh log-likelihoods differ by {ll_rel}")
    t0 = time.perf_counter()
    init = {"sigma2": 1.0, "phi": 0.07, "alpha": TAU2_TRUE}
    draws = model.sample(150, n_burn=150, n_chains=CHAINS, seed=3, init=init)
    res["mwg_run_s"] = time.perf_counter() - t0
    res["mwg_posterior_mean"] = {key: float(np.mean(draws[key]))
                                 for key in ("sigma2", "phi", "tau2")}
    res["mwg_rhat_max"] = _chain_stats(draws)[1]
    res["launches"] = _read_counts("config 5 mesh", ("vecchia_suffstats_coords_sharded",
                                                     "vecchia_suffstats_coords_m20_sharded"))
    _require(all(np.isfinite(v).all() for v in draws.values()),
             "non-finite mesh MWG draws")
    tau2 = res["mwg_posterior_mean"]["tau2"]
    _require(TAU2_TRUE / 2 <= tau2 <= TAU2_TRUE * 2,
             f"mesh MWG posterior mean tau2 {tau2} is not within 2x of 0.09")
    del one, model, draws
    torch.cuda.empty_cache()

    # fixed effects: the EMIT_Y instances a shard and the y cotangent over
    # the gathered planes
    x = np.column_stack([np.ones(N_C5), np.random.default_rng(1).standard_normal(N_C5)])
    yx = y + x @ np.array([1.0, -2.0])
    _reset_counts()
    pair = [ResponseNNGP(coords, yx, kernel="sqexp", m=M_C5, x=x, device=dev,
                         lane_layout="coords", mesh=msh) for msh in (None, mesh)]
    ux = torch.tensor([[0.0, 0.0, math.log(TAU2_TRUE), 1.0, -2.0]], dtype=torch.float32)
    ux = ux + 0.05 * torch.arange(4, dtype=torch.float32)[:, None]
    (v1, g1), (v2, g2) = (mdl.full_value_and_grad(ux) for mdl in pair)
    fe = {"value_max_rel_diff": float(((v2 - v1).abs() / v1.abs()).max()),
          "grad_max_abs_diff_over_max": float((g2 - g1).abs().max() / g1.abs().max()),
          "launches": _read_counts("config 5 mesh fixed effects",
                                   ("vecchia_grad_y_coords_sharded",
                                    "vecchia_grad_y_coords_m20_sharded"))}
    res["fixed_effects"] = fe
    _require(fe["value_max_rel_diff"] <= MESH_LL_RTOL and
             fe["grad_max_abs_diff_over_max"] <= MESH_GRAD_TOL,
             f"mesh value and gradient with fixed effects differ: {fe}")
    del pair
    torch.cuda.empty_cache()

    # the latent model: B/F a shard and the sharded chromatic sweep
    port_threshold = site_tables.COORDS_LAYOUT_MIN_SITES
    site_tables.COORDS_LAYOUT_MIN_SITES = 200_000
    try:
        pair = [LatentNNGP(coords, y, kernel="exponential", m=M_C5, device=dev,
                           mesh=msh) for msh in (None, mesh)]
    finally:
        site_tables.COORDS_LAYOUT_MIN_SITES = port_threshold
    _reset_counts()
    chains = 8
    linit = {"sigma2": float(np.var(y)) * 0.8, "phi": 0.1, "tau2": float(np.var(y)) * 0.15}
    stepped = []
    for mdl in pair:
        state = mdl.init_state(chains, linit)
        stepped.append(mdl.step(torch.Generator(device=dev).manual_seed(11), state))
    (s1, s2) = stepped
    step_diff = {"w": float((s2.w - s1.w).abs().max() / s1.w.abs().max())}
    for name in ("sigma2", "tau2", "value", "logdet", "quad_w"):
        a, b = getattr(s1, name).double(), getattr(s2, name).double()
        step_diff[name] = float(((b - a).abs() / a.abs()).max())
    step_diff["phi"] = float((s2.theta_u - s1.theta_u).abs().max())
    res["latent_step_diff"] = step_diff
    _require(all(v <= MESH_STEP_TOL for v in step_diff.values()),
             f"the mesh latent step differs from the unsharded one: {step_diff}")
    t0 = time.perf_counter()
    ldraws = pair[1].sample(10, n_burn=10, n_chains=chains, seed=0, init=linit,
                            w_every=10)
    res["latent_run_s"] = time.perf_counter() - t0
    res["latent_launches"] = _read_counts("config 5 mesh latent",
                                          ("vecchia_bf_coords_sharded",
                                           "vecchia_bf_coords_m20_sharded"))
    res["latent_posterior_mean"] = {key: float(np.mean(ldraws[key]))
                                    for key in ("sigma2", "phi", "tau2")}
    _require(all(np.isfinite(v).all() for v in ldraws.values()),
             "non-finite mesh latent draws")
    res["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["seconds"] = time.perf_counter() - t_all
    res["launches"] = _sum_launches(res.pop("launches"), fe.pop("launches"),
                                    res.pop("latent_launches"))
    print("path 28 (config 5 on a 1x4 mesh of one card): " + json.dumps(res), flush=True)
    del pair, ldraws
    torch.cuda.empty_cache()
    return res


# path 29: two processes on gloo, one card; each process's share of the
# chains, its cut MWG run, and the worker's time limit; then its checkpointed
# run (burn, draws, chunk), a checkpoint every chunk, stopped inside its last
# chunk and resumed
PROCESS_CHAINS, PROCESS_STEPS, PROCESS_TIMEOUT_S = 8, (300, 300), 240
PROCESS_CKPT = (50, 100, 25)


def process_worker(port: int, rank: int, ckpt_dir: str) -> int:
    """One of path 29's two processes (``chip_smoke.py --process-worker
    PORT RANK CKPT_DIR``): the main path's model on a (2, 2) mesh whose
    chains axis runs across the processes (this process's share: 1 x 2 of
    cuda:0), gloo over localhost.  Checks what tests/_distributed_worker.py
    checks: the site-sharded log-likelihood equals the process-local
    unsharded value, and a chain-sharded all_reduce equals the local sum;
    then runs its 8 of 16 chains, cut, and gathers the draws on rank 0.
    Last, per-process checkpoints: its chains' checkpointed MWG
    under ``CKPT_DIR/run`` (``run.p<rank>.*``), stopped inside its last
    chunk and resumed, must give its uninterrupted run's draws bit for
    bit."""
    import torch.distributed as tdist

    from pynngp_tpu_torch.parallel import (global_mesh, initialize_distributed,
                                           process_chain_slice)

    os.environ["PYNNGP_NEIGHBOR_CACHE"] = "0"
    dev = torch.device("cuda", 0)
    initialize_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    mesh = global_mesh(2, 2, devices=[dev, dev])
    _require(mesh.shape == {"chains": 1, "sites": 2}, f"process mesh {mesh.shape}")
    coords, y = bench_field(N_MAIN, seed=0)
    local = ResponseNNGP(coords, y, kernel="sqexp", m=M_MAIN, device=dev)
    model = ResponseNNGP(coords, y, kernel="sqexp", m=M_MAIN, device=dev, mesh=mesh)
    chains = process_chain_slice(2 * PROCESS_CHAINS)
    u = torch.zeros((2 * PROCESS_CHAINS, 3), dtype=torch.float32, device=dev)
    u[:, 1] = local._t_phi.inverse(torch.linspace(0.05, 0.1, 2 * PROCESS_CHAINS,
                                                  device=dev))
    u[:, 2] = math.log(TAU2_TRUE)
    with torch.no_grad():
        mine = model.full_loglik(u[chains]).double()
        every = local.full_loglik(u).double()
    rel = float(((mine - every[chains]).abs() / every[chains].abs()).max())
    _require(rel <= MESH_LL_RTOL, f"rank {rank}: sharded log-likelihood off by {rel}")
    total = mine.sum()
    tdist.all_reduce(total)  # a CUDA tensor: gloo moves it for all_reduce
    sum_rel = float((total - every.sum()).abs() / every.sum().abs())
    _require(sum_rel <= MESH_LL_RTOL, f"rank {rank}: all_reduce off by {sum_rel}")
    mp = model.fit_map(n_steps=150)
    u0 = mp.u.cpu().numpy()
    init = {"sigma2": float(np.exp(u0[0])), "phi": float(model._t_phi.forward(
        torch.as_tensor(u0[1]))), "alpha": float(np.exp(u0[2] - u0[0]))}
    t0 = time.perf_counter()
    # the main path's pilot proposal: joint moves along the projected Laplace
    # covariance (the (sigma2, phi) ridge defeats componentwise steps)
    draws = model.sample(PROCESS_STEPS[1], n_burn=PROCESS_STEPS[0],
                         n_chains=PROCESS_CHAINS, seed=100 + rank, init=init,
                         proposal_cov=model.theta_proposal_cov(mp.laplace_cov))
    run_s = time.perf_counter() - t0
    pooled = {}
    for key in ("sigma2", "phi", "tau2"):  # CPU tensors: gloo gathers them
        mine_d = torch.as_tensor(np.ascontiguousarray(draws[key]))
        parts = [torch.empty_like(mine_d) for _ in range(2)]
        tdist.all_gather(parts, mine_d)
        pooled[key] = torch.cat(parts).numpy()
    res = {"rank": rank, "loglik_rel": rel, "all_reduce_rel": sum_rel,
           "run_s": run_s, "launches": _read_counts(
               f"process {rank}", ("vecchia_suffstats_sharded", "vecchia_grad_sharded"))}
    if rank == 0:
        res["pooled_chains"] = pooled["phi"].shape[0]
        res["rhat_pooled"] = _chain_stats(pooled)[1]
        res["posterior_mean"] = {k: float(np.mean(v)) for k, v in pooled.items()}
    n_burn, n_samples, chunk = PROCESS_CKPT
    run_kw = dict(n_samples=n_samples, n_burn=n_burn, n_chains=PROCESS_CHAINS,
                  seed=200 + rank, init=init, chunk=chunk,
                  proposal_cov=model.theta_proposal_cov(mp.laplace_cov))
    ck = os.path.join(ckpt_dir, "run")
    t0 = time.perf_counter()
    want = model.sample(**run_kw)
    got = _stopped_and_resumed(lambda **kw: model.sample(**run_kw, **kw), model, "step",
                               n_burn + n_samples - 10,
                               {"checkpoint_path": ck, "checkpoint_every": 1})
    _same_draws(want, got, f"rank {rank}'s checkpointed")
    own = [f"{ck}.p{rank}{suffix}" for suffix in (".npz", ".json", ".draws.npz")]
    _require(all(os.path.exists(f) for f in own) and not os.path.exists(ck + ".npz"),
             f"rank {rank} did not write its own checkpoint files: {os.listdir(ckpt_dir)}")
    res["checkpoint"] = {"seconds": time.perf_counter() - t0, "bitwise_equal": True,
                         "files": sorted(os.listdir(ckpt_dir))}
    tdist.barrier()
    tdist.destroy_process_group()
    print("PROCESS OK " + json.dumps(res), flush=True)
    return 0


def processes_path() -> dict:
    """Path 29: two processes on gloo on cuda:0 (NCCL refuses two ranks on
    one card), each running :func:`process_worker` with its own time limit;
    both must print their OK line.  Prints R-hat over the pooled draws."""
    import socket

    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    me = os.path.abspath(__file__)
    ckpt = tempfile.TemporaryDirectory(dir=os.path.dirname(_build.BUILD_DIR))
    procs = [subprocess.Popen([sys.executable, me, "--process-worker", str(port), str(rank),
                               ckpt.name],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=os.path.dirname(me))
             for rank in range(2)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=PROCESS_TIMEOUT_S)
            outs.append((proc.returncode, out, err))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    lines = []
    for rank, (rc, out, err) in enumerate(outs):
        ok = [line for line in out.splitlines() if line.startswith("PROCESS OK ")]
        _require(rc == 0 and ok, f"process {rank} failed (rc={rc}):\n{out[-2000:]}\n"
                 f"{err[-3000:]}")
        lines.append(json.loads(ok[0][len("PROCESS OK "):]))
    # each rank's checkpoint is its own: both exist, and their states differ
    with ckpt:
        states = []
        for rank in range(2):
            with np.load(os.path.join(ckpt.name, f"run.p{rank}.npz")) as z:
                states.append([z[k] for k in sorted(z.files)])
        differ = any(not np.array_equal(a, b) for a, b in zip(*states))
    _require(differ, "the two ranks' checkpoints hold the same state")
    res = {"processes": lines, "seconds": time.perf_counter() - t0,
           "checkpoints_differ": differ,
           "launches": _sum_launches(*(line.pop("launches") for line in lines))}
    print("path 29 (two processes on gloo, one card): " + json.dumps(res), flush=True)
    return res


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    # every neighbor table of this run is built, not loaded from an earlier
    # run's cache, so that the set-up seconds stay cold builds; path 26
    # turns the cache on, in a temporary directory, for its one check
    os.environ["PYNNGP_NEIGHBOR_CACHE"] = "0"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # full float32 in any matrix product of the plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    info = _build.build_info()
    print(f"build: {info['seconds']:.1f} s (cached={info['cached']}), "
          f"{info['nvcc']}, torch {torch.__version__} cuda {torch.version.cuda}, "
          "ptxas: " + "; ".join(ptxas_summary(info["ptxas"], m)
                                for m in fwd_ops.CUDA_M + (geometry.MAX_M,)), flush=True)
    resources = tile_resources(info)
    # the layout phase's set-ups run now, in the background, beside the
    # kernel phases; a path below that fails ends them
    setups = LayoutSetups(LAYOUT_SIZES)
    try:
        return run_phases(t_start, dev, info, resources, setups)
    finally:
        setups.stop()


def run_phases(t_start: float, dev, info: dict, resources: dict,
               setups: LayoutSetups) -> int:
    """main's phases once the kernels are built: the kernel phases, the
    layout phase, paths 1-29 and the closing lines."""

    main_case = Case(N_MAIN, M_MAIN, SqExp(), CHAINS, seed=0, dev=dev)
    small_case = Case(1500, 7, Exponential(), CHAINS, seed=3, dev=dev)
    fwd = check_forward(main_case, "n100000 m15 sqexp")
    check_forward(small_case, "n1500 m7 exponential")
    grad = check_grad(main_case, "n100000 m15 sqexp", grad_rtol=2e-3)
    check_grad(small_case, "n1500 m7 exponential", grad_rtol=2e-4)
    bf_err = check_bf(main_case, "n100000 m15 sqexp", zero_alpha=False, gated=True)
    check_bf(main_case, "n100000 m15 sqexp", zero_alpha=True, gated=False)
    check_bf(small_case, "n1500 m7 exponential", zero_alpha=False, gated=True)
    check_bf(small_case, "n1500 m7 exponential", zero_alpha=True, gated=True)
    grad_y = check_grad_y(main_case, "n100000 m15 sqexp", False, grad_rtol=2e-3)
    check_grad_y(main_case, "n100000 m15 sqexp", True, grad_rtol=2e-3)
    check_grad_y(small_case, "n1500 m7 exponential", False, grad_rtol=2e-4)
    check_grad_y(small_case, "n1500 m7 exponential", True, grad_rtol=2e-4)
    times = time_kernels(main_case)
    bounds = kernel_bounds(main_case)

    # per-site noise weights through the closed-form dist instances, and any
    # m <= 20 on the next larger built instance
    hetero_main = main_case.with_noise(noise_weights(N_MAIN))
    hetero_small = small_case.with_noise(noise_weights(1500))
    errs_hetero = hetero_parity(hetero_main, hetero_small)
    times.update(time_instances(hetero_main, 10, 100, (1, 3)))
    bounds.update(kernel_bounds(hetero_main))
    errs_m = m_between_instances(dev, main_case)
    errs_m.update({name: max(err, errs_m.get(name, 0.0))
                   for name, err in large_m_instances(dev).items()})
    errs_large, times_large, bounds_large, library = large_m_kernels(dev)
    times.update(times_large)
    bounds.update(bounds_large)

    # the coords instances of the closed-form kernels on the same sites
    coords_main = Case(N_MAIN, M_MAIN, SqExp(), CHAINS, seed=0, dev=dev, layout="coords")
    coords_small = Case(1500, 7, Exponential(), CHAINS, seed=3, dev=dev, layout="coords")
    errs = coords_parity(coords_main, coords_small)
    compare_layouts(main_case, coords_main, "n100000 m15 sqexp")
    compare_layouts(small_case, coords_small, "n1500 m7 exponential")
    layouts = {f"n{N_MAIN}_m{M_MAIN}": {
        "n": N_MAIN, "times": time_layouts(main_case, coords_main, 10, 100)}}
    times.update({name: ms for name, ms in layouts[f"n{N_MAIN}_m{M_MAIN}"]["times"]["ms"]
                  .items() if name.endswith("_coords")})
    times.update(time_plain(coords_main))
    bounds.update(kernel_bounds(coords_main))
    hetero_main = coords_main.with_noise(noise_weights(N_MAIN))
    errs_hetero.update(hetero_parity(hetero_main,
                                     coords_small.with_noise(noise_weights(1500))))
    times.update(time_instances(hetero_main, 10, 100, (1, 3)))
    bounds.update(kernel_bounds(hetero_main))
    del hetero_main, hetero_small
    for name, err in four_dimensional_parity(dev).items():
        errs[name] = max(errs[name], err)
    del main_case, coords_main, coords_small

    # the general-nu instances: config 3's data and shapes, and the small case
    check_kve(dev)
    t0 = time.perf_counter()
    field3 = config3_field(N_NU, M_NU)
    print(f"config 3 field: {time.perf_counter() - t0:.1f} s", flush=True)
    nu_case = Case(N_NU, M_NU, Matern(), CHAINS, seed=5, dev=dev, field=field3,
                   nu=nu_spread(CHAINS))
    small_nu = Case(1500, 7, Matern(), CHAINS, seed=3, dev=dev, nu=nu_spread(CHAINS))
    nu_err = check_general_nu(nu_case, f"n{N_NU} m{M_NU}")
    check_general_nu(small_nu, "n1500 m7")
    check_static_nu(nu_case, f"n{N_NU} m{M_NU}")
    check_static_nu(small_nu, "n1500 m7")
    times.update(time_kernels_nu(nu_case, plain=True))
    bounds.update(kernel_bounds_nu(nu_case))
    nu_hetero = nu_case.with_noise(noise_weights(N_NU))
    nu_hetero_err = check_general_nu(nu_hetero, f"hetero n{N_NU} m{M_NU}")
    check_general_nu(small_nu.with_noise(noise_weights(1500)), "hetero n1500 m7")
    times.update(time_instances(nu_hetero, 5, 50, (1, 1)))
    bounds.update(kernel_bounds_nu(nu_hetero))
    # and their coords instances
    nu_coords = Case(N_NU, M_NU, Matern(), CHAINS, seed=5, dev=dev, field=field3,
                     nu=nu_spread(CHAINS), layout="coords")
    small_nu_coords = Case(1500, 7, Matern(), CHAINS, seed=3, dev=dev,
                           nu=nu_spread(CHAINS), layout="coords")
    nu_coords_err = check_general_nu(nu_coords, f"coords n{N_NU} m{M_NU}")
    check_general_nu(small_nu_coords, "coords n1500 m7")
    check_static_nu(nu_coords, f"coords n{N_NU} m{M_NU}")
    check_static_nu(small_nu_coords, "coords n1500 m7")
    compare_layouts(nu_case, nu_coords, f"general nu n{N_NU} m{M_NU}")
    times.update(time_kernels_nu(nu_coords, plain=True))
    bounds.update(kernel_bounds_nu(nu_coords))
    nu_coords_hetero = nu_coords.with_noise(noise_weights(N_NU))
    nu_coords_hetero_err = check_general_nu(nu_coords_hetero,
                                            f"hetero coords n{N_NU} m{M_NU}")
    check_general_nu(small_nu_coords.with_noise(noise_weights(1500)),
                     "hetero coords n1500 m7")
    times.update(time_instances(nu_coords_hetero, 5, 50, (1, 1)))
    bounds.update(kernel_bounds_nu(nu_coords_hetero))
    del nu_hetero, nu_coords_hetero
    del nu_case, small_nu, small_case, nu_coords, small_nu_coords
    torch.cuda.empty_cache()
    # the same instances at the main path's shapes, for the table of kernels
    large_nu = Case(N_MAIN, M_MAIN, Matern(), CHAINS, seed=0, dev=dev,
                    nu=nu_spread(CHAINS))
    time_kernels_nu(large_nu, plain=False)
    kernel_bounds_nu(large_nu)
    del large_nu
    torch.cuda.empty_cache()

    phase_s = {"build_and_kernel_phases": time.perf_counter() - t_start}
    # the layout phase: both layouts' kernel times and host set-up at each
    # of LAYOUT_SIZES, and the rule they give
    for n, m in LAYOUT_SIZES:
        key = f"n{n}_m{m}"
        if key not in layouts:
            pair = [Case(n, m, SqExp(), CHAINS, seed=0, dev=dev, layout=layout)
                    for layout in ("dist", "coords")]
            big = n >= N_C5
            layouts[key] = {"n": n, "times": time_layouts(*pair, 3 if big else 10,
                                                          10 if big else 50)}
            if big:  # config 5's bounds, for the table of kernels, and the
                # m=20 coords instances at the shapes paths 11-14 launch them;
                # the M = 20 rows' bounds (16 and 4 chains) and plain times
                for case in pair:
                    for four, sfx in ((case, "_m20"), (case.subset(slice(0, 4)),
                                                        "_m20_4_chains")):
                        for name, bound in kernel_bounds(four).items():
                            row = name + sfx
                            if row in KERNEL_ROWS and (sfx == "_m20" or row in M20_FOUR):
                                bounds[row] = bound
                for name, err in config5_parity(*pair).items():
                    errs[name] = max(errs.get(name, 0.0), err)
                times.update(time_plain_m20(*pair))
            del pair
            torch.cuda.empty_cache()
        layouts[key]["setup"] = setups.result(n, m)
    layout_rule(layouts)
    phase_s["layout_phase"] = time.perf_counter() - t_start - sum(phase_s.values())
    # the M = 20 rows' times: the layout phase's at config 5's shapes
    ms_c5 = layouts[f"n{N_C5}_m{M_C5}"]["times"]["ms"]
    print(f"M = 20 on dist, kept on a lane a (site, chain) [n{N_C5} m{M_C5}, {CHAINS} chains; "
          "this run's lane body, the team of 2 as probed]: " + json.dumps(
              {name: {"lane_ms": ms_c5[name], "team_of_2_ms": team_ms}
               for name, team_ms in LANE_KEPT_M20.items()}), flush=True)
    times.update({row: ms_c5[row.removesuffix("_m20")] for row in M20_ROWS})
    times.update({"vecchia_grad_m20_4_chains": ms_c5["vecchia_grad_4_chains"],
                  "vecchia_grad_coords_m20_4_chains": ms_c5["vecchia_grad_4_chains_coords"]})

    paths = {}
    paths["response"], main_draws = main_path(dev)
    mwg_ess = paths["response"][f"min_ess_per_sec_n{N_MAIN}_m{M_MAIN}"]
    # paths 20 and 21 early in the process: late in it torch.profiler has
    # recorded no device time over a window (tools/profile_window.py)
    paths["config4_smc"] = config4_path(dev)
    torch.cuda.empty_cache()
    paths["advi"] = advi_path(dev, paths["response"]["posterior_mean"])
    torch.cuda.empty_cache()
    paths.update({
        "latent_n10000": latent_path(dev),
        "latent_n100000": latent_path_large(dev),
        "fixed_effects": fixed_effects_path(dev),
        "nuts": nuts_path(dev, mwg_ess),
        "nuts_fixed_effects": nuts_fixed_effects_path(dev),
    })
    paths["matern_nu_nuts"], model3, map3 = matern_nu_nuts_path(dev, field3)
    paths["matern_nu_mwg"] = matern_nu_mwg_path(dev, model3, map3)
    del model3
    torch.cuda.empty_cache()
    paths["matern_nu_nuts_fixed_effects"] = matern_nu_nuts_fixed_effects_path(dev, field3)
    paths["matern_nu_latent"] = matern_nu_latent_path(dev, field3,
                                                      paths["matern_nu_nuts"]["map"])
    paths["config5_probe"] = config5_probe(dev)
    paths["config5_response"] = config5_response_path(dev)
    torch.cuda.empty_cache()
    paths["config5_fixed_effects"] = config5_fixed_effects_path(dev)
    torch.cuda.empty_cache()
    paths["config5_latent"] = config5_latent_path(dev)
    torch.cuda.empty_cache()
    paths["matern_nu_coords"] = matern_nu_coords_path(dev, field3, map3)
    torch.cuda.empty_cache()
    paths["hetero"] = hetero_main_path(dev)
    paths["hetero_fixed_effects"] = hetero_fixed_effects_path(dev)
    paths["hetero_latent"] = hetero_latent_path(dev)
    paths["large_m"] = large_m_path(dev)
    # the checkpoints go under the checkout's git-ignored build directory
    os.makedirs(os.path.dirname(_build.BUILD_DIR), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(_build.BUILD_DIR)) as tmp:
        paths["resume"] = resume_path(dev, tmp)
    torch.cuda.empty_cache()
    t_new = time.perf_counter()
    phase_s["paths_1_22"] = t_new - t_start - sum(phase_s.values())
    paths["prediction"] = prediction_path(dev, main_draws)
    torch.cuda.empty_cache()
    paths["facade"] = facade_path(dev)
    torch.cuda.empty_cache()
    paths["orderings"] = orderings_path(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(_build.BUILD_DIR)) as tmp:
        paths["dotproduct"] = dotproduct_path(dev, tmp)
    print(f"paths 23-26: {time.perf_counter() - t_new:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t_new = time.perf_counter()
    paths["shard_offset"] = shard_offset_path(dev, field3)
    paths["config5_mesh"] = config5_mesh_path(dev)
    paths["processes"] = processes_path()
    print(f"paths 27-29: {time.perf_counter() - t_new:.1f} s", flush=True)

    errs.update({
        "vecchia_suffstats": fwd["f_max_abs_err"],
        "vecchia_grad": grad["max_abs_err"],
        "vecchia_bf": bf_err["b_max_abs_err"],
        "vecchia_grad_y": grad_y["b_max_abs_err"],
        "vecchia_suffstats_nu": nu_err["f_max_abs_err"],
        "vecchia_grad_nu": nu_err["sums_max_abs_err"],
        "vecchia_grad_y_nu": nu_err["b_max_abs_err"],
        "vecchia_bf_nu": nu_err["bf_b_max_abs_err"],
        "vecchia_suffstats_nu_coords": nu_coords_err["f_max_abs_err"],
        "vecchia_grad_nu_coords": nu_coords_err["sums_max_abs_err"],
        "vecchia_grad_y_nu_coords": nu_coords_err["b_max_abs_err"],
        "vecchia_bf_nu_coords": nu_coords_err["bf_b_max_abs_err"],
        **errs_hetero,
    })
    for sfx, err in (("", nu_hetero_err), ("_coords", nu_coords_hetero_err)):
        errs.update({f"vecchia_suffstats_nu{sfx}_hetero": err["f_max_abs_err"],
                     f"vecchia_grad_nu{sfx}_hetero": err["sums_max_abs_err"],
                     f"vecchia_grad_y_nu{sfx}_hetero": err["b_max_abs_err"],
                     f"vecchia_bf_nu{sfx}_hetero": err["bf_b_max_abs_err"]})
    for name, err in errs_m.items():  # m = 12, 17, 25 and 32
        errs[name] = max(errs[name], err)
    errs.update(errs_large)  # m = 40 and 64
    phase_s["paths_23_29"] = time.perf_counter() - t_start - sum(phase_s.values())
    print("phase seconds: " + json.dumps(phase_s), flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the build "
          f"{info['seconds']:.1f} s of it", flush=True)
    # launches: the sum over the paths, each counted from 0 (path 29's in its
    # two processes), launches_sharded the part of them made by calls over
    # several cells of a mesh (paths 27-29); no single
    # PyTorch call computes any of these functions (torch.special has K_0 and
    # K_1 only), so library_ms is null.  ms, plain_ms and bound_ms of the
    # closed-form rows (either layout, with or without noise weights) are at
    # n=100,000, m=15, of the general-nu rows at config 3's n=25,000, m=10,
    # 16 chains each; of the _large rows at n=10,000, m=64, 16 chains (closed
    # form) and m=40, 4 chains (general nu)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": sum(p["launches"][name] for p in paths.values()),
         "launches_by_path": {k: p["launches"][name] for k, p in paths.items()},
         "launches_sharded": sum(p["launches"].get(name + "_sharded", 0)
                                 for p in paths.values()),
         "max_abs_err": errs[name], "ms": times[name],
         "plain_ms": times[name + "_plain"], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1],
         "library_ms": library[name]["ms"] if name in library else None,
         **({"library_call": "torch.linalg.cholesky_ex on the same float64 batch, "
                             "the factor alone"} if name in library else {}),
         **team_resources(resources, name)}
        for name, (src, tpu, _) in KERNEL_ROWS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--process-worker":
        sys.exit(process_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
