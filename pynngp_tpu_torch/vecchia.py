"""Batched Vecchia B/F builder and log-likelihood in plain PyTorch — the
counterpart of ``pynngp_tpu.vecchia`` and the plain oracle of the whole port.

Per ordered site i with neighbor set N(i), |N(i)| <= m:

    B_i = C_{N(i),N(i)}^{-1} c_i          (m-vector of kriging weights)
    F_i = C_ii - c_i^T B_i                (conditional variance)
    log p(y) = sum_i log N(y_i | B_i . y_{N(i)}, F_i)

with C the unit-variance correlation plus the relative nugget alpha =
tau^2/sigma^2 on the diagonal.  Ragged first-m sites are masked: invalid
slots become identity rows/columns with zero cross-correlation, so B = 0
there.  The n factorizations run as one batched ``torch.linalg.cholesky``.
This module serves CPU tensors and the tests; on the GPU the main path runs
the hand-written kernels in :mod:`pynngp_tpu_torch.ops`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pynngp_tpu_torch.distance import Euclidean, get_distance
from pynngp_tpu_torch.neighbors import build_neighbor_table

__all__ = [
    "VecchiaData",
    "make_vecchia_data",
    "conditional_system",
    "vecchia_bf",
    "vecchia_suffstats",
    "vecchia_loglik",
    "neighbor_distances",
    "require_device",
    "LOG_2PI",
]

LOG_2PI = 1.8378770664093453


class VecchiaData(NamedTuple):
    """Static-shape Vecchia structure in ordered site space.

    ``coords``, ``nn_idx`` (int64) and ``nn_mask`` are tensors on the model's
    device.  ``nn_dist`` (n, m) and ``nn_cross_dist`` (n, m, m) are the
    hyperparameter-independent distance tables, kept as host numpy arrays:
    the site-table builder consumes them on the host.  Both are None when
    the data was made with ``precompute_distances=False``: the coords table
    layout recomputes distances and needs neither, and the dist layout
    computes them through the model's metric (``dist_fn``).
    """

    coords: torch.Tensor  # (n, d)
    nn_idx: torch.Tensor  # (n, m) int64
    nn_mask: torch.Tensor  # (n, m) bool
    nn_dist: Optional[np.ndarray] = None  # (n, m)
    nn_cross_dist: Optional[np.ndarray] = None  # (n, m, m)

    @property
    def n(self) -> int:
        return self.coords.shape[0]

    @property
    def m(self) -> int:
        return self.nn_idx.shape[1]


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``, "cuda" (the entry points' default)
    or "cpu"; "cuda" raises without a card, since nothing falls back to the
    host unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} but torch sees no CUDA "
                           "device; pass device='cpu' to run on the host")
    return device


def make_vecchia_data(
    coords,
    m: int,
    ordering: str = "coordinate",
    distance="euclidean",
    dtype=torch.float32,
    device="cuda",
    precompute_distances: bool = True,
    table=None,
):
    """Host-side setup: order sites, build the neighbor table (unless
    ``table``, a :class:`~pynngp_tpu_torch.neighbors.NeighborTable` of these
    coordinates, is given) and, with ``precompute_distances``, compute the
    distance tables in float64 numpy and keep them in ``dtype`` (without it
    no (n, m, m) array is made).  The tensors go to ``device``, the card
    unless "cpu" is asked for (any float dtype on either).

    Returns (data, table): ``data`` has coords in ordered space; use
    ``table.order`` / ``table.inverse_order`` to map user arrays.
    """
    device = require_device(device)
    coords = np.asarray(coords)
    dist_fn = get_distance(distance)
    if table is None:
        table = build_neighbor_table(coords, m, ordering=ordering,
                                     metric=dist_fn.name)
    pts_host = coords[table.order]
    pts = torch.as_tensor(pts_host, dtype=dtype, device=device)
    nn_idx = torch.as_tensor(table.nn_idx, dtype=torch.int64, device=device)
    nn_mask = torch.as_tensor(table.nn_mask, device=device)
    if not precompute_distances:
        return VecchiaData(pts, nn_idx, nn_mask), table
    nbr = pts_host[table.nn_idx]  # (n, m, d)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    d_in = dist_fn.one_to_many_np(pts_host, nbr).astype(np_dtype)
    d_nn = dist_fn.pairwise_np(nbr, nbr).astype(np_dtype)
    return VecchiaData(pts, nn_idx, nn_mask, d_in, d_nn), table


def neighbor_distances(coords, nn_idx, dist_fn=None):
    """(d_in (n, m), d_nn (n, m, m)): site-to-neighbor and neighbor-pair
    distances of ``coords`` (n, d) under ``dist_fn`` (Euclidean by default),
    on their device and in their dtype."""
    dist_fn = Euclidean() if dist_fn is None else dist_fn
    nbr = coords[nn_idx]  # (n, m, d)
    return dist_fn.one_to_many(coords, nbr), dist_fn.pairwise(nbr, nbr)


def _distances(data: VecchiaData, dist_fn=None):
    """The distance tables of ``data`` as tensors on its device: the
    precomputed ones, or those of its coordinates under ``dist_fn`` where it
    holds none (``pynngp_tpu.vecchia._distances``)."""
    dev = data.coords.device
    if data.nn_dist is not None and data.nn_cross_dist is not None:
        return (torch.as_tensor(data.nn_dist, device=dev),
                torch.as_tensor(data.nn_cross_dist, device=dev))
    return neighbor_distances(data.coords, data.nn_idx, dist_fn)


def conditional_system(kernel, phi, alpha, jitter, d_in, d_nn, mask, nu=None,
                       fused=False, alpha_nbr=None):
    """Masked neighbor correlation C_N (..., m, m) and cross-correlation
    c (..., m) of the unit-variance conditionals.

    ``phi``, ``alpha`` and, for a kernel that reads one, ``nu`` broadcast
    against ``d_in.shape[:-1]``: 0-d tensors for one parameter set, or shape
    (C, 1) against (n, m) tables for C chains (giving (C, n, m, m)).
    ``alpha_nbr``, the relative nugget of each neighbor slot under
    heterogeneous noise (alpha v at the neighbor; shaped like ``d_in``, with
    a leading chain axis where there are chains), takes alpha's place on the
    diagonal (``pynngp_tpu/vecchia.py:140-143``).
    ``fused`` takes rho as the fused kernels do (``fused_correlation``: the
    general Matern's floor of t), for their plain versions."""
    rho = kernel.fused_correlation if fused else kernel.correlation

    def kparams(*trail):  # the parameters with trailing broadcast axes
        out = {"phi": phi[(..., *trail)]}
        if nu is not None:
            out["nu"] = nu[(..., *trail)]
        return out

    dtype = d_in.dtype
    m = d_in.shape[-1]
    eye = torch.eye(m, dtype=dtype, device=d_in.device)
    mask_f = mask.to(dtype)
    mask2 = mask_f[..., :, None] * mask_f[..., None, :]
    rho_nn = rho(d_nn, kparams(None, None))
    if alpha_nbr is None:
        diag_add = (alpha + jitter)[..., None, None] * eye
    else:  # jitter broadcasts as alpha does, one axis further out
        jitter = torch.as_tensor(jitter, dtype=dtype, device=d_in.device)
        diag_add = (alpha_nbr + jitter[..., None])[..., None] * eye
    # valid slots: rho + alpha + jitter on the diagonal; masked slots:
    # identity row/column (=> B = 0 there)
    c_mat = (rho_nn + diag_add) * mask2 + eye * (1.0 - mask2 * eye)
    c_vec = rho(d_in, kparams(None)) * mask_f
    return c_mat, c_vec


def vecchia_bf(kernel, params, data: VecchiaData, alpha=0.0, jitter=1e-6,
               dist_fn=None):
    """Batched kriging weights and conditional variances.

    Args:
      kernel: correlation kernel (:mod:`pynngp_tpu_torch.kernels`).
      params: {"phi": scalar or (C,)} in natural space, and "nu" likewise
        for a kernel that samples it (``Matern()``).
      alpha: relative nugget tau^2/sigma^2 (0 for the latent process): a
        scalar, (C,) per chain, or per site (heterogeneous noise, alpha v in
        ordered site space) as (n,), or (C, n) per chain; a 1-D alpha of
        length n is read as per site.  Site i's own diagonal gets alpha[i]
        and its neighbor block's diagonal alpha[nn_idx[i]]
        (``pynngp_tpu/vecchia.py:140-143``).
      dist_fn: the metric of data made without distance tables (Euclidean
        by default); the precomputed tables take precedence.

    Returns:
      B: (n, m) weights (0 in masked slots), F: (n,) conditional variances of
      the unit-variance process; with a chain axis C in front when phi or
      alpha has one.
    """
    dev = data.coords.device
    d_in, d_nn = _distances(data, dist_fn)
    dtype = d_in.dtype
    phi = torch.as_tensor(params["phi"], dtype=dtype, device=dev)
    alpha = torch.as_tensor(alpha, dtype=dtype, device=dev)
    nu = None
    if kernel.samples_nu:
        nu = torch.as_tensor(params["nu"], dtype=dtype, device=dev)
    # a per-site alpha (n,) or (C, n) is alpha v at every neighbor slot on
    # the diagonal, (n, m) or (C, n, m), and stays per site in F
    per_site = alpha.ndim == 2 or (alpha.ndim == 1 and alpha.shape[0] == data.n)
    alpha_nbr = alpha[..., data.nn_idx] if per_site else None
    chained = {"phi": phi, "nu": nu, "alpha": None if per_site else alpha}
    chained = {k: t for k, t in chained.items() if t is not None}
    if any(t.ndim for t in chained.values()):
        # chains: (C, 1) against the (n, m) tables
        cols = torch.broadcast_tensors(*(torch.atleast_1d(t) for t in chained.values()))
        chained = {k: t.reshape(-1, 1) for k, t in zip(chained, cols)}
        phi, nu = chained["phi"], chained.get("nu")
        alpha = chained.get("alpha", alpha)
    c_mat, c_vec = conditional_system(
        kernel, phi, alpha, jitter, d_in, d_nn, data.nn_mask, nu=nu,
        alpha_nbr=alpha_nbr,
    )
    chol = torch.linalg.cholesky(c_mat)
    tmp = torch.linalg.solve_triangular(chol, c_vec[..., None], upper=False)
    b = torch.linalg.solve_triangular(chol.mT, tmp, upper=True)[..., 0]
    f = (1.0 + alpha) - (b * c_vec).sum(-1)
    return b, f


def vecchia_suffstats(b, f, y, data: VecchiaData):
    """(logdet, quad, resid): sum_i log F_i, sum_i r_i^2 / F_i, and the
    residuals r_i = y_i - B_i . y_{N(i)}.  ``b`` (..., n, m), ``f`` (..., n)
    and ``y`` (n,) or (..., n) may carry a leading chain axis.  The sums run
    over sites, accumulate in float64 and are cast back to F's dtype."""
    y_nbr = y[..., data.nn_idx] * data.nn_mask.to(y.dtype)
    resid = y - (b * y_nbr).sum(-1)
    logdet = torch.sum(torch.log(f), dim=-1, dtype=torch.float64).to(f.dtype)
    quad = torch.sum(resid * resid / f, dim=-1, dtype=torch.float64).to(f.dtype)
    return logdet, quad, resid


def vecchia_loglik(kernel, params, data: VecchiaData, y, sigma2, alpha=0.0,
                   jitter=1e-6, dist_fn=None):
    """Vecchia (NNGP) log-likelihood of y under sigma^2 (rho + alpha I)."""
    b, f = vecchia_bf(kernel, params, data, alpha=alpha, jitter=jitter,
                      dist_fn=dist_fn)
    logdet, quad, _ = vecchia_suffstats(b, f, y, data)
    n = y.shape[-1]
    sigma2 = torch.as_tensor(sigma2, dtype=f.dtype, device=f.device)
    return -0.5 * (n * (LOG_2PI + torch.log(sigma2)) + logdet + quad / sigma2)
