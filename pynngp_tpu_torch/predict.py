"""Posterior prediction: neighbor-conditioned kriging for every posterior
draw (counterpart of ``pynngp_tpu.predict``, the reference's
``SeqNNGP::predict``).

For each new site, its m nearest *training* neighbors are found once on the
host, in float64; for each posterior draw s the m-by-m neighbor covariance
under theta^(s) is factored and solved, and

    y0 | y ~ N( c0' C_N^{-1} v_N,  C00 - c0' C_N^{-1} c0 )

with v = y (response model, whose C_N carries the relative nugget alpha on
its diagonal) or v = w (latent model, + tau2 on the y scale).

The reference computes this as XLA code outside any Pallas kernel; here the
draws of a batch and the new sites run as one batched factorization and two
batched triangular solves (``torch.linalg``) on the table's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy.spatial import cKDTree

from pynngp_tpu_torch.distance import get_distance
from pynngp_tpu_torch.models.base import check_device

__all__ = ["PredictionTable", "build_prediction_table", "predict_draws"]


class PredictionTable(NamedTuple):
    """Static tables of the prediction sites, tensors on one device."""

    nn_idx: torch.Tensor  # (n0, m) int64 neighbors among ORDERED training sites
    nn_dist: torch.Tensor  # (n0, m) distances new site -> neighbor
    nn_cross: torch.Tensor  # (n0, m, m) neighbor-pair distances
    coords0: torch.Tensor  # (n0, d)


def build_prediction_table(train_coords_ordered, new_coords, m: int,
                           metric="euclidean", dtype=torch.float32,
                           device="cuda") -> PredictionTable:
    """The m nearest training neighbors of each prediction site, found on
    the host in float64 (a kd-tree for Euclidean, brute force otherwise),
    and their distance tables, as tensors of ``dtype`` on ``device``."""
    device = check_device(device, dtype)
    pts = np.asarray(train_coords_ordered, np.float64)
    new = np.asarray(new_coords, np.float64)
    m = int(min(m, len(pts)))
    metric = getattr(metric, "name", metric)  # a distance instance too
    dist_fn = get_distance(metric)
    if metric == "euclidean":
        dist, idx = cKDTree(pts).query(new, k=m, workers=-1)
        if m == 1:
            dist, idx = dist[:, None], idx[:, None]
    else:
        dmat = dist_fn.pairwise_np(new, pts)
        idx = np.argpartition(dmat, kth=m - 1, axis=1)[:, :m]
        dist = np.take_along_axis(dmat, idx, axis=1)
        srt = np.argsort(dist, axis=1, kind="stable")
        dist = np.take_along_axis(dist, srt, axis=1)
        idx = np.take_along_axis(idx, srt, axis=1)
    nbr = pts[idx]  # (n0, m, d)
    cross = dist_fn.pairwise_np(nbr, nbr)
    as_dev = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return PredictionTable(
        nn_idx=as_dev(idx.astype(np.int64), torch.int64),
        nn_dist=as_dev(dist, dtype),
        nn_cross=as_dev(cross, dtype),
        coords0=as_dev(new, dtype),
    )


def predict_draws(
    kernel,
    table: PredictionTable,
    values,
    draws: dict,
    generator: torch.Generator = None,
    x0=None,
    beta_draws=None,
    x_train=None,
    values_draws=None,
    noise_on_target: bool = True,
    jitter: float = 1e-6,
    batch_draws: int = 8,
):
    """Kriging for every posterior draw, on the table's device.

    Args:
      kernel: correlation kernel (:mod:`pynngp_tpu_torch.kernels`).
      table: the :class:`PredictionTable` of the new sites.
      values: (n,) ordered training vector conditioned on (response: y).
        Ignored when ``values_draws`` is given.
      draws: 1-D arrays 'sigma2', 'tau2', 'phi' (and 'nu' for a kernel that
        samples it) of length S (chains flattened first).
      generator: with one, 'samples' holds one predictive draw per
        (draw, site), from normals drawn on the generator's device.
      x0 / beta_draws: (n0, p) covariates at the new sites and (S, p)
        fixed-effect draws; with both, the mean gains x0 @ beta^(s).
      x_train: (n, p) ordered training covariates: with ``beta_draws`` on
        the response model the conditioning is on the per-draw residuals
        values - x_train @ beta^(s).  The latent model must not pass it.
      values_draws: (S, n) per-draw ordered field values (latent model: w).
      noise_on_target: add tau2 to the predictive variance (predict y0
        rather than the latent surface).
      jitter: added to C_N's diagonal, and the floor of the conditional
        variance.
      batch_draws: draws computed together, vectorised with the sites.

    Returns a dict of (S, n0) tensors on the table's device: 'mean', 'var'
    and, with a generator, 'samples'.
    """
    device, dtype = table.nn_dist.device, table.nn_dist.dtype
    tensor = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    sigma2, tau2, phi = (tensor(draws[k]) for k in ("sigma2", "tau2", "phi"))
    nu = tensor(draws["nu"]) if "nu" in draws else None
    s_total = sigma2.shape[0]
    m = table.nn_idx.shape[1]
    eye = torch.eye(m, dtype=dtype, device=device)

    latent = values_draws is not None
    fixed_effects = x0 is not None and beta_draws is not None
    if x_train is not None:
        if latent:
            raise ValueError("latent model conditions on w; do not pass x_train")
        if beta_draws is None:
            raise ValueError("x_train requires beta_draws")
        x_train = tensor(x_train)
    if fixed_effects:
        x0 = tensor(x0)
    if beta_draws is not None:
        beta_draws = tensor(beta_draws)
    vals = tensor(values_draws) if latent else tensor(values)

    bs = max(1, min(int(batch_draws), s_total))
    means, variances, samples = [], [], []
    for s0 in range(0, s_total, bs):
        sl = slice(s0, min(s0 + bs, s_total))
        s2, t2 = sigma2[sl], tau2[sl]
        # parameters with trailing axes against (n0, m) and (n0, m, m)
        params = lambda *trail: {k: v[sl][(..., *trail)]
                                 for k, v in (("phi", phi), ("nu", nu)) if v is not None}
        # the response model conditions on y, whose covariance carries the
        # relative nugget alpha on the diagonal; the latent one on w
        a_diag = torch.zeros_like(s2) if latent else t2 / s2
        c_nn = (kernel.correlation(table.nn_cross, params(None, None, None))
                + (a_diag + jitter)[:, None, None, None] * eye)
        c_0n = kernel.correlation(table.nn_dist, params(None, None))  # (B, n0, m)
        chol, info = torch.linalg.cholesky_ex(c_nn)
        # a failed factor gives NaN, as the reference's does, not an error
        chol = torch.where((info == 0)[..., None, None], chol, torch.nan)
        tmp = torch.linalg.solve_triangular(chol, c_0n[..., None], upper=False)
        sol = torch.linalg.solve_triangular(chol.mT, tmp, upper=True)[..., 0]
        if latent:
            v = vals[sl]  # (B, n)
        elif x_train is not None:
            v = vals - beta_draws[sl] @ x_train.T  # y - X beta ~ NNGP
        else:
            v = vals
        v_n = v[..., table.nn_idx]  # (n0, m) or (B, n0, m)
        mean = (sol * v_n).sum(-1)
        if fixed_effects:
            mean = mean + beta_draws[sl] @ x0.T
        cond = 1.0 - (sol * c_0n).sum(-1)
        var = s2[:, None] * torch.clamp(cond, min=jitter)
        if noise_on_target:
            var = var + t2[:, None]  # y0 (signal + nugget) rather than w0
        means.append(mean)
        variances.append(var)
        if generator is not None:
            z = torch.randn(mean.shape, generator=generator, dtype=dtype,
                            device=generator.device).to(device)
            samples.append(mean + torch.sqrt(var) * z)
    out = {"mean": torch.cat(means), "var": torch.cat(variances)}
    if generator is not None:
        out["samples"] = torch.cat(samples)
    return out
