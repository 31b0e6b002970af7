"""Plane-major per-site tables for the CUDA Vecchia kernels — the counterpart
of the dist layout of ``make_lane_cache`` (``pynngp_tpu/ops/pallas_bf.py:170``).

The TPU kernels take one site per lane over (8, 128) tiles.  On the GPU one
thread handles one (site, chain), so the tables are plane-major and
contiguous: plane p holds one scalar for every site, and adjacent threads
read adjacent addresses.

- ``d_in``  (m, n_pad): site -> neighbor-slot distances;
- ``d_tri`` (m(m-1)/2, n_pad): neighbor-pair distances, packed strict lower
  triangle, plane ``tri_index(i, k)`` for the (i, k), i > k pair;
- ``nn_idx`` (m, n_pad) int32: neighbor ids, from which each thread gathers
  y_N itself.

- ``child_flat`` (n, max_children) int64, optional (:func:`with_children`):
  the reverse index that the y cotangent of the differentiable suffstats
  gathers through.

n is padded only to the CUDA block size.  There is no mask plane: every
ordering packs site i's min(i, m) preceding neighbors into the low slots, so
slot k is valid iff site > k (``pallas_bf.py:357-374``).  Padded entries are
zero.  Distances never depend on the hyperparameters, so the tables are
built once per dataset.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pynngp_tpu_torch.neighbors import build_children_table

__all__ = ["BLOCK", "SiteTables", "make_site_tables", "padded_size",
           "tri_index", "unpack_distances", "with_children"]

BLOCK = 128  # CUDA threads per block along sites (csrc/vecchia_common.cuh)


class SiteTables(NamedTuple):
    d_in: torch.Tensor  # (m, n_pad)
    d_tri: torch.Tensor  # (max(m(m-1)/2, 1), n_pad)
    nn_idx: torch.Tensor  # (m, n_pad) int32
    n: int  # true site count
    n_pad: int  # padded site count, a multiple of BLOCK
    child_flat: Optional[torch.Tensor] = None  # (n, max_children) int64

    @property
    def m(self) -> int:
        return self.nn_idx.shape[0]


def tri_index(i: int, k: int) -> int:
    """Packed-triangle plane index for the (i, k), i > k neighbor pair."""
    return i * (i - 1) // 2 + k


def padded_size(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def _tri_rows_cols(m: int):
    """(i, k) slot pairs in packed-plane order."""
    iu = np.repeat(np.arange(1, m), np.arange(1, m))
    ku = np.concatenate([np.arange(i) for i in range(1, m)]) if m > 1 else \
        np.zeros(0, np.int64)
    return iu, ku


def make_site_tables(data, dtype=torch.float32, device="cpu") -> SiteTables:
    """Host-side relayout of a :class:`~pynngp_tpu_torch.vecchia.VecchiaData`
    (its neighbor ids and distance tables) into plane-major tables."""
    nn_idx_host = data.nn_idx.cpu().numpy()
    n, m = nn_idx_host.shape
    n_pad = padded_size(n)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    p = max(m * (m - 1) // 2, 1)
    nn_idx = np.zeros((m, n_pad), np.int32)
    nn_idx[:, :n] = nn_idx_host.T
    d_in = np.zeros((m, n_pad), np_dtype)
    d_in[:, :n] = np.asarray(data.nn_dist).T
    d_tri = np.zeros((p, n_pad), np_dtype)
    if m > 1:
        iu, ku = _tri_rows_cols(m)
        d_tri[:, :n] = np.asarray(data.nn_cross_dist)[:, iu, ku].T
    return SiteTables(
        d_in=torch.as_tensor(d_in, device=device),
        d_tri=torch.as_tensor(d_tri, device=device),
        nn_idx=torch.as_tensor(nn_idx, device=device),
        n=n,
        n_pad=n_pad,
    )


def with_children(tables: SiteTables) -> SiteTables:
    """The tables with ``child_flat``, the reverse index of ``nn_idx``: row j
    lists, for every site i that has j as its slot-k neighbor, the flat
    position ``k * n_pad + i`` of B[k, i] in a plane-major (m * n_pad) weight
    array.  Rows are padded with 0, the position of slot 0 of site 0, which
    has no neighbors: a weight array is exactly 0 there, so a sum over a row
    needs no mask.  Built once per dataset, on the host."""
    if tables.child_flat is not None:
        return tables
    n, m = tables.n, tables.m
    nn_idx = tables.nn_idx[:, :n].T.cpu().numpy()
    nn_mask = np.arange(n)[:, None] > np.arange(m)[None, :]
    ch = build_children_table(np.ascontiguousarray(nn_idx), nn_mask)
    flat = np.where(ch.child_mask, ch.child_slot.astype(np.int64) * tables.n_pad
                    + ch.child_idx, 0)
    return tables._replace(
        child_flat=torch.as_tensor(flat, device=tables.nn_idx.device))


def unpack_distances(tables: SiteTables):
    """(d_in (n_pad, m), d_nn (n_pad, m, m)) site-major views of the tables,
    for the plain versions of the kernels."""
    m = tables.m
    d_in = tables.d_in.T
    d_nn = torch.zeros((tables.n_pad, m, m), dtype=d_in.dtype,
                       device=d_in.device)
    if m > 1:
        iu, ku = (torch.as_tensor(a, device=d_in.device)
                  for a in _tri_rows_cols(m))
        d_nn[:, iu, ku] = tables.d_tri.T
        d_nn[:, ku, iu] = tables.d_tri.T
    return d_in, d_nn
