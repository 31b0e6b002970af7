"""Host-side nearest-preceding-neighbor tables (numpy copy of the reference's
``pynngp_tpu.neighbors`` for the coordinate ordering and Euclidean metric).

The table is static-shape: ``(n, m)`` int32 neighbor ids plus a boolean
validity mask (site i has min(i, m) preceding neighbors, packed in the low
slots).  It is built once per dataset on the host; the tests hold it to the
reference's table bit for bit.

Exact blocked algorithm: for a block of sites [i0, i0+B), the m nearest
preceding neighbors of site i are a subset of (the m nearest within [0, i0),
from a kd-tree on those points) union (all in-block preceding sites).  Both
candidate sets are merged and the m smallest distances kept.  The native C++
kd-tree (:mod:`pynngp_tpu_torch.native`) computes the same table faster.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.spatial import cKDTree

__all__ = ["NeighborTable", "build_neighbor_table", "order_by_coordinate"]

_BLOCK_SIZE = 2048  # sites per block of the exact blocked search


class NeighborTable(NamedTuple):
    """Static-shape neighbor structure for n ordered sites, m neighbors.

    Attributes:
      order:    (n,) permutation; ordered[i] = original[order[i]].
      inverse_order: (n,) inverse permutation.
      nn_idx:   (n, m) int32 ids (into the ordered arrays) of the m nearest
                preceding neighbors of site i; masked slots hold 0.
      nn_mask:  (n, m) bool, True where the slot is a real neighbor.
    """

    order: np.ndarray
    inverse_order: np.ndarray
    nn_idx: np.ndarray
    nn_mask: np.ndarray

    @property
    def n(self) -> int:
        return self.nn_idx.shape[0]

    @property
    def m(self) -> int:
        return self.nn_idx.shape[1]


def order_by_coordinate(coords: np.ndarray, axis: int = 0) -> np.ndarray:
    """Reference-style ordering: sort sites along one coordinate."""
    return np.argsort(coords[:, axis], kind="stable")


def _pairwise_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(axis=-1)
    return np.sqrt(np.maximum(d2, 0.0))


def build_neighbor_table(
    coords: np.ndarray,
    m: int,
    ordering: str = "coordinate",
    use_native: str = "auto",
) -> NeighborTable:
    """Build the (n, m) nearest-preceding-neighbor table (Euclidean).

    Args:
      coords: (n, d) site coordinates (original order).
      m: number of neighbors (conditioning-set size); capped at n - 1.
      ordering: only 'coordinate' is ported.
      use_native: 'auto' uses the C++ kd-tree when g++ can build it (d <= 8);
        'never' forces the scipy path.
    """
    if ordering != "coordinate":
        raise NotImplementedError(
            f"ordering {ordering!r} is not ported yet (only 'coordinate')"
        )
    coords = np.asarray(coords, dtype=np.float64)
    n = coords.shape[0]
    m = int(min(m, n - 1))
    order = order_by_coordinate(coords)
    pts = coords[order]
    inverse = np.empty(n, dtype=np.int64)
    inverse[order] = np.arange(n)

    if use_native == "auto" and coords.shape[1] <= 8:
        from pynngp_tpu_torch import native

        if native.native_available():
            nn_idx, nn_mask = native.neighbor_table(pts, m)
            return NeighborTable(order, inverse, nn_idx, nn_mask)

    nn_idx = np.zeros((n, m), dtype=np.int32)
    nn_mask = np.zeros((n, m), dtype=bool)
    for i0 in range(0, n, _BLOCK_SIZE):
        i1 = min(i0 + _BLOCK_SIZE, n)
        blk = pts[i0:i1]
        # candidates from the preceding region [0, i0): m nearest via tree
        if i0 > 0:
            k = min(m, i0)
            tdist, tidx = cKDTree(pts[:i0]).query(blk, k=k, workers=-1)
            if k == 1:
                tdist = tdist[:, None]
                tidx = tidx[:, None]
        else:
            tdist = np.full((i1 - i0, 0), np.inf)
            tidx = np.zeros((i1 - i0, 0), dtype=np.int64)
        # candidates from in-block preceding sites [i0, i): all of them
        bdist = _pairwise_dist(blk, blk)
        rows = np.arange(i1 - i0)
        bdist = np.where(rows[None, :] < rows[:, None], bdist, np.inf)
        bidx = np.broadcast_to(np.arange(i0, i1)[None, :], bdist.shape)
        all_dist = np.concatenate([tdist, bdist], axis=1)
        all_idx = np.concatenate([tidx, bidx], axis=1)
        kk = min(m, all_dist.shape[1])
        if kk > 0:
            sel = np.argpartition(all_dist, kth=kk - 1, axis=1)[:, :kk]
            sel_dist = np.take_along_axis(all_dist, sel, axis=1)
            sel_idx = np.take_along_axis(all_idx, sel, axis=1)
            # sort the selection by distance for determinism
            srt = np.argsort(sel_dist, axis=1, kind="stable")
            sel_dist = np.take_along_axis(sel_dist, srt, axis=1)
            sel_idx = np.take_along_axis(sel_idx, srt, axis=1)
            valid = np.isfinite(sel_dist)
            nn_idx[i0:i1, :kk] = np.where(valid, sel_idx, 0).astype(np.int32)
            nn_mask[i0:i1, :kk] = valid
    return NeighborTable(order, inverse, nn_idx, nn_mask)
