"""Host-side nearest-preceding-neighbor tables and the latent sampler's
static structure: children index, moral-graph colouring, per-colour site and
(parent, child) pair tables (numpy copy of the reference's
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

__all__ = ["NeighborTable", "build_neighbor_table", "order_by_coordinate",
           "ChildrenTable", "build_children_table", "color_moral_graph",
           "color_site_table", "color_child_pairs"]

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


class ChildrenTable(NamedTuple):
    """Reverse index of the neighbor table, padded to static shape: for the
    Gibbs update of latent w_i, every j with i in N(j) and the slot of i
    within N(j)."""

    child_idx: np.ndarray  # (n, max_c) int32, the child sites j
    child_slot: np.ndarray  # (n, max_c) int32, position of i in N(j)
    child_mask: np.ndarray  # (n, max_c) bool

    @property
    def max_children(self) -> int:
        return self.child_idx.shape[1]


def build_children_table(nn_idx: np.ndarray, nn_mask: np.ndarray,
                         use_native: str = "auto") -> ChildrenTable:
    if use_native == "auto":
        from pynngp_tpu_torch import native

        if native.native_available():
            return ChildrenTable(*native.children_table(nn_idx, nn_mask))
    n = nn_idx.shape[0]
    counts = np.zeros(n, dtype=np.int64)
    js, slots = np.nonzero(nn_mask)
    parents = nn_idx[js, slots]
    np.add.at(counts, parents, 1)
    max_c = max(int(counts.max()) if n else 0, 1)
    child_idx = np.zeros((n, max_c), dtype=np.int32)
    child_slot = np.zeros((n, max_c), dtype=np.int32)
    child_mask = np.zeros((n, max_c), dtype=bool)
    fill = np.zeros(n, dtype=np.int64)
    for j, s, p in zip(js, slots, parents):
        k = fill[p]
        child_idx[p, k] = j
        child_slot[p, k] = s
        child_mask[p, k] = True
        fill[p] = k + 1
    return ChildrenTable(child_idx, child_slot, child_mask)


def color_moral_graph(nn_idx: np.ndarray, nn_mask: np.ndarray,
                      balanced: bool = True,
                      use_native: str = "auto") -> np.ndarray:
    """Greedy colouring of the moral graph of the Vecchia DAG.

    Two sites may be Gibbs-updated at once iff they are non-adjacent in the
    moral graph (i ~ j if one conditions on the other, or both are parents of
    a common child).  With ``balanced=True`` each vertex takes the
    least-loaded legal colour, so the colour classes have near-equal size and
    the padded per-colour tables waste little.  Returns (n,) int32.
    """
    if balanced and use_native == "auto":
        from pynngp_tpu_torch import native

        if native.native_available():
            ch = build_children_table(nn_idx, nn_mask)
            return native.color_moral(nn_idx, nn_mask, ch.child_idx,
                                      ch.child_slot, ch.child_mask)
    n = nn_idx.shape[0]
    adj = [set() for _ in range(n)]
    for j in range(n):
        parents = nn_idx[j][nn_mask[j]]
        for p in parents:
            adj[j].add(int(p))
            adj[int(p)].add(j)
        # moralization: parents of a common child are adjacent
        for a_i in range(len(parents)):
            for b_i in range(a_i + 1, len(parents)):
                a, b = int(parents[a_i]), int(parents[b_i])
                adj[a].add(b)
                adj[b].add(a)
    colors = np.full(n, -1, dtype=np.int32)
    counts: list = []
    # colour in degree-descending order for fewer colours
    order = np.argsort([-len(a) for a in adj], kind="stable")
    for v in order:
        used = {colors[u] for u in adj[v] if colors[u] >= 0}
        if balanced:
            legal = [c for c in range(len(counts)) if c not in used]
            if legal:
                c = min(legal, key=lambda cc: counts[cc])
            else:
                c = len(counts)
                counts.append(0)
        else:
            c = 0
            while c in used:
                c += 1
            while c >= len(counts):
                counts.append(0)
        colors[v] = c
        counts[c] += 1
    return colors


def color_site_table(colors: np.ndarray):
    """Pad the colour classes to a static (n_colors, max_size) site table and
    mask (pad slots point at site 0 with mask False)."""
    n_colors = int(colors.max()) + 1
    groups = [np.nonzero(colors == c)[0] for c in range(n_colors)]
    max_sz = max(len(g) for g in groups)
    sites = np.zeros((n_colors, max_sz), dtype=np.int32)
    mask = np.zeros((n_colors, max_sz), dtype=bool)
    for c, g in enumerate(groups):
        sites[c, : len(g)] = g
        mask[c, : len(g)] = True
    return sites, mask


def color_child_pairs(colors, sites, smask, child_idx, child_mask):
    """Packed (parent, child) pair tables per colour for the chromatic sweep.

    The per-site child table pads every row to the global max child count
    (several times the mean, m), so each colour's live pairs are packed into
    one flat padded row instead.  Per colour c the tables hold, for every
    (parent i in colour c, child j) pair,
      pp: the parent's position within the colour-c site row,
      pc: the child site id j (global),
      pf: the flat index i * max_c + slot into the (n, max_c) per-step child
          value tables,
      pm: validity (pads carry False, and 0 in the other three).
    Row length = max over colours of the live-pair count (~ class size * m).
    Within a row the pairs are in parent-ascending order.  The site-sharded
    variant of the reference (``n_shards`` > 0) is not ported.
    """
    n_colors = sites.shape[0]
    n, max_c = child_idx.shape
    pos = np.zeros(n, np.int64)
    for c in range(n_colors):
        row = sites[c][smask[c]]
        pos[row] = np.arange(len(row))
    ii, kk = np.nonzero(child_mask)  # every live pair, parent-ascending
    jj = child_idx[ii, kk]
    key = colors[ii]
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=n_colors)
    p_max = max(int(counts.max()), 1)
    shape = (n_colors, p_max)
    pp = np.zeros(shape, np.int32)
    pc = np.zeros(shape, np.int32)
    pf = np.zeros(shape, np.int32)
    pm = np.zeros(shape, bool)
    off = np.concatenate([[0], np.cumsum(counts)])
    io, jo, ko, po = ii[order], jj[order], kk[order], pos[ii][order]
    for r in range(n_colors):
        sl = slice(off[r], off[r + 1])
        ln = int(counts[r])
        pp[r, :ln] = po[sl]
        pc[r, :ln] = jo[sl]
        pf[r, :ln] = io[sl] * max_c + ko[sl]
        pm[r, :ln] = True
    return pp, pc, pf, pm
