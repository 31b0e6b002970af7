"""Host-side nearest-preceding-neighbor tables and the latent sampler's
static structure: children index, moral-graph colouring, per-colour site and
(parent, child) pair tables (numpy copy of the reference's
``pynngp_tpu.neighbors``).

The table is static-shape: ``(n, m)`` int32 neighbor ids plus a boolean
validity mask (site i has min(i, m) preceding neighbors, packed in the low
slots).  It is built once per dataset on the host; the tests hold it to the
reference's table bit for bit, for every ordering and metric.

Orderings: "coordinate" (sort by the first coordinate), "maxmin" (each site
the one farthest from all sites before it) and "none" (the users' order).
Metrics: "euclidean" and "dotproduct" (:mod:`pynngp_tpu_torch.distance`).

Exact blocked algorithm: for a block of sites [i0, i0+B), the m nearest
preceding neighbors of site i are a subset of (the m nearest within [0, i0),
from a kd-tree on those points for Euclidean, by brute force otherwise)
union (all in-block preceding sites).  Both candidate sets are merged and
the m smallest distances kept.  The native C++ kd-tree
(:mod:`pynngp_tpu_torch.native`) computes the same Euclidean table faster.

Tables can be cached on disk (``$PYNNGP_NEIGHBOR_CACHE``) under the
reference's key and file format, so a table stored by either package loads
in the other.
"""

from __future__ import annotations

import heapq
import hashlib
import os
import tempfile
import zipfile
from typing import NamedTuple, Optional

import numpy as np
from scipy.spatial import cKDTree

__all__ = ["NeighborTable", "build_neighbor_table", "order_by_coordinate",
           "order_maxmin", "ChildrenTable", "build_children_table",
           "color_moral_graph", "color_site_table", "color_child_pairs"]

# n at or below which the max-min order takes the exact O(n^2) sweep
MAXMIN_DENSE_MAX_SITES = 4096


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


def order_maxmin(coords: np.ndarray, seed: int = 0) -> np.ndarray:
    """Exact max-min ordering: each site is the one farthest (Euclidean)
    from all sites ordered before it, starting from the site nearest the
    centroid.

    Up to :data:`MAXMIN_DENSE_MAX_SITES` sites the O(n^2) farthest-point
    sweep; above it the native C++ order for d <= 3, else a lazy max-heap of
    stale upper bounds verified in batches against the selected set, which
    is held as a logarithmic forest of kd-trees.  The three paths give the
    same max-min distance profile; ties may break differently.  ``seed`` is
    unused (the algorithm is deterministic) and kept for the reference's
    signature.
    """
    coords = np.asarray(coords, dtype=np.float64)
    n = coords.shape[0]
    if n <= MAXMIN_DENSE_MAX_SITES:
        return _order_maxmin_dense(coords)
    if coords.shape[1] <= 3:
        from pynngp_tpu_torch import native

        order = native.order_maxmin(coords)
        if order is not None:
            return order
    return _order_maxmin_heap(coords)


def _order_maxmin_dense(coords: np.ndarray) -> np.ndarray:
    """O(n^2) exact farthest-point ordering (the oracle of the heap path)."""
    n = coords.shape[0]
    center = coords.mean(axis=0)
    first = int(np.argmin(((coords - center) ** 2).sum(axis=1)))
    order = np.empty(n, dtype=np.int64)
    order[0] = first
    mindist = ((coords - coords[first]) ** 2).sum(axis=1)
    mindist[first] = -np.inf
    for i in range(1, n):
        nxt = int(np.argmax(mindist))
        order[i] = nxt
        d = ((coords - coords[nxt]) ** 2).sum(axis=1)
        np.minimum(mindist, d, out=mindist)
        mindist[nxt] = -np.inf
    return order


class _SelectedSet:
    """Selected sites as a logarithmic forest of static kd-trees plus a
    linear buffer.

    Insertions append to the buffer; a full buffer becomes a kd-tree run,
    and runs of equal size merge, so at most log2(n / cap) trees exist.  A
    nearest-selected query is one cKDTree query a run plus a brute pass over
    the buffer."""

    def __init__(self, coords, buffer_cap=1024):
        self.coords = coords
        self.cap = buffer_cap
        self.buffer: list = []
        self.runs: list = []  # (size, idx_array, cKDTree)

    def add(self, i: int) -> None:
        self.buffer.append(i)
        if len(self.buffer) >= self.cap:
            idx = np.asarray(self.buffer, dtype=np.int64)
            self.buffer.clear()
            while self.runs and self.runs[-1][0] == idx.shape[0]:
                _, prev, _ = self.runs.pop()
                idx = np.concatenate([prev, idx])
            self.runs.append((idx.shape[0], idx, cKDTree(self.coords[idx])))

    def query(self, pts: np.ndarray) -> np.ndarray:
        """Distance from each row of pts to its nearest selected site."""
        best = np.full(pts.shape[0], np.inf)
        for _, _, tree in self.runs:
            # one worker: a batch is ~256 points, less than a thread's start
            np.minimum(best, tree.query(pts)[0], out=best)
        if self.buffer:
            bc = self.coords[np.asarray(self.buffer, dtype=np.int64)]
            d2 = ((pts[:, None, :] - bc[None, :, :]) ** 2).sum(axis=-1)
            np.minimum(best, np.sqrt(d2.min(axis=1)), out=best)
        return best


def _order_maxmin_heap(coords: np.ndarray, batch: int = 256) -> np.ndarray:
    """Max-min ordering by a lazy max-heap of upper bounds (any d)."""
    n = coords.shape[0]
    center = coords.mean(axis=0)
    first = int(np.argmin(((coords - center) ** 2).sum(axis=1)))
    order = np.empty(n, dtype=np.int64)
    order[0] = first
    selected = np.zeros(n, dtype=bool)
    selected[first] = True
    sel = _SelectedSet(coords)
    sel.add(first)

    # (-upper bound, site); bounds only tighten as sites are selected, so a
    # stale entry over-estimates and is verified when it is popped
    d0 = np.sqrt(((coords - coords[first]) ** 2).sum(axis=1))
    heap = [(-d0[i], i) for i in range(n) if i != first]
    heapq.heapify(heap)

    count = 1
    while count < n:
        cand = []
        while heap and len(cand) < batch:
            _, i = heapq.heappop(heap)
            if not selected[i]:
                cand.append(i)
        ci = np.asarray(cand, dtype=np.int64)
        d_true = sel.query(coords[ci])  # against every selected site
        next_ub = -heap[0][0] if heap else -np.inf
        # Greedy within the verified batch: d_true over `live` is current
        # (verified at the batch's start and corrected after every
        # selection in it) and `live` is sorted descending, so its front
        # beats every candidate of the batch; if it also beats the heap's
        # best (stale-high) bound it is a true max-min choice.
        live = list(np.argsort(-d_true))
        while live:
            pos = live.pop(0)
            i = int(ci[pos])
            d = d_true[pos]
            if d < next_ub:
                # an unverified candidate may beat it: back to the heap
                # with the tightened bound
                heapq.heappush(heap, (-d, i))
                continue
            order[count] = i
            count += 1
            selected[i] = True
            sel.add(i)
            if live:
                lv = np.asarray(live, dtype=np.int64)
                dd = np.sqrt(((coords[ci[lv]] - coords[i]) ** 2).sum(axis=-1))
                upd = dd < d_true[lv]
                if upd.any():
                    d_true[lv[upd]] = dd[upd]
                    live = lv[np.argsort(-d_true[lv])].tolist()
    return order


def _pairwise_dist(a: np.ndarray, b: np.ndarray, metric: str) -> np.ndarray:
    if metric == "euclidean":
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(axis=-1)
        return np.sqrt(np.maximum(d2, 0.0))
    if metric == "dotproduct":
        an = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
        bn = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
        return np.maximum(1.0 - an @ bn.T, 0.0)
    raise ValueError(f"unknown metric {metric!r}")


def _cache_dir() -> Optional[str]:
    """The table cache's directory, or None when caching is off
    (``PYNNGP_NEIGHBOR_CACHE`` = 0, off or no; a path names the directory;
    otherwise ``$XDG_CACHE_HOME`` or ``~/.cache``, under pynngp_tpu/neighbors,
    the reference's directory)."""
    flag = os.environ.get("PYNNGP_NEIGHBOR_CACHE", "1")
    if flag in ("0", "off", "no"):
        return None
    if flag not in ("1", "on", "yes", ""):
        return flag
    root = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(root, "pynngp_tpu", "neighbors")


def _table_cache_key(coords: np.ndarray, m: int, ordering: str, metric: str,
                     seed: int) -> str:
    """The reference's key ("v1"): a table stored by either package loads in
    the other."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(coords).tobytes())
    h.update(f"|{coords.shape}|{m}|{ordering}|{metric}|{seed}|v1".encode())
    return h.hexdigest()[:24]


def _table_cache_load(path: str) -> Optional[NeighborTable]:
    """The table stored at ``path``, or None for a file that is not one."""
    try:
        with np.load(path) as z:
            return NeighborTable(order=z["order"], inverse_order=z["inverse_order"],
                                 nn_idx=z["nn_idx"], nn_mask=z["nn_mask"])
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None


def _table_cache_store(path: str, table: NeighborTable) -> None:
    """Store ``table`` at ``path`` under a temporary name first, so that a
    reader never sees half a file.  The cache is best effort: a directory
    that cannot be written leaves the build's result as it is."""
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        os.close(fd)
        np.savez(tmp, order=table.order, inverse_order=table.inverse_order,
                 nn_idx=table.nn_idx, nn_mask=table.nn_mask)
        os.replace(tmp + ".npz", path)  # np.savez appends .npz to the name
        os.unlink(tmp)
    except OSError:
        pass


def build_neighbor_table(
    coords: np.ndarray,
    m: int,
    ordering: str = "coordinate",
    metric: str = "euclidean",
    block_size: int = 2048,
    seed: int = 0,
    use_native: str = "auto",
    cache: bool = True,
) -> NeighborTable:
    """Build the (n, m) nearest-preceding-neighbor table.

    Args:
      coords: (n, d) site coordinates (original order).
      m: number of neighbors (conditioning-set size); capped at n - 1.
      ordering: "coordinate", "maxmin" or "none".
      metric: "euclidean" (kd-tree) or "dotproduct" (blocked brute force:
        kd-trees do not apply to the cosine dissimilarity).
      block_size: sites a block of the exact blocked search.
      seed: part of the cache key (the orderings are deterministic).
      use_native: "auto" uses the C++ kd-tree when g++ can build it
        (Euclidean, d <= 8); "never" forces the numpy/scipy path.
      cache: keep the table on disk, keyed by (coordinates, m, ordering,
        metric, seed), under ``$PYNNGP_NEIGHBOR_CACHE`` (0 / off / no: no
        cache; a path: that directory; else ``~/.cache/pynngp_tpu``).
    """
    coords = np.asarray(coords, dtype=np.float64)
    cache_path = None
    if cache:
        cdir = _cache_dir()
        if cdir is not None:
            key = _table_cache_key(coords, m, ordering, metric, seed)
            cache_path = os.path.join(cdir, f"nn-{key}.npz")
            if os.path.exists(cache_path):
                hit = _table_cache_load(cache_path)
                if hit is not None and hit.nn_idx.shape == (
                        coords.shape[0], int(min(m, coords.shape[0] - 1))):
                    return hit
    table = _build_neighbor_table_impl(coords, m, ordering, metric, block_size,
                                       seed, use_native)
    if cache_path is not None:
        _table_cache_store(cache_path, table)
    return table


def _build_neighbor_table_impl(coords, m, ordering, metric, block_size, seed,
                               use_native) -> NeighborTable:
    n = coords.shape[0]
    m = int(min(m, n - 1))
    if ordering == "coordinate":
        order = order_by_coordinate(coords)
    elif ordering == "maxmin":
        order = order_maxmin(coords, seed=seed)
    elif ordering == "none":
        order = np.arange(n, dtype=np.int64)
    else:
        raise ValueError(f"unknown ordering {ordering!r}")
    pts = coords[order]
    inverse = np.empty(n, dtype=np.int64)
    inverse[order] = np.arange(n)

    if use_native == "auto" and metric == "euclidean" and coords.shape[1] <= 8:
        from pynngp_tpu_torch import native

        if native.native_available():
            nn_idx, nn_mask = native.neighbor_table(pts, m)
            return NeighborTable(order, inverse, nn_idx, nn_mask)

    nn_idx = np.zeros((n, m), dtype=np.int32)
    nn_mask = np.zeros((n, m), dtype=bool)
    use_tree = metric == "euclidean"
    for i0 in range(0, n, block_size):
        i1 = min(i0 + block_size, n)
        blk = pts[i0:i1]
        # candidates from the preceding region [0, i0): its m nearest
        if i0 > 0:
            k = min(m, i0)
            if use_tree:
                tdist, tidx = cKDTree(pts[:i0]).query(blk, k=k, workers=-1)
                if k == 1:
                    tdist = tdist[:, None]
                    tidx = tidx[:, None]
            else:
                dmat = _pairwise_dist(blk, pts[:i0], metric)
                tidx = np.argpartition(dmat, kth=k - 1, axis=1)[:, :k]
                tdist = np.take_along_axis(dmat, tidx, axis=1)
        else:
            tdist = np.full((i1 - i0, 0), np.inf)
            tidx = np.zeros((i1 - i0, 0), dtype=np.int64)
        # candidates from in-block preceding sites [i0, i): all of them
        bdist = _pairwise_dist(blk, blk, metric)
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


def color_child_pairs(colors, sites, smask, child_idx, child_mask,
                      n_shards: int = 0):
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
    Within a row the pairs are in parent-ascending order.

    With ``n_shards`` > 0 the tables follow
    ``parallel.shard_color_tables``'s round-robin partitions instead: shard
    s owns every parent at position t with t % n_shards == s, at shard-row
    position t // n_shards; returns (n_shards, n_colors, P) arrays.
    """
    n_colors = sites.shape[0]
    n, max_c = child_idx.shape
    pos = np.zeros(n, np.int64)
    for c in range(n_colors):
        row = sites[c][smask[c]]
        pos[row] = np.arange(len(row))
    ii, kk = np.nonzero(child_mask)  # every live pair, parent-ascending
    jj = child_idx[ii, kk]
    cc = colors[ii]
    if n_shards:
        ss = pos[ii] % n_shards
        ppos = pos[ii] // n_shards
        key = cc * n_shards + ss
        n_rows = n_colors * n_shards
    else:
        ppos = pos[ii]
        key = cc
        n_rows = n_colors
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=n_rows)
    p_max = max(int(counts.max()), 1)
    shape = (n_rows, p_max)
    pp = np.zeros(shape, np.int32)
    pc = np.zeros(shape, np.int32)
    pf = np.zeros(shape, np.int32)
    pm = np.zeros(shape, bool)
    off = np.concatenate([[0], np.cumsum(counts)])
    io, jo, ko, po = ii[order], jj[order], kk[order], ppos[order]
    for r in range(n_rows):
        sl = slice(off[r], off[r + 1])
        ln = int(counts[r])
        pp[r, :ln] = po[sl]
        pc[r, :ln] = jo[sl]
        pf[r, :ln] = io[sl] * max_c + ko[sl]
        pm[r, :ln] = True
    if n_shards:
        # (colour * S + shard) rows -> (shard, colour, P)
        resh = lambda a: a.reshape(n_colors, n_shards, p_max).swapaxes(0, 1)
        return resh(pp), resh(pc), resh(pf), resh(pm)
    return pp, pc, pf, pm
