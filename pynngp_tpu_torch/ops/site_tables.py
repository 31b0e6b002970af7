"""Plane-major per-site tables for the CUDA Vecchia kernels — the counterpart
of ``make_lane_cache`` (``pynngp_tpu/ops/pallas_bf.py:170``) in both of its
layouts.

The TPU kernels take one site per lane over (8, 128) tiles.  On the GPU one
thread handles one (site, chain), so the tables are plane-major and
contiguous: plane p holds one scalar for every site, and adjacent threads
read adjacent addresses.  Two layouts, as ``LaneCache`` has:

- ``"dist"`` (any metric): ``tab_a`` (m, n_pad) holds the site -> neighbor-slot
  distances, ``tab_b`` (m(m-1)/2, n_pad) the neighbor-pair distances, packed
  strict lower triangle, plane ``tri_index(i, k)`` for the (i, k), i > k pair;
  from the data's precomputed tables, or else computed here under the
  model's metric (``dist_fn``) block by block, never as one (n, m, m) array;
- ``"coords"`` (Euclidean only): ``tab_a`` (d, n_pad) holds the site's own
  coordinates, ``tab_b`` (m d, n_pad) its neighbors', plane ``k d + a`` for
  coordinate a of slot k; the kernels recompute every distance.  The
  coordinates are centred in float64 and rounded to float32 whatever the
  tables' dtype, as the reference rounds them (``pallas_bf.py:238-257``).

Both layouts also hold
- ``nn_idx`` (m, n_pad) int32: neighbor ids, from which each thread gathers
  y_N itself;
- ``child_flat`` (n, max_children) int64, optional (:func:`with_children`):
  the reverse index that the y cotangent of the differentiable suffstats
  gathers through.

n is padded to the CUDA block size, times the number of site shards when
the tables are built for a mesh (``shards``), as ``make_lane_cache(shards=)``
pads its tile axis.  There is no mask plane: every
ordering packs site i's min(i, m) preceding neighbors into the low slots, so
slot k is valid iff site > k (``pallas_bf.py:357-374``).  Padded entries are
zero.  Neither layout depends on the hyperparameters, so the tables are
built once per dataset.

Shards (the counterpart of ``shard_lane_cache``, ``pallas_bf.py:1173``):
:func:`shard_site_tables` cuts tables built with ``shards=S`` into S column
blocks of ``n_pad / S`` sites, each a :class:`SiteTables` whose ``off`` is the
global index of its first site and whose ``n`` stays the global count; the
kernels mask and validate by the global index ``site + off``
(``csrc/vecchia_common.cuh``).  :class:`ShardedTables` holds one such block
per cell of a (chains, sites) mesh, on that cell's device, and
:func:`chain_groups` splits a call's chains over the mesh's chain rows.

:func:`choose_layout` is the models' rule for the layout: the reference's,
"Euclidean and more than a threshold of sites", with the threshold
:data:`COORDS_LAYOUT_MIN_SITES` measured on the H100.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pynngp_tpu_torch.distance import Euclidean
from pynngp_tpu_torch.neighbors import build_children_table
from pynngp_tpu_torch.vecchia import require_device

__all__ = ["BLOCK", "COORDS_LAYOUT_MIN_SITES", "LAYOUTS", "MAX_SITE_INDEX",
           "ShardedTables", "SiteTables", "chain_groups", "choose_layout",
           "make_site_tables", "padded_size", "shard_site_tables", "tri_index",
           "unpack_distances", "with_children"]

BLOCK = 128  # CUDA threads per block along sites (csrc/vecchia_common.cuh)
LAYOUTS = ("dist", "coords")
# n and off ride the kernels' float32 params row, exact below 2^24: every
# global site index of a launch, up to off + n_pad - 1, must stay below it
MAX_SITE_INDEX = 2**24

# "auto" takes the coords layout above this many sites, dist at or below it.
# Measured by chip_smoke.py's layout phase (layout_rule) on an NVIDIA H100
# 80GB HBM3 at 700 W, for bench_ess's default recipe (--sampler best: its MWG
# and its NUTS branch on one set-up), with kernels 1 and 2 on their tile
# design: dist runs it faster at every size measured, 10,000 to 300,000
# sites with m=15 (22.2 s against 26.8 s at 300,000) and 500,000 with m=20
# (config 5; 53.6 s against 72.5 s with kernels 1-coords and 2 on their
# M = 20 team bodies, 173.1 s against 176.5 s before them; the set-up
# 13.6 s against 1.2 s).  At m=15 coords wins the NUTS branch alone from
# 100,000 sites and loses the MWG branch alone at every size.  The
# threshold is the largest size measured.  chip_smoke.py fails if this
# constant takes another layout than the measurement at a size it measures.
COORDS_LAYOUT_MIN_SITES = 500_000


def choose_layout(lane_layout: str, n: int, euclidean: bool = True) -> str:
    """The table layout a model runs: ``"auto"`` is coords above
    :data:`COORDS_LAYOUT_MIN_SITES` sites and dist below; coords needs the
    Euclidean metric and falls back to dist without it, as the reference's
    ``_coords_layout`` condition does (``pynngp_tpu/models/response.py:135-143``).
    ``euclidean`` is False for the dot-product distance, whose tables then
    hold its dissimilarities in [0, 2] on the dist layout."""
    if lane_layout not in ("auto",) + LAYOUTS:
        raise ValueError(f"lane_layout must be 'auto', 'dist' or 'coords', got "
                         f"{lane_layout!r}")
    if lane_layout == "auto":
        lane_layout = "coords" if n > COORDS_LAYOUT_MIN_SITES else "dist"
    return lane_layout if euclidean else "dist"


class SiteTables(NamedTuple):
    tab_a: torch.Tensor  # dist: (m, n_pad) distances; coords: (d, n_pad)
    tab_b: torch.Tensor  # dist: (max(m(m-1)/2, 1), n_pad); coords: (m d, n_pad)
    nn_idx: torch.Tensor  # (m, n_pad) int32
    n: int  # true site count
    n_pad: int  # padded site count, a multiple of BLOCK
    child_flat: Optional[torch.Tensor] = None  # (n, max_children) int64
    layout: str = "dist"
    off: int = 0  # global index of the first site (a shard's tables)

    @property
    def m(self) -> int:
        return self.nn_idx.shape[0]

    @property
    def reach(self) -> int:
        """One past the last global site index the tables hold."""
        return self.off + self.n_pad

    @property
    def dim(self) -> int:
        """Coordinate dimension d (coords layout only)."""
        if self.layout != "coords":
            raise ValueError("the dist layout holds no coordinates")
        return self.tab_a.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tab_a.device

    @property
    def dtype(self) -> torch.dtype:
        return self.tab_a.dtype

    def to(self, dtype) -> "SiteTables":
        """The same tables with the floating planes cast to ``dtype``."""
        return self._replace(tab_a=self.tab_a.to(dtype), tab_b=self.tab_b.to(dtype))


def tri_index(i: int, k: int) -> int:
    """Packed-triangle plane index for the (i, k), i > k neighbor pair."""
    return i * (i - 1) // 2 + k


def padded_size(n: int, shards: int = 1) -> int:
    """n rounded up to a multiple of BLOCK * shards."""
    unit = BLOCK * shards
    return -(-n // unit) * unit


def _tri_rows_cols(m: int):
    """(i, k) slot pairs in packed-plane order."""
    iu = np.repeat(np.arange(1, m), np.arange(1, m))
    ku = np.concatenate([np.arange(i) for i in range(1, m)]) if m > 1 else \
        np.zeros(0, np.int64)
    return iu, ku


# sites a block of the dist layout's recompute: its float64 intermediates,
# at most (block, m, m, d), stay near 64 MiB
_RECOMPUTE_ELEMS = 1 << 23


def _dist_planes(pts, nn_idx, dist_fn, tab_a, tab_b):
    """Fill the dist layout's planes with the distances of ``pts`` (n, d)
    float64 under ``dist_fn``'s numpy methods, a block of sites at a time,
    each rounded once into the planes' dtype."""
    n, m = nn_idx.shape
    iu, ku = _tri_rows_cols(m)
    block = max(1, _RECOMPUTE_ELEMS // (m * m * max(pts.shape[1], 1)))
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        nbr = pts[nn_idx[lo:hi]]  # (block, m, d)
        tab_a[:, lo:hi] = dist_fn.one_to_many_np(pts[lo:hi], nbr).T
        if m > 1:
            tab_b[:, lo:hi] = dist_fn.pairwise_np(nbr, nbr)[:, iu, ku].T


def make_site_tables(data, dtype=torch.float32, device="cuda", layout="dist",
                     coords_host=None, shards: int = 1,
                     dist_fn=None) -> SiteTables:
    """Host-side relayout of a :class:`~pynngp_tpu_torch.vecchia.VecchiaData`
    into plane-major tables on ``device``, the card unless "cpu" is asked
    for.

    ``layout="dist"`` reads the data's distance tables or, where it holds
    none, computes them on the host in float64 under ``dist_fn`` (Euclidean
    when None), as ``make_lane_cache(dist_fn=)`` does, in blocks of sites.
    ``layout="coords"`` (Euclidean only) reads coordinates.  Both take
    ``coords_host``, the (n, d) float64 coordinates in ordered space, where
    the caller has them (the models do), else the data's own ``coords``,
    already in the data's dtype (a UTM-style offset of 1e6 in float32 is
    quantized to 0.06 before the centring can save it).
    ``shards``: pad the sites to a multiple of ``BLOCK * shards``, so that
    :func:`shard_site_tables` can cut them into that many site shards."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be 'dist' or 'coords', got {layout!r}")
    device = require_device(device)
    nn_idx_host = data.nn_idx.cpu().numpy()
    n, m = nn_idx_host.shape
    n_pad = padded_size(n, shards)
    nn_idx = np.zeros((m, n_pad), np.int32)
    nn_idx[:, :n] = nn_idx_host.T
    d_in, d_nn = data.nn_dist, data.nn_cross_dist
    recompute = layout == "dist" and (d_in is None or d_nn is None)
    if layout == "coords" or recompute:
        pts = np.asarray(data.coords.cpu().numpy() if coords_host is None
                         else coords_host, np.float64)
        if pts.ndim != 2 or pts.shape[0] != n or pts.shape[1] < 1:
            raise ValueError(f"coords must be (n={n}, d) with d >= 1, got "
                             f"{pts.shape}")
    if layout == "coords":
        # distances do not change under a shift, and float32 planes of
        # coordinates with a large offset would lose ~eps |x| of each distance
        pts = pts - pts.mean(axis=0, keepdims=True)
        d = pts.shape[1]
        tab_a = np.zeros((d, n_pad), np.float32)
        tab_b = np.zeros((m * d, n_pad), np.float32)
        tab_a[:, :n] = pts.T
        tab_b[:, :n] = pts[nn_idx_host].reshape(n, m * d).T
    else:
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        tab_a = np.zeros((m, n_pad), np_dtype)
        tab_b = np.zeros((max(m * (m - 1) // 2, 1), n_pad), np_dtype)
        if recompute:
            _dist_planes(pts, nn_idx_host, Euclidean() if dist_fn is None
                         else dist_fn, tab_a, tab_b)
        else:
            tab_a[:, :n] = d_in.T
            if m > 1:
                iu, ku = _tri_rows_cols(m)
                tab_b[:, :n] = d_nn[:, iu, ku].T
    return SiteTables(
        tab_a=torch.as_tensor(tab_a, device=device).to(dtype),
        tab_b=torch.as_tensor(tab_b, device=device).to(dtype),
        nn_idx=torch.as_tensor(nn_idx, device=device),
        n=n,
        n_pad=n_pad,
        layout=layout,
    )


def with_children(tables: SiteTables) -> SiteTables:
    """The tables with ``child_flat``, the reverse index of ``nn_idx``: row j
    lists, for every site i that has j as its slot-k neighbor, the flat
    position ``k * n_pad + i`` of B[k, i] in a plane-major (m * n_pad) weight
    array.  Rows are padded with 0, the position of slot 0 of site 0, which
    has no neighbors: a weight array is exactly 0 there, so a sum over a row
    needs no mask.  Built once per dataset, on the host, from ``nn_idx``
    alone, so either layout takes it."""
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


class ShardedTables(NamedTuple):
    """Site tables cut into the site shards of a (chains, sites) mesh:
    ``cells[g][s]`` is shard s on the device of mesh cell (g, s), a
    :class:`SiteTables` of ``n_pad / S`` sites at ``off = s n_pad / S``.
    Cells on one device share one copy.  ``n``, ``n_pad`` and ``child_flat``
    (the reverse index over the global plane-major layout) are the global
    tables', on the mesh's first device, where every sharded call gathers
    its results."""

    cells: tuple
    n: int
    n_pad: int
    child_flat: Optional[torch.Tensor] = None
    layout: str = "dist"

    off = 0  # the global tables start at site 0

    @property
    def reach(self) -> int:
        return self.n_pad

    @property
    def first(self) -> SiteTables:
        return self.cells[0][0]

    @property
    def m(self) -> int:
        return self.first.m

    @property
    def device(self) -> torch.device:
        return self.first.device

    @property
    def dtype(self) -> torch.dtype:
        return self.first.dtype

    @property
    def n_cells(self) -> int:
        return len(self.cells) * len(self.cells[0])


def shard_site_tables(tables: SiteTables, mesh) -> ShardedTables:
    """Cut ``tables`` (built with ``shards=mesh.shape["sites"]``) into the
    mesh's site shards, each a contiguous copy on its cells' devices.

    The blocks are cut from the global tables, never rebuilt per shard: the
    coords layout centres on the global mean, and its float32 planes would
    change with a per-shard centre.  A block of the plane-major tables is a
    strided view (the kernels take n_pad as the plane stride), hence the
    copy."""
    rows, cols = mesh.shape["chains"], mesh.shape["sites"]
    if tables.off or tables.n_pad % (BLOCK * cols):
        raise ValueError(f"n_pad={tables.n_pad} does not cut into {cols} site "
                         f"shards of whole {BLOCK}-site blocks: build the "
                         f"tables with shards={cols}")
    width = tables.n_pad // cols
    copies = {}

    def cell(s, device):
        key = (s, torch.device(device))
        if key not in copies:
            cut = lambda t: t[:, s * width:(s + 1) * width].contiguous().to(device)
            copies[key] = tables._replace(
                tab_a=cut(tables.tab_a), tab_b=cut(tables.tab_b),
                nn_idx=cut(tables.nn_idx), n_pad=width, child_flat=None,
                off=s * width)
        return copies[key]

    cells = tuple(tuple(cell(s, mesh.devices[g][s]) for s in range(cols))
                  for g in range(rows))
    child_flat = tables.child_flat
    if child_flat is not None:
        child_flat = child_flat.to(cells[0][0].device)
    return ShardedTables(cells=cells, n=tables.n, n_pad=tables.n_pad,
                         child_flat=child_flat, layout=tables.layout)


def chain_groups(chains: int, rows: int):
    """(chain row g, slice of its chains) of a call's ``chains`` split into
    ``rows`` contiguous groups, the first ``chains % rows`` one chain
    larger; rows left without a chain are left out."""
    per, extra = divmod(chains, rows)
    out, start = [], 0
    for g in range(rows):
        stop = start + per + (g < extra)
        if stop > start:
            out.append((g, slice(start, stop)))
        start = stop
    return out


def _euclidean(a, b):
    """sqrt(sum_a (x_a - x'_a)^2) over the leading coordinate axis, in the
    planes' dtype, as ``_dist_access`` forms it (``pallas_bf.py:392-404``)."""
    return torch.sqrt(((a - b) ** 2).sum(0))


def unpack_distances(tables: SiteTables):
    """(d_in (n_pad, m), d_nn (n_pad, m, m)) site-major distances of either
    layout, for the plain versions of the kernels.  The coords layout's are
    recomputed from its coordinate planes in the tables' dtype."""
    m, dev = tables.m, tables.device
    d_nn = torch.zeros((tables.n_pad, m, m), dtype=tables.dtype, device=dev)
    iu, ku = (torch.as_tensor(a, device=dev) for a in _tri_rows_cols(m))
    if tables.layout == "coords":
        d = tables.dim
        nbr = tables.tab_b.reshape(m, d, tables.n_pad)  # (m, d, n_pad)
        d_in = _euclidean(tables.tab_a[:, None], nbr.transpose(0, 1)).T
        d_tri = _euclidean(nbr[iu].transpose(0, 1), nbr[ku].transpose(0, 1))
    else:
        d_in, d_tri = tables.tab_a.T, tables.tab_b[:len(iu)]
    if m > 1:
        d_nn[:, iu, ku] = d_tri.T
        d_nn[:, ku, iu] = d_tri.T
    return d_in, d_nn
