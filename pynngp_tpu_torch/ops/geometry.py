"""Launch geometry of kernels 1 and 2 (``csrc/vecchia_tile.cuh``).

A block is a group of up to :data:`GROUP` chains, one warp of 32 threads a
chain, and its warps share one tile of :data:`TILE` consecutive sites at a
time: the tile's table planes, its ``nn_idx`` planes, y at the neighbors
(once for a shared y, one row a warp for a (C, n) y) and, with noise
weights, v at the neighbors are staged in shared memory, two tiles at a
time (the next one's tables load while the warps work on this one).  Blocks walk the tiles in a stride of ``grid[0]``, so each chain
gets ``grid[0]`` partial sums.  The C launcher recomputes the ring's bytes
from the same layout and refuses a launch whose bytes differ.

Everything here is plain arithmetic on the call's shapes, so the CPU tests
hold it without a card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

__all__ = ["CUDA_M", "GROUP", "MAX_M", "RING_BYTES", "SHARED_BYTES", "STAGES",
           "TILE", "TILES_PER_BLOCK", "Geometry", "cuda_instance_m", "geometry",
           "ring_planes", "rolled"]

CUDA_M = (7, 10, 15, 20)  # the unrolled instances M; a call runs the smallest M >= m
MAX_M = 32  # the rolled instance (kRolledM) takes 20 < m <= 32
MAX_DIM_UNROLLED = 3  # kMaxDim: coords with more dimensions run rolled
TILE = 32  # sites of a tile (kTile): the lanes of a warp
GROUP = 4  # chains a block at most (kMaxGroup)
STAGES = 2  # tiles in the ring (kStages)
TILES_PER_BLOCK = 4  # tiles a block walks at most
FILL_WARPS = 132 * 32  # warps a launch should hold to fill an H100's 132 SMs
SHARED_BYTES = 232_448  # shared memory one block may take on an H100
RING_BYTES = SHARED_BYTES - 2048  # kMaxRingBytes: less the warps' MaternSets


def cuda_instance_m(m: int) -> int:
    """The built instance M a call with m neighbors runs on: the smallest of
    :data:`CUDA_M` at or above m, or :data:`MAX_M` (the rolled instance,
    whose loops run to m) for 20 < m <= 32 (``launch_m`` of
    csrc/vecchia_common.cuh).  Above 32 it raises: the state of one
    (site, chain) grows as m^2 (the factor alone is m(m-1)/2 floats)."""
    for built in CUDA_M + (MAX_M,):
        if 1 <= m <= built:
            return built
    raise ValueError(f"the CUDA kernels take 1 <= m <= {MAX_M} (unrolled "
                     f"instances M in {CUDA_M}, a call runs on the smallest "
                     f"M >= m; the rolled instance above {CUDA_M[-1]}), got "
                     f"m={m}")


def rolled(m: int, layout: str, dim: int) -> bool:
    """Whether a call runs the rolled instance: m > 20, or coords with more
    than three dimensions."""
    return cuda_instance_m(m) == MAX_M or (layout == "coords" and dim > MAX_DIM_UNROLLED)


def ring_planes(m: int, layout: str = "dist", dim: int = 0, ycopies: int = 1,
                hetero: bool = False) -> int:
    """32-float planes of one stage (``tile_shape`` of csrc/vecchia_tile.cuh):
    the table planes (dist: ml distances and ml(ml-1)/2 pairs; coords: d own
    and ml d neighbor coordinates), ml nn_idx planes, ``ycopies`` x ml y
    planes and, with noise weights, ml v planes; ml is the instance's M, or
    m when the rolled instance runs."""
    ml = m if rolled(m, layout, dim) else cuda_instance_m(m)
    tables = dim + ml * dim if layout == "coords" else ml + ml * (ml - 1) // 2
    return tables + ml + ycopies * ml + (ml if hetero else 0)


class Geometry(NamedTuple):
    grid: tuple  # (blocks along the tiles, chain groups)
    block: int  # threads: 32 a chain of the group
    group: int  # chains a block
    smem_bytes: int  # the ring: STAGES x planes x 32 floats


def geometry(n_pad: int, m: int, chains: int, layout: str = "dist", dim: int = 0,
             y_shared: bool = True, hetero: bool = False, general: bool = False) -> Geometry:
    """The launch of kernel 1 or 2 for ``chains`` chains over ``n_pad``
    sites (a multiple of 128) with m neighbors: a block takes ``group`` =
    min(chains, GROUP) chains, and the last group may be ragged; up to
    TILES_PER_BLOCK tiles a block (one for the ``general``-nu instances);
    raises
    where the ring does not fit in a block's shared memory (coords with
    more than 21 dimensions at m = 32)."""
    if n_pad % TILE or n_pad <= 0:
        raise ValueError(f"n_pad={n_pad} is not a positive multiple of {TILE}")
    if not 1 <= chains <= 65535:
        raise ValueError(f"chains={chains} out of range")
    group = min(chains, GROUP)
    planes = ring_planes(m, layout, dim, 1 if y_shared else group, hetero)
    smem_bytes = STAGES * planes * TILE * 4
    if smem_bytes > RING_BYTES:
        raise ValueError(f"the tile ring of m={m} neighbors in {dim} dimensions "
                         f"needs {smem_bytes} bytes of shared memory, more than "
                         f"the {RING_BYTES} a block may take")
    tiles = n_pad // TILE
    # fewer tiles a block where the launch would hold too few warps; one for
    # the general-nu Matern, whose Bessel loops run longer for some chains'
    # nu than for others, so that a block's warps would wait at every tile
    # for its slowest chain
    per_block = 1 if general else max(1, min(TILES_PER_BLOCK, tiles * chains // FILL_WARPS))
    grid = (math.ceil(tiles / per_block), math.ceil(chains / group))
    return Geometry(grid, TILE * group, group, smem_bytes)
