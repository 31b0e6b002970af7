"""Launch geometry of the three kernels (``csrc/vecchia_tile.cuh``,
``csrc/vecchia_large_smem.cuh``, ``csrc/vecchia_grad_smem.cuh``,
``csrc/vecchia_large_cluster.cuh``, ``csrc/vecchia_grad_cluster.cuh``,
``csrc/vecchia_large_m.cuh``).

For m <= 32 a block is a group of up to :data:`GROUP` chains, one warp of
32 threads a chain, and its warps share one tile of :data:`TILE` consecutive
sites at a time: the tile's table planes, its ``nn_idx`` planes, y at the
neighbors (once for a shared y, one row a warp for a (C, n) y; none for
kernel 3) and, with noise weights, v at the neighbors are staged in shared
memory, two tiles at a time (the next one's tables load while the warps
work on this one).  Blocks walk the tiles in a stride of ``grid[0]``, so
each chain of kernels 1 and 2 gets ``grid[0]`` partial sums.  The C launcher
recomputes the ring's bytes from the same layout and refuses a launch whose
bytes differ.

For m > 32 the ring does not fit (one stage at m = 64 on the dist layout is
283 KB).  Each kernel then runs one warp a (site, chain) system, its factor
in shared memory (:func:`smem_geometry`), up to the largest m whose one
system fits a block: :data:`M_SMEM` for kernels 1 and 3, :data:`M_SMEM_GRAD`
for kernel 2, whose system keeps two more vectors.  Above that limit each
kernel runs the cluster body up to :data:`CLUSTER_M` (:data:`M_CLUSTER` for
kernels 1 and 3, :data:`M_CLUSTER_GRAD` for kernel 2): a thread-block
cluster a (site, chain) system, its columns spread over the shared memory
of the cluster's blocks (:func:`cluster_geometry`).  Above it a kernel runs
the scratch body, one thread a (site, chain) with its state in a device
scratch buffer (:func:`large_geometry`).  :func:`large_body` names which body a launch
runs.

At M = 20 (15 < m <= 20) the closed-form instances of every kernel on
coords, and of kernel 2 on dist, run a team body on the same ring and grid
(csrc/vecchia_team.cuh): a team of a few lanes a (site, chain) system, a
warp factoring several sites of its chain at a time (:func:`team_body`; the
lanes a system are the kernels' own, ``team_lanes`` of that header).

Everything here is plain arithmetic on the call's shapes, so the CPU tests
hold it without a card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

__all__ = ["CLUSTER_M", "CLUSTER_PANEL", "CLUSTER_THREADS", "CUDA_M", "GROUP",
           "LARGE_BLOCKS", "LARGE_SCRATCH_BYTES", "MAX_M", "M_CLUSTER", "M_CLUSTER_GRAD", "M_SMEM",
           "M_SMEM_GRAD", "RING_BYTES", "SHARED_BYTES", "SMEM_M", "STAGES",
           "TEAM_M", "TILE", "TILES_PER_BLOCK", "Geometry", "LargeGeometry", "check_card_m",
           "cluster_block_bytes", "cluster_blocks", "cluster_geometry", "cluster_owner",
           "cluster_slot_bytes", "cluster_stage_words",
           "cuda_instance_m", "geometry", "large", "large_body", "large_geometry",
           "large_state_doubles", "ring_planes", "rolled",
           "smem_geometry", "smem_grad_system_bytes", "smem_system_bytes", "system_bytes",
           "team_body"]

CUDA_M = (7, 10, 15, 20)  # the unrolled instances M; a call runs the smallest M >= m
MAX_M = 32  # the rolled instance (kRolledM) takes 20 < m <= 32; above, the large-m one
MAX_DIM_UNROLLED = 3  # kMaxDim: coords with more dimensions run rolled
TILE = 32  # sites of a tile (kTile): the lanes of a warp
GROUP = 4  # chains a block at most (kMaxGroup)
STAGES = 2  # tiles in the ring (kStages)
TILES_PER_BLOCK = 4  # tiles a block walks at most
FILL_WARPS = 132 * 32  # warps a launch should hold to fill an H100's 132 SMs
SHARED_BYTES = 232_448  # shared memory one block may take on an H100
RING_BYTES = SHARED_BYTES - 2048  # kMaxRingBytes: less the warps' MaternSets
LARGE_BLOCK = 128  # threads (sites of one chain) a block of the large-m instances
LARGE_BLOCKS = 132 * 8  # blocks a large-m launch keeps: 32 warps on each of 132 SMs
# the most scratch a large-m launch may take: the (site, chain) state of its
# threads, large_state_doubles(m) float64 words each
LARGE_SCRATCH_BYTES = 4 << 30
PANEL = 4  # kPanel: a system's slots are m rounded up to a multiple of it
SMS = 132  # an H100's SMs
TEAM_M = 20  # the built instance M whose closed-form instances run the team bodies
SM_SHARED_BYTES = 233_472  # shared memory of one SM
SM_BLOCK_RESERVE = 2048  # bytes a block takes beside its systems: 1,024 the card's, MaternSets
CLUSTER_PANEL = 8  # kClusterPanel: columns a panel of the cluster body
CLUSTER_THREADS = 256  # kClusterThreads: threads a block of the cluster body
CLUSTER_SIZES = (2, 4, 8)  # the portable cluster sizes, smallest first
CLUSTER_SYSTEMS = 8192  # clusters a cluster-body launch keeps at most (before rounding)
CLUSTER_SLOT_SMS = 256  # kClusterSlotSms: SMs the cluster body's hand-off buffer serves


def cuda_instance_m(m: int) -> int:
    """The built instance M a call with m neighbors runs on: the smallest of
    :data:`CUDA_M` at or above m, :data:`MAX_M` (the rolled instance, whose
    loops run to m) for 20 < m <= 32, and m itself above 32 (the large-m
    instance, its state sized by m at run time; ``launch_m`` of
    csrc/vecchia_common.cuh).  Below 1 it raises."""
    if m < 1:
        raise ValueError(f"the CUDA kernels take m >= 1 neighbors, got m={m}")
    for built in CUDA_M + (MAX_M,):
        if m <= built:
            return built
    return m


def large(m: int) -> bool:
    """Whether a call with m neighbors runs the large-m instance."""
    return m > MAX_M


def rolled(m: int, layout: str, dim: int) -> bool:
    """Whether a tile call runs the rolled instance: 20 < m <= 32, or coords
    with more than three dimensions."""
    return cuda_instance_m(m) == MAX_M or (layout == "coords" and dim > MAX_DIM_UNROLLED)


def team_body(base: str, m: int, layout: str = "dist", dim: int = 0,
              general: bool = False) -> bool:
    """Whether a tile launch of kernel ``base`` (``vecchia_suffstats``,
    ``vecchia_grad`` or ``vecchia_bf``) runs a team body
    (csrc/vecchia_team.cuh, ``team_launch``): closed-form rho on the
    unrolled M = 20 instance (15 < m <= 20, and d <= 3 on coords), every
    kernel on coords and kernel 2 on dist.  Kernels 1 and 3 on dist keep a
    lane a (site, chain), which the card measured faster than their teams
    (PERF.md), as does every other tile launch.  A rule of shape, the C
    launchers' too."""
    return (not general and cuda_instance_m(m) == TEAM_M and not rolled(m, layout, dim)
            and (layout == "coords" or base == "vecchia_grad"))


def ring_planes(m: int, layout: str = "dist", dim: int = 0, ycopies: int = 1,
                hetero: bool = False) -> int:
    """32-float planes of one stage (``tile_shape`` of csrc/vecchia_tile.cuh):
    the table planes (dist: ml distances and ml(ml-1)/2 pairs; coords: d own
    and ml d neighbor coordinates), ml nn_idx planes where anything is
    gathered through them (y or v), ``ycopies`` x ml y planes (0 for kernel
    3) and, with noise weights, ml v planes; ml is the instance's M, or m
    when the rolled instance runs."""
    ml = m if rolled(m, layout, dim) else cuda_instance_m(m)
    tables = dim + ml * dim if layout == "coords" else ml + ml * (ml - 1) // 2
    gathers = ycopies > 0 or hetero
    return tables + (ml if gathers else 0) + ycopies * ml + (ml if hetero else 0)


class Geometry(NamedTuple):
    grid: tuple  # (blocks along the tiles, chain groups)
    block: int  # threads: 32 a chain of the group
    group: int  # chains a block
    smem_bytes: int  # the ring: STAGES x planes x 32 floats


def geometry(n_pad: int, m: int, chains: int, layout: str = "dist", dim: int = 0,
             y_shared: bool = True, hetero: bool = False, general: bool = False,
             with_y: bool = True) -> Geometry:
    """The tile launch of kernel 1 or 2, or of kernel 3 (``with_y=False``:
    no y planes), for ``chains`` chains over ``n_pad`` sites (a multiple of
    128) with m <= 32 neighbors: a block takes ``group`` = min(chains,
    GROUP) chains, and the last group may be ragged; up to TILES_PER_BLOCK
    tiles a block (one for the ``general``-nu instances); raises where the
    ring does not fit in a block's shared memory (coords with more than 21
    dimensions at m = 32) and for m > 32 (:func:`large_geometry`)."""
    if n_pad % TILE or n_pad <= 0:
        raise ValueError(f"n_pad={n_pad} is not a positive multiple of {TILE}")
    if not 1 <= chains <= 65535:
        raise ValueError(f"chains={chains} out of range")
    if large(m):
        raise ValueError(f"the tile ring takes m <= {MAX_M}; m={m} runs the large-m "
                         f"instance (large_geometry)")
    group = min(chains, GROUP)
    ycopies = (1 if y_shared else group) if with_y else 0
    planes = ring_planes(m, layout, dim, ycopies, hetero)
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


def large_state_doubles(m: int) -> int:
    """float64 words of one (site, chain)'s state in the large-m instances'
    scratch buffer (``LargeState`` of csrc/vecchia_large_m.cuh): the strict
    lower triangle of L and six vectors of m."""
    return m * (m - 1) // 2 + 6 * m


class LargeGeometry(NamedTuple):
    grid: tuple  # (blocks of LARGE_BLOCK sites along the sites, chains)
    block: int  # threads: LARGE_BLOCK sites of one chain
    scratch_bytes: int  # large_state_doubles(m) float64 words for each thread


def large_geometry(n_pad: int, m: int, chains: int) -> LargeGeometry:
    """The launch of a large-m instance (m > 32) for ``chains`` chains over
    ``n_pad`` sites (a multiple of 128): one chain a block, blocks of
    LARGE_BLOCK sites walking the sites in a stride of ``grid[0]``, as many
    as LARGE_BLOCKS blocks in all allow and the scratch buffer's
    LARGE_SCRATCH_BYTES.  Raises where one block a chain already needs more
    scratch than that."""
    if n_pad % LARGE_BLOCK or n_pad <= 0:
        raise ValueError(f"n_pad={n_pad} is not a positive multiple of {LARGE_BLOCK}")
    if not 1 <= chains <= 65535:
        raise ValueError(f"chains={chains} out of range")
    if not large(m):
        raise ValueError(f"m={m} runs the tile ring (geometry), not the large-m instance")
    per_block = LARGE_BLOCK * large_state_doubles(m) * 8  # bytes of one block's state
    fit = LARGE_SCRATCH_BYTES // (per_block * chains)
    if fit < 1:
        raise ValueError(f"m={m} neighbors for {chains} chains need "
                         f"{per_block * chains} bytes of scratch for one block a "
                         f"chain, more than the LARGE_SCRATCH_BYTES = "
                         f"{LARGE_SCRATCH_BYTES} a launch may take")
    grid_x = max(1, min(n_pad // LARGE_BLOCK, math.ceil(LARGE_BLOCKS / chains), fit))
    return LargeGeometry((grid_x, chains), LARGE_BLOCK, grid_x * chains * per_block)


def smem_system_bytes(m: int) -> int:
    """Bytes of one (site, chain) system in the shared-memory body
    (``smem_system_doubles`` of csrc/vecchia_large_smem.cuh): mp = m rounded
    up to PANEL columns of a lower triangle of mp + 2 rows (the border rows
    c and y_N), column k holding rows k.. and rounded up to an odd count of
    float64 words."""
    mp = -(-m // PANEL) * PANEL
    rows = mp + 2
    return 8 * (mp * rows - mp * (mp - 1) // 2 + (mp + 1) // 2)


def smem_grad_system_bytes(m: int) -> int:
    """Bytes of one (site, chain) system of kernel 2's shared-memory body
    (``smem_grad_doubles`` of csrc/vecchia_grad_smem.cuh): kernel 1's
    system and, beside it, two vectors of mp float64 words (d c / d phi and
    d c / d nu, then p and q)."""
    return smem_system_bytes(m) + 16 * (-(-m // PANEL) * PANEL)


def _max_smem_m(system) -> int:
    m = MAX_M
    while system(m + 1) <= RING_BYTES:
        m += 1
    return m


# the largest m whose one system fits a block's shared memory: kernels 1
# and 3 (kSmemM) and kernel 2 (kSmemGradM)
M_SMEM = _max_smem_m(smem_system_bytes)
M_SMEM_GRAD = _max_smem_m(smem_grad_system_bytes)
# each kernel's (base name's) largest m on the shared-memory body
SMEM_M = {"vecchia_suffstats": M_SMEM, "vecchia_grad": M_SMEM_GRAD, "vecchia_bf": M_SMEM}


def system_bytes(base: str, m: int) -> int:
    """Bytes of one system of kernel ``base`` on the shared-memory body."""
    return smem_grad_system_bytes(m) if base == "vecchia_grad" else smem_system_bytes(m)


def cluster_mp(m: int) -> int:
    """m rounded up to CLUSTER_PANEL: the cluster body's slots."""
    return -(-m // CLUSTER_PANEL) * CLUSTER_PANEL


def cluster_owner(p: int, k: int) -> int:
    """The block of a k-block cluster that holds panel p (CLUSTER_PANEL
    columns): snake order, 0 .. k-1 then k-1 .. 0 (``cluster_owner`` of
    csrc/vecchia_large_cluster.cuh)."""
    return p % k if (p // k) % 2 == 0 else k - 1 - p % k


def cluster_block_bytes(m: int, k: int) -> int:
    """Dynamic shared bytes a block of the cluster body takes with k blocks
    a system (``cluster_block_bytes``): its cluster's largest share of the
    panels, each CLUSTER_PANEL columns of rows - c0 float64 words (rows =
    mp + 2: the border rows c and y_N; c0 the panel's first column), and the
    staging buffer, CLUSTER_PANEL columns of rows - CLUSTER_PANEL words."""
    mp = cluster_mp(m)
    words = [0] * k
    for p in range(mp // CLUSTER_PANEL):
        words[cluster_owner(p, k)] += CLUSTER_PANEL * (mp + 2 - p * CLUSTER_PANEL)
    return 8 * (max(words) + cluster_stage_words(m))


def cluster_stage_words(m: int) -> int:
    """float64 words of one staged panel of the cluster body: CLUSTER_PANEL
    columns of rows - CLUSTER_PANEL words, the most a panel's rows below it
    take (``cluster_stage_words``)."""
    return CLUSTER_PANEL * (cluster_mp(m) + 2 - CLUSTER_PANEL)


def cluster_slot_bytes(m: int) -> int:
    """Bytes of the cluster body's hand-off buffer in device memory (the
    launch's scratch tensor): two staged panels for each of CLUSTER_SLOT_SMS
    SMs, the one a panel's owner writes as it factors it and every block of
    its cluster stages from (``valid_cluster``'s note)."""
    return 8 * 2 * CLUSTER_SLOT_SMS * cluster_stage_words(m)


def cluster_blocks(m: int):
    """The smallest cluster size of CLUSTER_SIZES whose blocks hold the
    system of m neighbors within RING_BYTES each, or None."""
    for k in CLUSTER_SIZES:
        if cluster_block_bytes(m, k) <= RING_BYTES:
            return k
    return None


def _max_cluster_m() -> int:
    m = M_SMEM
    while cluster_blocks(m + 1) is not None:
        m += 1
    return m


def _max_cluster_grad_m() -> int:
    m = M_SMEM_GRAD
    while (cluster_blocks(m + 1) is not None
           and 2 * cluster_mp(m + 1) <= cluster_stage_words(m + 1)):
        m += 1
    return m


# the largest m an 8-block cluster holds: kernels 1 and 3 run the cluster
# body for M_SMEM < m <= M_CLUSTER (kClusterM)
M_CLUSTER = _max_cluster_m()
# kernel 2 runs it for M_SMEM_GRAD < m <= M_CLUSTER_GRAD (kClusterGradM):
# the same blocks, p and q (2 mp words) in the staging buffer
M_CLUSTER_GRAD = _max_cluster_grad_m()
# each kernel's (base name's) largest m on the cluster body
CLUSTER_M = {"vecchia_suffstats": M_CLUSTER, "vecchia_grad": M_CLUSTER_GRAD,
             "vecchia_bf": M_CLUSTER}


def large_body(base: str, m: int) -> str:
    """The body a launch of kernel ``base`` (``vecchia_suffstats``,
    ``vecchia_grad`` or ``vecchia_bf``) with m > 32 neighbors runs:
    ``"smem"`` (a warp a system in shared memory) up to the kernel's limit
    (:data:`SMEM_M`: M_SMEM for kernels 1 and 3, M_SMEM_GRAD for kernel 2),
    then ``"cluster"`` (a thread-block cluster a system) up to the kernel's
    :data:`CLUSTER_M` (M_CLUSTER for kernels 1 and 3, M_CLUSTER_GRAD for
    kernel 2), else ``"scratch"`` (a thread a system, its state in a device
    buffer).  A rule of shape: nothing runs on a failure."""
    if not large(m):
        raise ValueError(f"m={m} runs the tile ring, not a large-m body")
    if m <= SMEM_M[base]:
        return "smem"
    return "cluster" if m <= CLUSTER_M[base] else "scratch"


def cluster_geometry(n_pad: int, m: int, chains: int,
                     base: str = "vecchia_suffstats") -> Geometry:
    """The launch of kernel ``base`` on the cluster body (its
    :data:`SMEM_M` < m <= its :data:`CLUSTER_M`) for ``chains`` chains over
    ``n_pad`` sites (a multiple of 128): clusters of ``group`` =
    :func:`cluster_blocks` blocks of
    CLUSTER_THREADS threads, each cluster one chain's sites in a stride of
    ``grid[0]`` (one system at a time), grid[0] clusters a chain, as many as
    keep CLUSTER_SYSTEMS clusters in the launch and no more than the sites
    (the card runs them in waves of what it holds); ``smem_bytes`` a block's
    dynamic shared bytes.  The launch takes a hand-off buffer of
    :func:`cluster_slot_bytes` as its scratch tensor."""
    if n_pad % LARGE_BLOCK or n_pad <= 0:
        raise ValueError(f"n_pad={n_pad} is not a positive multiple of {LARGE_BLOCK}")
    if not 1 <= chains <= 65535:
        raise ValueError(f"chains={chains} out of range")
    if not SMEM_M[base] < m <= CLUSTER_M[base]:
        raise ValueError(f"the cluster body of {base} takes {SMEM_M[base]} < m <= "
                         f"{CLUSTER_M[base]}, got m={m}")
    k = cluster_blocks(m)
    grid_x = max(1, min(n_pad, math.ceil(CLUSTER_SYSTEMS / chains)))
    return Geometry((grid_x, chains), CLUSTER_THREADS, k, cluster_block_bytes(m, k))


def smem_geometry(n_pad: int, m: int, chains: int,
                  base: str = "vecchia_suffstats") -> Geometry:
    """The launch of kernel ``base`` on the shared-memory body (32 < m <=
    its limit, :data:`SMEM_M`) for ``chains`` chains over ``n_pad`` sites
    (a multiple of 128): a block takes ``group`` chains, one warp and one
    system (:func:`system_bytes`) each, as many as GROUP, the chains and its
    shared memory allow (the last group may be ragged); blocks walk the
    sites in a stride of ``grid[0]``, as many as one wave of the SMs holds
    at the blocks an SM takes, and no more than the sites.  No scratch
    buffer."""
    if n_pad % LARGE_BLOCK or n_pad <= 0:
        raise ValueError(f"n_pad={n_pad} is not a positive multiple of {LARGE_BLOCK}")
    if not 1 <= chains <= 65535:
        raise ValueError(f"chains={chains} out of range")
    if not large(m) or m > SMEM_M[base]:
        raise ValueError(f"the shared-memory body of {base} takes {MAX_M} < m <= "
                         f"{SMEM_M[base]}, got m={m}")
    per = system_bytes(base, m)
    group = min(GROUP, chains, RING_BYTES // per)
    smem_bytes = group * per
    per_sm = max(1, min(32, 64 // group, SM_SHARED_BYTES // (smem_bytes + SM_BLOCK_RESERVE)))
    groups = math.ceil(chains / group)
    grid_x = max(1, min(n_pad, math.ceil(SMS * per_sm / groups)))
    return Geometry((grid_x, groups), TILE * group, group, smem_bytes)


def check_card_m(n_pad: int, m: int) -> None:
    """Raise where the card cannot take m neighbors over ``n_pad`` sites
    for one chain: m < 1, or a scratch-body launch whose one block needs
    more than LARGE_SCRATCH_BYTES of scratch.  A kernel runs a scratch body
    only above its :data:`CLUSTER_M` (M_CLUSTER_GRAD for kernel 2, M_CLUSTER
    for kernels 1 and 3); up to the lowest of them every large-m launch runs
    a shared-memory body, which needs no scratch, or the cluster body, whose
    hand-off buffer, under 20 MB, does not grow with the sites.  The models
    call it as they build their tables on the card; a launch checks its own
    chain count."""
    cuda_instance_m(m)
    if large(m) and m > min(CLUSTER_M.values()):
        large_geometry(n_pad, m, 1)
