"""The launch geometry of the three kernels (pynngp_tpu_torch/ops/geometry.py):
block, chain groups, grid and the tile ring's shared-memory bytes for every
m the ring takes (kernel 3's ring without y planes), both table layouts and
coordinate dimensions 1 to 4, and above m = 32 the large-m bodies: the
shared-memory bodies up to M_SMEM (kernels 1 and 3) and M_SMEM_GRAD (kernel
2; their systems' bytes, groups and grid), the cluster body up to M_CLUSTER
(kernels 1 and 3) and M_CLUSTER_GRAD (kernel 2; cluster sizes, a block's
bytes and the grid), the scratch body's grid and buffer above them, and
which body and count each kernel's call gets.  The C launchers recompute
the ring, the systems' and a cluster block's bytes from the same layouts and
refuse other bytes (csrc/vecchia_tile.cuh, csrc/vecchia_large_smem.cuh,
csrc/vecchia_grad_smem.cuh, csrc/vecchia_large_cluster.cuh,
csrc/vecchia_grad_cluster.cuh);
tests/test_torch_cuda.py runs them on the card."""

import math
from types import SimpleNamespace

import pytest
import torch

from pynngp_tpu_torch import kernels
from pynngp_tpu_torch.ops import bf as bops
from pynngp_tpu_torch.ops import diff_suffstats as dops
from pynngp_tpu_torch.ops import geometry as geo
from pynngp_tpu_torch.ops import suffstats as fops

CHAINS = [1, 2, 3, 4, 5, 16, 17]


@pytest.mark.parametrize("chains", CHAINS)
def test_every_m_and_layout_fits_a_block(chains):
    n_pad = 100_096
    for m in range(1, 33):
        for layout, dims in (("dist", (0,)), ("coords", (1, 2, 3, 4))):
            for dim in dims:
                for y_shared in (True, False):
                    for hetero in (False, True):
                        g = geo.geometry(n_pad, m, chains, layout, dim, y_shared, hetero)
                        assert g.group == min(chains, geo.GROUP)
                        assert g.block == 32 * g.group
                        per_block = max(1, min(geo.TILES_PER_BLOCK,
                                               n_pad // 32 * chains // geo.FILL_WARPS))
                        assert geo.geometry(n_pad, m, chains, layout, dim, y_shared, hetero,
                                            general=True).grid == (n_pad // 32, g.grid[1])
                        assert g.grid == (math.ceil(n_pad / 32 / per_block),
                                          math.ceil(chains / g.group))
                        assert g.grid[1] * g.group >= chains > (g.grid[1] - 1) * g.group
                        planes = geo.ring_planes(m, layout, dim,
                                                 1 if y_shared else g.group, hetero)
                        assert g.smem_bytes == geo.STAGES * planes * 32 * 4
                        assert g.smem_bytes <= geo.RING_BYTES < geo.SHARED_BYTES == 232_448


@pytest.mark.parametrize("m,layout,dim,want", [
    (15, "dist", 0, 15 + 105 + 15 + 15),  # d_in, pairs, nn_idx, y
    (12, "dist", 0, 15 + 105 + 15 + 15),  # runs on the M = 15 ring
    (20, "coords", 2, 2 + 40 + 20 + 20),  # own, neighbors, nn_idx, y
    (25, "dist", 0, 25 + 300 + 25 + 25),  # the rolled instance: a ring of m slots
    (7, "coords", 4, 4 + 28 + 7 + 7),  # d > 3 runs rolled too
])
def test_ring_planes_by_instance(m, layout, dim, want):
    assert geo.ring_planes(m, layout, dim) == want
    assert geo.ring_planes(m, layout, dim, ycopies=4, hetero=True) == want + (3 + 1) * (
        m if geo.rolled(m, layout, dim) else geo.cuda_instance_m(m))


def test_geometry_refuses_what_the_card_cannot_take():
    with pytest.raises(ValueError, match="m <= 32"):
        geo.geometry(1536, 33, 4)
    with pytest.raises(ValueError, match="multiple of 32"):
        geo.geometry(1500, 7, 4)
    with pytest.raises(ValueError, match="chains"):
        geo.geometry(1536, 7, 0)
    # coords with many dimensions: the ring fits up to d = 21 at m = 32
    assert geo.geometry(1536, 32, 4, "coords", 21, y_shared=False, hetero=True)
    with pytest.raises(ValueError, match="shared memory"):
        geo.geometry(1536, 32, 4, "coords", 22, y_shared=False, hetero=True)


@pytest.mark.parametrize("hetero", [False, True], ids=["homogeneous", "hetero"])
@pytest.mark.parametrize("m,layout,dim", [(7, "dist", 0), (15, "dist", 0), (20, "dist", 0),
                                          (25, "dist", 0), (32, "dist", 0),
                                          (15, "coords", 2), (20, "coords", 2),
                                          (12, "coords", 4)])
def test_kernel_3_ring_has_no_y_planes(m, layout, dim, hetero):
    """Kernel 3's stage holds its table planes and, with noise weights only,
    the nn_idx planes it gathers v through and the v planes: no y."""
    ml = m if geo.rolled(m, layout, dim) else geo.cuda_instance_m(m)
    tables = dim + ml * dim if layout == "coords" else ml + ml * (ml - 1) // 2
    want = tables + (2 * ml if hetero else 0)
    assert geo.ring_planes(m, layout, dim, ycopies=0, hetero=hetero) == want
    for chains in (1, 3, 8, 16):
        g = geo.geometry(100_096, m, chains, layout, dim, hetero=hetero, with_y=False)
        assert g.smem_bytes == geo.STAGES * want * 32 * 4
        assert g.group == min(chains, geo.GROUP) and g.block == 32 * g.group


@pytest.mark.parametrize("n_pad,m,chains,layout,want_grid", [
    (10_112, 15, 8, "dist", (316, 2)),  # config 2 (path 2): one tile a block
    (500_096, 20, 8, "coords", (3_907, 2)),  # config 5's latent run (path 14)
    (100_096, 15, 16, "dist", (782, 4)),  # the main path's shape, 16 chains
    (100_096, 15, 1, "dist", (3_128, 1)),  # one chain: one tile a block
])
def test_kernel_3_tiles_a_block_by_launch_size(n_pad, m, chains, layout, want_grid):
    """Kernel 3 takes the tiles a block from the launch's size by the rule of
    kernels 1 and 2: as many as keep FILL_WARPS warps, at most
    TILES_PER_BLOCK."""
    dim = 2 if layout == "coords" else 0
    g = geo.geometry(n_pad, m, chains, layout, dim, with_y=False)
    assert g.grid == want_grid
    tiles = n_pad // 32
    per_block = max(1, min(geo.TILES_PER_BLOCK, tiles * chains // geo.FILL_WARPS))
    assert g.grid[0] == math.ceil(tiles / per_block)


@pytest.mark.parametrize("chains", [1, 8, 16])
@pytest.mark.parametrize("m", [33, 40, 64])
def test_large_m_scratch_is_sized_by_the_launchs_threads(m, chains):
    """m > 32: one chain a block of 128 sites, as many blocks as keep
    LARGE_BLOCKS in all (no more than the sites need), and
    large_state_doubles(m) float64 words of scratch for each thread."""
    assert geo.large(m) and geo.cuda_instance_m(m) == m
    assert geo.large_state_doubles(m) == m * (m - 1) // 2 + 6 * m
    for n_pad in (1_536, 10_112, 500_096):
        g = geo.large_geometry(n_pad, m, chains)
        grid_x = min(n_pad // 128, math.ceil(geo.LARGE_BLOCKS / chains))
        assert g.grid == (grid_x, chains) and g.block == 128
        assert g.scratch_bytes == grid_x * chains * 128 * geo.large_state_doubles(m) * 8
        assert g.scratch_bytes <= geo.LARGE_SCRATCH_BYTES
    with pytest.raises(ValueError, match="large-m instance"):
        geo.geometry(10_112, m, chains)


def test_large_m_scratch_cap_is_the_cards_memory():
    """Where the LARGE_SCRATCH_BYTES budget would be passed the grid
    shrinks; where one block a chain passes it, the launch (and, for one
    chain, the model's check) raises and names it."""
    per_block = 128 * geo.large_state_doubles(256) * 8  # 35 MB at m = 256
    fit = geo.LARGE_SCRATCH_BYTES // per_block
    assert fit < geo.LARGE_BLOCKS
    for chains in (1, 2):
        g = geo.large_geometry(500_096, 256, chains)
        assert g.grid == (fit // chains, chains)
        assert g.scratch_bytes <= geo.LARGE_SCRATCH_BYTES
    per_block = 128 * geo.large_state_doubles(64) * 8
    too_many = geo.LARGE_SCRATCH_BYTES // per_block + 1
    with pytest.raises(ValueError, match="LARGE_SCRATCH_BYTES"):
        geo.large_geometry(10_112, 64, too_many)
    geo.check_card_m(10_112, 64)
    big_m = next(m for m in range(64, 10_000, 64)
                 if 128 * geo.large_state_doubles(m) * 8 > geo.LARGE_SCRATCH_BYTES)
    with pytest.raises(ValueError, match="LARGE_SCRATCH_BYTES"):
        geo.check_card_m(10_112, big_m)
    with pytest.raises(ValueError, match="m >= 1"):
        geo.check_card_m(10_112, 0)
    with pytest.raises(ValueError, match="multiple of 128"):
        geo.large_geometry(1_500, 40, 1)


def _system_words(m):
    """A system's float64 words counted column by column: mp = m rounded up
    to 4 columns of mp + 2 rows, column k holding rows k.. rounded up to an
    odd count."""
    mp = -(-m // 4) * 4
    return sum((mp + 2 - k) | 1 for k in range(mp))


@pytest.mark.parametrize("m,want", [(33, 6_048), (36, 6_048), (40, 7_360), (64, 17_920),
                                    (128, 68_608), (233, 228_448), (236, 228_448),
                                    (237, 236_160)])
def test_smem_system_bytes_by_m(m, want):
    """One (site, chain) system of the shared-memory body: the bordered
    triangle in float64, columns rounded up to odd lengths, m rounded up to
    the 4-column panel (m = 33..36 take the same bytes)."""
    assert geo.smem_system_bytes(m) == want == 8 * _system_words(m)
    assert want % 16 == 0  # every system starts on a 16-byte boundary


def test_m_smem_is_the_largest_m_one_block_takes():
    """M_SMEM: the largest m whose one system fits the bytes a block may
    take (the tile ring's budget, RING_BYTES), 236 on an H100."""
    assert geo.M_SMEM == 236
    assert geo.smem_system_bytes(geo.M_SMEM) <= geo.RING_BYTES
    assert geo.smem_system_bytes(geo.M_SMEM + 1) > geo.RING_BYTES
    assert all(geo.smem_system_bytes(m) <= geo.smem_system_bytes(m + 1)
               for m in range(33, geo.M_SMEM + 1))


@pytest.mark.parametrize("chains", CHAINS)
@pytest.mark.parametrize("m", [33, 40, 64, 100, 128, 180, geo.M_SMEM])
def test_smem_geometry_groups_chains_by_shared_memory(m, chains):
    """A block takes as many chains (one warp, one system each) as GROUP,
    the chains and its shared memory allow; the grid walks the sites with
    one wave of blocks over the SMs, no more blocks than sites."""
    per = geo.smem_system_bytes(m)
    for n_pad in (128, 1_536, 10_112, 500_096):
        g = geo.smem_geometry(n_pad, m, chains)
        assert g.group == min(geo.GROUP, chains, geo.RING_BYTES // per) >= 1
        assert g.block == 32 * g.group
        assert g.smem_bytes == g.group * per <= geo.RING_BYTES
        assert g.grid[1] == math.ceil(chains / g.group)
        per_sm = max(1, min(32, 64 // g.group,
                            geo.SM_SHARED_BYTES // (g.smem_bytes + geo.SM_BLOCK_RESERVE)))
        assert g.grid[0] == max(1, min(n_pad, math.ceil(geo.SMS * per_sm / g.grid[1])))
    assert geo.smem_geometry(10_112, 64, 16) == geo.Geometry((99, 4), 128, 4, 71_680)


def test_smem_geometry_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="shared-memory body"):
        geo.smem_geometry(1_536, 32, 4)
    with pytest.raises(ValueError, match="shared-memory body"):
        geo.smem_geometry(1_536, geo.M_SMEM + 1, 4)
    with pytest.raises(ValueError, match="multiple of 128"):
        geo.smem_geometry(1_500, 40, 4)
    with pytest.raises(ValueError, match="chains"):
        geo.smem_geometry(1_536, 40, 0)
    with pytest.raises(ValueError, match="tile ring"):
        geo.large_body("vecchia_suffstats", 32)


@pytest.mark.parametrize("base", ["vecchia_suffstats", "vecchia_grad", "vecchia_bf"])
@pytest.mark.parametrize("m", [33, 64, geo.M_SMEM_GRAD, geo.M_SMEM_GRAD + 1, geo.M_SMEM,
                               geo.M_SMEM + 1, geo.M_CLUSTER, geo.M_CLUSTER + 1])
def test_each_kernel_gets_its_body_and_count_by_m(base, m):
    """Each kernel runs its shared-memory body up to its limit (M_SMEM for
    kernels 1 and 3, M_SMEM_GRAD for kernel 2; counted under ``_large``, no
    scratch tensor, group chains a block and their systems' bytes); each
    then runs the cluster body up to its limit (M_CLUSTER for kernels 1 and
    3, M_CLUSTER_GRAD for kernel 2; ``_large_cluster``, group the cluster's
    blocks and a block's bytes), and the scratch body above it
    (``_large_scratch``).  The cluster body's scratch tensor is its hand-off
    buffer."""
    tables = SimpleNamespace(m=m, n_pad=128, layout="dist", dim=0,
                             device=torch.device("cpu"))
    chains = 3
    grad = base == "vecchia_grad"
    smem = m <= (geo.M_SMEM_GRAD if grad else geo.M_SMEM)
    cluster = not smem and m <= (geo.M_CLUSTER_GRAD if grad else geo.M_CLUSTER)
    body = "smem" if smem else "cluster" if cluster else "scratch"
    assert geo.large_body(base, m) == body
    name = fops.instance(base, kernels.SqExp(), tables, hetero=True)
    suffix = {"smem": "_large_hetero", "cluster": "_large_cluster_hetero",
              "scratch": "_large_scratch_hetero"}[body]
    assert name == base + suffix
    counts = {**fops.COUNTS, **dops.COUNTS, **bops.COUNTS}
    assert name in counts and name + "_sharded" in counts  # each body counted apart
    y = None if base == "vecchia_bf" else torch.zeros(10)
    grid_x, args, scratch = fops.launch_geometry(base, kernels.SqExp(), tables, chains, y,
                                                 None)
    if smem:
        g = geo.smem_geometry(128, m, chains, base)
        assert scratch is None and args == (g.group, g.grid[0], g.smem_bytes, None)
        assert grid_x == g.grid[0] and g.smem_bytes == g.group * geo.system_bytes(base, m)
    elif cluster:
        g = geo.cluster_geometry(128, m, chains, base)
        assert args[:3] == (g.group, g.grid[0], g.smem_bytes)
        assert scratch is not None and scratch.numel() * 8 == geo.cluster_slot_bytes(m)
        assert args[3] == scratch.data_ptr() and scratch.dtype == torch.float64
        assert grid_x == g.grid[0] == 128 and g.group == geo.cluster_blocks(m)
        assert g.smem_bytes == geo.cluster_block_bytes(m, g.group) <= geo.RING_BYTES
    else:
        g = geo.large_geometry(128, m, chains)
        assert args[:3] == (1, g.grid[0], 0) and grid_x == g.grid[0] == 1
        assert scratch is not None and scratch.numel() * 8 == g.scratch_bytes
        assert args[3] == scratch.data_ptr()


@pytest.mark.parametrize("m,want", [(33, 6_624), (36, 6_624), (40, 8_000), (64, 18_944),
                                    (128, 70_656), (232, 224_576), (233, 232_224)])
def test_kernel_2_system_bytes_by_m(m, want):
    """Kernel 2's system on the shared-memory body: kernel 1's bordered
    triangle and two vectors of mp float64 words beside it (d c / d phi and
    d c / d nu, then p and q); every system starts on a 16-byte boundary."""
    mp = -(-m // 4) * 4
    assert geo.smem_grad_system_bytes(m) == want == 8 * (_system_words(m) + 2 * mp)
    assert geo.system_bytes("vecchia_grad", m) == want
    assert geo.system_bytes("vecchia_bf", m) == geo.smem_system_bytes(m)
    assert want % 16 == 0


def test_m_smem_grad_is_the_largest_m_one_block_takes():
    """M_SMEM_GRAD: the largest m whose one kernel-2 system fits the bytes a
    block may take, 232 on an H100, below kernels 1 and 3's M_SMEM; each
    kernel's limit in SMEM_M."""
    assert geo.M_SMEM_GRAD == 232 < geo.M_SMEM
    assert geo.smem_grad_system_bytes(geo.M_SMEM_GRAD) <= geo.RING_BYTES
    assert geo.smem_grad_system_bytes(geo.M_SMEM_GRAD + 1) > geo.RING_BYTES
    assert all(geo.smem_grad_system_bytes(m) <= geo.smem_grad_system_bytes(m + 1)
               for m in range(33, geo.M_SMEM_GRAD + 1))
    assert geo.SMEM_M == {"vecchia_suffstats": geo.M_SMEM, "vecchia_grad": geo.M_SMEM_GRAD,
                          "vecchia_bf": geo.M_SMEM}


@pytest.mark.parametrize("chains", CHAINS)
@pytest.mark.parametrize("m", [33, 40, 64, 100, 128, 180, geo.M_SMEM_GRAD])
def test_smem_geometry_of_kernel_2_groups_chains_by_its_system_bytes(m, chains):
    """Kernel 2's shared-memory launch: as many chains a block as GROUP, the
    chains and its larger systems allow; the grid by the same rule as
    kernels 1 and 3's, from its own bytes."""
    per = geo.smem_grad_system_bytes(m)
    for n_pad in (128, 1_536, 10_112, 500_096):
        g = geo.smem_geometry(n_pad, m, chains, "vecchia_grad")
        assert g.group == min(geo.GROUP, chains, geo.RING_BYTES // per) >= 1
        assert g.block == 32 * g.group
        assert g.smem_bytes == g.group * per <= geo.RING_BYTES
        assert g.grid[1] == math.ceil(chains / g.group)
        per_sm = max(1, min(32, 64 // g.group,
                            geo.SM_SHARED_BYTES // (g.smem_bytes + geo.SM_BLOCK_RESERVE)))
        assert g.grid[0] == max(1, min(n_pad, math.ceil(geo.SMS * per_sm / g.grid[1])))


@pytest.mark.parametrize("m,want", [(64, geo.Geometry((99, 4), 128, 4, 75_776)),
                                    (128, geo.Geometry((22, 6), 96, 3, 211_968)),
                                    (geo.M_SMEM_GRAD, geo.Geometry((9, 16), 32, 1, 224_576))])
def test_smem_geometry_of_kernel_2_at_sixteen_chains(m, want):
    """Kernel 2 at 16 chains over 10,112 sites: four systems a block and
    three blocks an SM at m = 64, as kernels 1 and 3; three a block at
    m = 128 and one at its limit, one block an SM."""
    assert geo.smem_geometry(10_112, m, 16, "vecchia_grad") == want


def test_smem_geometry_of_kernel_2_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="shared-memory body of vecchia_grad"):
        geo.smem_geometry(1_536, geo.M_SMEM_GRAD + 1, 4, "vecchia_grad")
    with pytest.raises(ValueError, match="shared-memory body of vecchia_grad"):
        geo.smem_geometry(1_536, 32, 4, "vecchia_grad")
    assert geo.smem_geometry(1_536, geo.M_SMEM_GRAD + 1, 4).group == 1  # kernels 1 and 3


@pytest.mark.parametrize("m", [33, 64, geo.M_SMEM_GRAD, geo.M_SMEM_GRAD + 1, geo.M_SMEM + 1,
                               geo.M_CLUSTER_GRAD, geo.M_CLUSTER + 1])
def test_check_card_m_raises_only_where_a_scratch_body_runs(m, monkeypatch):
    """check_card_m asks the scratch body's budget only above M_CLUSTER_GRAD
    (= M_CLUSTER), where kernel 2 and kernels 1 and 3 run the scratch body;
    up to it every large-m launch runs a shared-memory body or the cluster
    body and needs none.  With a budget too small for one block of one chain
    it raises exactly there, and names it."""
    geo.check_card_m(10_112, m)
    monkeypatch.setattr(geo, "LARGE_SCRATCH_BYTES", 1 << 20)
    if m <= geo.M_CLUSTER_GRAD:
        geo.check_card_m(10_112, m)
    else:
        with pytest.raises(ValueError, match="LARGE_SCRATCH_BYTES"):
            geo.check_card_m(10_112, m)


M20_LAYOUTS = [("dist", 0), ("coords", 1), ("coords", 2), ("coords", 3)]


@pytest.mark.parametrize("chains", CHAINS)
@pytest.mark.parametrize("m", [16, 17, 18, 19, 20])
def test_m20_team_bodies_keep_the_ring_and_grid(m, chains):
    """15 < m <= 20 on both layouts (d <= 3), with and without weights, a
    shared and a per-chain y: the M = 20 ring and grid of every tile launch
    (the team bodies change how a warp turns a staged tile into systems, not
    what is staged; kernel 3's ring without y planes), a team body on every
    closed-form coords instance and on kernel 2-dist, a lane a site on
    kernels 1 and 3 on dist (measured faster) and the general-nu instances;
    the instances' names and counts as before, the
    team bodies' launches also counted under ``_m20`` (and ``_m20_4_chains``
    at 4 chains), and no large-m body."""
    n_pad = 500_096
    assert geo.cuda_instance_m(m) == geo.TEAM_M == 20 and not geo.large(m)
    with pytest.raises(ValueError, match="tile ring"):
        geo.large_body("vecchia_grad", m)
    for layout, dim in M20_LAYOUTS:
        team = {"vecchia_grad": True, "vecchia_suffstats": layout == "coords",
                "vecchia_bf": layout == "coords"}
        for base, want in team.items():
            assert geo.team_body(base, m, layout, dim) is want
            assert not geo.team_body(base, m, layout, dim, general=True)
        tables = SimpleNamespace(m=m, n_pad=n_pad, layout=layout, dim=dim,
                                 device=torch.device("cpu"))
        sfx = "_coords" if layout == "coords" else ""
        assert fops.instance("vecchia_grad", kernels.SqExp(), tables, True, True) == (
            "vecchia_grad_y" + sfx + "_hetero")
        assert fops.entry_name("vecchia_grad", kernels.SqExp(), tables) + "_m20" in \
            fops.COUNTS_M20
        for base in ("vecchia_suffstats", "vecchia_bf"):
            assert (fops.entry_name(base, kernels.SqExp(), tables) + "_m20"
                    in fops.COUNTS_M20) is team[base]
        for base, emit_y in (("vecchia_grad", False), ("vecchia_grad", True),
                             ("vecchia_suffstats", False), ("vecchia_bf", False)):
            for sharded in (False, True):
                before = {k: c.launches for k, c in fops.COUNTS_M20.items()}
                fops.count_team(base, kernels.SqExp(), tables, chains, emit_y, sharded)
                fops.count_team(base, kernels.Matern(nu=None), tables, chains, emit_y, sharded)
                added = {k for k, c in fops.COUNTS_M20.items() if c.launches != before[k]}
                name = (fops.entry_name(base, kernels.SqExp(), tables, emit_y) + "_m20",
                        "_sharded" if sharded else "")
                want = ({name[0] + name[1]} | ({name[0] + "_4_chains" + name[1]}
                                               if chains == 4 else set())
                        if geo.team_body(base, m, layout, dim) else set())
                assert added == want
                assert all(fops.COUNTS_M20[k].launches == before[k] + 1 for k in added)
        for y_shared in (True, False):
            for hetero in (False, True):
                g = geo.geometry(n_pad, m, chains, layout, dim, y_shared, hetero)
                assert g == geo.geometry(n_pad, 20, chains, layout, dim, y_shared, hetero)
                assert g.group == min(chains, geo.GROUP) and g.block == 32 * g.group
                per_block = max(1, min(geo.TILES_PER_BLOCK,
                                       n_pad // 32 * chains // geo.FILL_WARPS))
                assert g.grid == (math.ceil(n_pad / 32 / per_block),
                                  math.ceil(chains / g.group))
                ycopies = 1 if y_shared else g.group
                tables_planes = 20 + 190 if layout == "dist" else dim + 20 * dim
                planes = tables_planes + 20 + ycopies * 20 + (20 if hetero else 0)
                assert geo.ring_planes(m, layout, dim, ycopies, hetero) == planes
                assert g.smem_bytes == geo.STAGES * planes * 32 * 4 <= geo.RING_BYTES
                # kernel 3: no y planes, and nn_idx planes only to gather v
                g3 = geo.geometry(n_pad, m, chains, layout, dim, hetero=hetero, with_y=False)
                assert g3 == geo.geometry(n_pad, 20, chains, layout, dim, hetero=hetero,
                                          with_y=False)
                assert (g3.grid, g3.block, g3.group) == (g.grid, g.block, g.group)
                planes3 = tables_planes + (40 if hetero else 0)
                assert g3.smem_bytes == geo.STAGES * planes3 * 32 * 4


@pytest.mark.parametrize("m,layout,dim", [(15, "dist", 0), (15, "coords", 2), (21, "dist", 0),
                                          (21, "coords", 3), (20, "coords", 4)])
def test_m15_m21_and_four_dimensions_keep_their_old_geometry(m, layout, dim):
    """m = 15 (the M = 15 instance), m = 21 (the rolled one) and d = 4 at
    m = 20 (the rolled one) keep a lane a (site, chain) and the geometry
    they had: their ring's planes and the grid of every tile launch."""
    for base in ("vecchia_suffstats", "vecchia_grad", "vecchia_bf"):
        assert not geo.team_body(base, m, layout, dim)
    ml = m if geo.rolled(m, layout, dim) else 15
    assert geo.rolled(m, layout, dim) == (m > 20 or dim > 3)
    tables_planes = ml + ml * (ml - 1) // 2 if layout == "dist" else dim + ml * dim
    g = geo.geometry(100_096, m, 16, layout, dim)
    assert g == geo.Geometry((782, 4), 128, 4, 2 * (tables_planes + 2 * ml) * 32 * 4)


# the first and last m of each cluster size, and a block's bytes there
CLUSTER_BOUNDS = [(237, 2, 136_192), (312, 2, 221_824), (313, 4, 126_336), (440, 4, 226_688),
                  (441, 8, 133_120), (600, 8, 222_976), (608, 8, 228_096)]


def test_m_cluster_is_the_largest_m_eight_blocks_take():
    """M_CLUSTER: the largest m whose system eight blocks hold, each block
    its share of the panels and the staging buffer within RING_BYTES: 608
    on an H100 (kClusterM of csrc/vecchia_large_cluster.cuh asserts the
    same); every m from M_SMEM + 1 to it has a cluster size, and none above."""
    assert geo.M_CLUSTER == 608 > geo.M_SMEM
    assert geo.cluster_block_bytes(geo.M_CLUSTER, 8) <= geo.RING_BYTES
    assert geo.cluster_block_bytes(geo.M_CLUSTER + 1, 8) > geo.RING_BYTES
    assert geo.cluster_blocks(geo.M_CLUSTER + 1) is None
    assert all(geo.cluster_blocks(m) in geo.CLUSTER_SIZES
               for m in range(geo.M_SMEM + 1, geo.M_CLUSTER + 1))
    assert geo.CLUSTER_M == {"vecchia_suffstats": geo.M_CLUSTER,
                             "vecchia_grad": geo.M_CLUSTER_GRAD, "vecchia_bf": geo.M_CLUSTER}


@pytest.mark.parametrize("m,k,want", CLUSTER_BOUNDS)
def test_cluster_blocks_and_bytes_at_each_boundary(m, k, want):
    """The smallest cluster size whose blocks hold the system, at the first
    and last m of each size, and a block's dynamic bytes: its largest share
    of the panels (each CLUSTER_PANEL columns of rows - c0 float64 words,
    rows = mp + 2) and the staging buffer (CLUSTER_PANEL columns of rows -
    CLUSTER_PANEL words), counted here from the panels' owners."""
    assert geo.cluster_blocks(m) == k
    assert k == 2 or geo.cluster_block_bytes(m, k // 2) > geo.RING_BYTES
    mp = -(-m // 8) * 8
    shares = [sum(8 * (mp + 2 - 8 * p) for p in range(mp // 8) if geo.cluster_owner(p, k) == r)
              for r in range(k)]
    assert sum(shares) == 8 * sum(mp + 2 - 8 * p for p in range(mp // 8))
    assert geo.cluster_block_bytes(m, k) == 8 * (max(shares) + 8 * (mp + 2 - 8)) == want
    assert want <= geo.RING_BYTES


@pytest.mark.parametrize("k", geo.CLUSTER_SIZES)
def test_cluster_panels_go_to_the_blocks_in_snake_order(k):
    """Each round of k panels gives each block one, in rank order on even
    rounds and reversed on odd ones."""
    owners = [geo.cluster_owner(p, k) for p in range(4 * k)]
    assert owners[:2 * k] == list(range(k)) + list(range(k))[::-1]
    assert owners[2 * k:] == owners[:2 * k]
    for r in range(4):
        assert sorted(owners[r * k:(r + 1) * k]) == list(range(k))


@pytest.mark.parametrize("chains", [1, 3, 4, 16, 5000])
@pytest.mark.parametrize("m", [geo.M_SMEM + 1, 400, geo.M_CLUSTER])
def test_cluster_geometry_walks_each_chains_sites(m, chains):
    """The cluster body's launch: clusters of cluster_blocks(m) blocks of
    CLUSTER_THREADS threads, grid[0] clusters a chain (CLUSTER_SYSTEMS in
    all at most, before rounding up, and no more than the sites), a block's
    bytes; refused outside M_SMEM < m <= M_CLUSTER."""
    for n_pad in (128, 2_048, 100_096):
        g = geo.cluster_geometry(n_pad, m, chains)
        want_x = max(1, min(n_pad, math.ceil(geo.CLUSTER_SYSTEMS / chains)))
        assert g == geo.Geometry((want_x, chains), geo.CLUSTER_THREADS, geo.cluster_blocks(m),
                                 geo.cluster_block_bytes(m, geo.cluster_blocks(m)))
    with pytest.raises(ValueError, match="cluster body"):
        geo.cluster_geometry(2_048, geo.M_SMEM, chains)
    with pytest.raises(ValueError, match="cluster body"):
        geo.cluster_geometry(2_048, geo.M_CLUSTER + 1, chains)
    with pytest.raises(ValueError, match="multiple of 128"):
        geo.cluster_geometry(2_000, m, chains)


def test_cluster_body_holds_one_block_an_sm_and_sizes_its_hand_off_buffer():
    """Every block of the cluster body takes more than half an SM's shared
    memory at every m it runs, so an SM holds one block at a time and the
    hand-off buffer has two slots an SM (CLUSTER_SLOT_SMS of them), each one
    staged panel: CLUSTER_PANEL columns of mp + 2 - CLUSTER_PANEL words."""
    least = min(geo.cluster_block_bytes(m, geo.cluster_blocks(m))
                for m in range(geo.M_SMEM + 1, geo.M_CLUSTER + 1))
    assert 2 * least > geo.SM_SHARED_BYTES
    assert geo.CLUSTER_SLOT_SMS >= geo.SMS
    for m in (geo.M_SMEM + 1, 400, geo.M_CLUSTER):
        mp = -(-m // 8) * 8
        assert geo.cluster_stage_words(m) == 8 * (mp + 2 - 8)
        assert geo.cluster_slot_bytes(m) == 8 * 2 * geo.CLUSTER_SLOT_SMS * 8 * (mp + 2 - 8)
    assert geo.cluster_slot_bytes(geo.M_CLUSTER) < 20 << 20


def test_m_cluster_grad_is_kernel_1s_limit():
    """M_CLUSTER_GRAD: the largest m kernel 2 runs on the cluster body.  Its
    blocks take kernel 1's bytes and keep p and q (2 mp float64 words) in
    the staging buffer (CLUSTER_PANEL (mp + 2 - CLUSTER_PANEL) words), which
    holds them at every m, so it is M_CLUSTER: 608 (kClusterGradM of
    csrc/vecchia_grad_cluster.cuh asserts the same).  Kernel 2's first m
    there has kernel 1's first slots, so its blocks too fill more than half
    an SM."""
    assert geo.M_CLUSTER_GRAD == geo.M_CLUSTER == 608
    for m in range(geo.M_SMEM_GRAD + 1, geo.M_CLUSTER_GRAD + 1):
        assert 2 * geo.cluster_mp(m) <= geo.cluster_stage_words(m)
    assert geo.cluster_mp(geo.M_SMEM_GRAD + 1) == geo.cluster_mp(geo.M_SMEM + 1) == 240
    k = geo.cluster_blocks(geo.M_SMEM_GRAD + 1)
    assert k == 2 and 2 * geo.cluster_block_bytes(geo.M_SMEM_GRAD + 1, k) > geo.SM_SHARED_BYTES


@pytest.mark.parametrize("m", [geo.M_SMEM_GRAD, geo.M_SMEM_GRAD + 1, geo.M_SMEM, geo.M_SMEM + 1,
                               geo.M_CLUSTER_GRAD, geo.M_CLUSTER_GRAD + 1])
def test_kernel_2_body_and_instance_at_its_cluster_limits(m):
    """Kernel 2 and its EMIT_Y instance by m: the shared-memory body up to
    M_SMEM_GRAD, the cluster body from M_SMEM_GRAD + 1 (below kernels 1 and
    3's first cluster m) to M_CLUSTER_GRAD, the scratch body above, each
    counted under its own name, the general-nu and coords instances too."""
    body = geo.large_body("vecchia_grad", m)
    assert body == ("smem" if m <= geo.M_SMEM_GRAD else
                    "cluster" if m <= geo.M_CLUSTER_GRAD else "scratch")
    sfx = {"smem": "_large", "cluster": "_large_cluster", "scratch": "_large_scratch"}[body]
    for layout in ("dist", "coords"):
        tables = SimpleNamespace(m=m, n_pad=128, layout=layout, dim=2,
                                 device=torch.device("cpu"))
        for kern, nu in ((kernels.SqExp(), ""), (kernels.Matern(), "_nu")):
            lay = "_coords" if layout == "coords" else ""
            assert fops.instance("vecchia_grad", kern, tables) == f"vecchia_grad{nu}{lay}{sfx}"
            name = fops.instance("vecchia_grad", kern, tables, emit_y=True, hetero=True)
            assert name == f"vecchia_grad_y{nu}{lay}{sfx}_hetero" and name in dops.COUNTS


@pytest.mark.parametrize("chains", [1, 4, 16])
@pytest.mark.parametrize("m", [geo.M_SMEM_GRAD + 1, 400, geo.M_CLUSTER_GRAD])
def test_cluster_geometry_of_kernel_2(m, chains):
    """Kernel 2's cluster launch is kernel 1's at the same m (the same
    blocks, grid and bytes), and it starts at M_SMEM_GRAD + 1: refused at
    M_SMEM_GRAD and above M_CLUSTER_GRAD, while kernel 1's refuses the m
    below M_SMEM + 1."""
    g = geo.cluster_geometry(2_048, m, chains, "vecchia_grad")
    k = geo.cluster_blocks(m)
    want_x = max(1, min(2_048, math.ceil(geo.CLUSTER_SYSTEMS / chains)))
    assert g == geo.Geometry((want_x, chains), geo.CLUSTER_THREADS, k,
                             geo.cluster_block_bytes(m, k))
    if m > geo.M_SMEM:
        assert g == geo.cluster_geometry(2_048, m, chains)
    else:
        with pytest.raises(ValueError, match="cluster body"):
            geo.cluster_geometry(2_048, m, chains)
    for bad in (geo.M_SMEM_GRAD, geo.M_CLUSTER_GRAD + 1):
        with pytest.raises(ValueError, match="cluster body of vecchia_grad"):
            geo.cluster_geometry(2_048, bad, chains, "vecchia_grad")
