"""The launch geometry of the three kernels (pynngp_tpu_torch/ops/geometry.py):
block, chain groups, grid and the tile ring's shared-memory bytes for every
m the ring takes (kernel 3's ring without y planes), both table layouts and
coordinate dimensions 1 to 4, and above m = 32 the large-m instances' grid
and scratch buffer.  The C launcher recomputes the ring from the same layout
and refuses other bytes (csrc/vecchia_tile.cuh); tests/test_torch_cuda.py
runs it on the card."""

import math

import pytest

from pynngp_tpu_torch.ops import geometry as geo

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
