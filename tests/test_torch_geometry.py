"""The launch geometry of kernels 1 and 2 (pynngp_tpu_torch/ops/geometry.py):
block, chain groups, grid and the tile ring's shared-memory bytes for every
m the card takes, both table layouts and coordinate dimensions 1 to 4.  The
C launcher recomputes the ring from the same layout and refuses other bytes
(csrc/vecchia_tile.cuh); tests/test_torch_cuda.py runs it on the card."""

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
