"""pynngp_tpu_torch host-side pieces against the reference package: neighbor
tables, the latent sampler's children, colour and pair tables, diagnostics,
the plane-major site tables, and a JAX-free import."""

import ctypes
import glob
import os
import re
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu import diagnostics as jdiag
from pynngp_tpu import native as jnative
from pynngp_tpu import neighbors as jnbr
from pynngp_tpu import vecchia as jvecchia
from pynngp_tpu.models.response import ResponseNNGP as JaxResponseNNGP
from pynngp_tpu.ops import pallas_bf as pb
from pynngp_tpu_torch import convert, diagnostics, neighbors
from pynngp_tpu_torch.models.response import ResponseNNGP
from pynngp_tpu_torch.noise import HeterogeneousNoise
from pynngp_tpu_torch.ops import _build
from pynngp_tpu_torch.ops.suffstats import cuda_instance_m
from pynngp_tpu_torch.ops.site_tables import BLOCK, make_site_tables, tri_index
from pynngp_tpu_torch.parallel import make_mesh
from pynngp_tpu_torch.vecchia import make_vecchia_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("use_native", ["auto", "never"])
@pytest.mark.parametrize("m", [7, 15])
def test_neighbor_table_matches_reference(use_native, m):
    coords = np.random.default_rng(5).uniform(size=(3000, 2))
    # no cache on either side: each call builds its table on its own path
    got = neighbors.build_neighbor_table(coords, m, use_native=use_native,
                                         cache=False)
    want = jnbr.build_neighbor_table(coords, m, use_native=use_native,
                                     cache=False)
    np.testing.assert_array_equal(got.order, want.order)
    np.testing.assert_array_equal(got.inverse_order, want.inverse_order)
    np.testing.assert_array_equal(got.nn_idx, want.nn_idx)
    np.testing.assert_array_equal(got.nn_mask, want.nn_mask)
    assert got.nn_idx.dtype == want.nn_idx.dtype


@pytest.fixture(scope="module")
def small_table():
    coords = np.random.default_rng(1).uniform(size=(700, 2))
    return neighbors.build_neighbor_table(coords, 7)


@pytest.mark.parametrize("use_native", ["auto", "never"])
def test_children_table_matches_reference(small_table, use_native):
    t = small_table
    got = neighbors.build_children_table(t.nn_idx, t.nn_mask, use_native=use_native)
    want = jnbr.build_children_table(t.nn_idx, t.nn_mask, use_native=use_native)
    assert got.max_children == want.max_children
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # every valid (site, slot) entry of the neighbor table is one child entry
    assert got.child_mask.sum() == t.nn_mask.sum()


@pytest.mark.parametrize("use_native", ["auto", "never"])
def test_colours_and_colour_tables_match_reference(small_table, use_native,
                                                   monkeypatch):
    """Colours, the padded per-colour site table and the packed (parent,
    child) pair tables, bit for bit; the pure-numpy branch is compared with
    the reference's by switching the reference's native library off."""
    t = small_table
    if use_native == "never":
        monkeypatch.setattr(jnative, "native_available", lambda: False)
    got = neighbors.color_moral_graph(t.nn_idx, t.nn_mask, use_native=use_native)
    want = jnbr.color_moral_graph(t.nn_idx, t.nn_mask)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    ch = neighbors.build_children_table(t.nn_idx, t.nn_mask, use_native=use_native)
    # a proper colouring of the moral graph: no site shares a colour with a
    # parent, nor with a co-parent of any of its children
    for j in range(t.n):
        fam = np.append(t.nn_idx[j][t.nn_mask[j]], j)
        assert len(set(got[fam])) == len(fam)
    sites, smask = neighbors.color_site_table(got)
    jsites, jsmask = jnbr.color_site_table(want)
    np.testing.assert_array_equal(sites, jsites)
    np.testing.assert_array_equal(smask, jsmask)
    assert sites.dtype == jsites.dtype
    pairs = neighbors.color_child_pairs(got, sites, smask, ch.child_idx,
                                        ch.child_mask)
    jpairs = jnbr.color_child_pairs(want, jsites, jsmask, ch.child_idx,
                                    ch.child_mask)
    for a, b in zip(pairs, jpairs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert pairs[3].sum() == ch.child_mask.sum()  # every live pair, once


def test_unbalanced_colouring_matches_reference(small_table):
    t = small_table
    got = neighbors.color_moral_graph(t.nn_idx, t.nn_mask, balanced=False)
    want = jnbr.color_moral_graph(t.nn_idx, t.nn_mask, balanced=False)
    np.testing.assert_array_equal(got, want)


def test_diagnostics_match_reference():
    rng = np.random.default_rng(11)
    x = np.zeros((4, 800))
    for t in range(1, 800):  # AR(1) chains with a per-chain offset
        x[:, t] = 0.8 * x[:, t - 1] + rng.standard_normal(4)
    x += np.arange(4)[:, None] * 0.05
    assert diagnostics.ess(x) == jdiag.ess(x)
    assert diagnostics.ess(x[0]) == jdiag.ess(x[0])
    assert diagnostics.split_rhat(x) == jdiag.split_rhat(x)


def test_site_tables_match_lane_cache():
    """make_site_tables equals the reference's dist-layout lane cache
    carried across by convert.site_tables_from_lane_cache."""
    rng = np.random.default_rng(3)
    n, m = 1500, 7
    coords = rng.uniform(size=(n, 2))
    jdata, _ = jvecchia.make_vecchia_data(coords, m)
    cache = pb.make_lane_cache(jdata, layout="dist")
    want = convert.site_tables_from_lane_cache(
        np.asarray(cache.tab_a), np.asarray(cache.tab_b),
        np.asarray(cache.nn_idx), n,
    )
    data, _ = make_vecchia_data(coords, m, dtype=torch.float32, device="cpu")
    got = make_site_tables(data, dtype=torch.float32, device="cpu")
    assert got.n == want.n == n
    assert got.n_pad == want.n_pad == 1536 and got.n_pad % BLOCK == 0
    assert got.layout == want.layout == "dist"
    assert got.tab_a.shape == (m, got.n_pad)
    assert got.tab_b.shape == (m * (m - 1) // 2, got.n_pad)
    for name in ("tab_a", "tab_b", "nn_idx"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.is_contiguous()
        assert torch.equal(a, b), name
    # packed-plane order: plane tri_index(i, k) holds the (i, k) pair
    i, k = 5, 2
    np.testing.assert_array_equal(
        got.tab_b[tri_index(i, k), :n].numpy(),
        data.nn_cross_dist[:, i, k],
    )


_JAX_FREE = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None       # any import of jax now fails
    sys.modules["triton"] = None
    import numpy as np
    import torch
    import pynngp_tpu_torch as pt
    assert not torch.cuda.is_available()
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(200, 2))
    y = rng.standard_normal(200)
    model = pt.ResponseNNGP(coords, y, m=5, device="cpu")
    draws = model.sample(30, n_burn=10, n_chains=2, seed=0)
    assert draws["phi"].shape == (2, 30)
    assert all(np.isfinite(v).all() for v in draws.values())
    x = np.column_stack([np.ones(200), rng.standard_normal(200)])
    draws = pt.ResponseNNGP(coords, y, m=5, x=x, device="cpu").sample(
        10, n_burn=5, n_chains=2, seed=0)
    assert draws["beta"].shape == (2, 10, 2)
    latent = pt.LatentNNGP(coords, y, m=5, device="cpu")
    draws = latent.sample(10, n_burn=5, n_chains=2, seed=0, w_every=4)
    assert draws["w"].shape == (2, 3, 200)
    assert all(np.isfinite(v).all() for v in draws.values())
    loaded = [name for name, mod in sys.modules.items()
              if mod is not None and name.split(".")[0] in ("jax", "pynngp_tpu")]
    assert not loaded, loaded
    print("OK")
""")


def test_port_runs_without_jax_or_triton():
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_FREE], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


_SMALL = np.random.default_rng(2).uniform(size=(60, 2))
_WEIGHTS = np.random.default_rng(3).uniform(0.25, 4.0, 60)


@pytest.mark.parametrize("kwargs,exc", [
    ({"x": np.ones(60)}, ValueError),
    # a mesh is ported: two site shards on the CPU build and run
    ({"mesh": make_mesh(1, 2, devices=["cpu", "cpu"])}, None),
    # heterogeneous noise is ported; without its weights it raises TypeError,
    # as the reference's get_noise does
    ({"noise": "heterogeneous"}, TypeError),
    # the general-nu Matern, the dot-product distance, the max-min ordering
    # and the coords layout with per-site noise are ported: they build and
    # give finite values (exc None)
    ({"distance": "dotproduct"}, None),
    ({"kernel": "matern", "noise": HeterogeneousNoise(_WEIGHTS)}, None),
    ({"ordering": "maxmin"}, None),
    ({"lane_layout": "coords", "noise": HeterogeneousNoise(_WEIGHTS)}, None),
    ({"device": "mps"}, ValueError),
    # the reference's constructor arguments: distances computed from the
    # coordinates, and a backend the port takes and ignores
    ({"precompute_distances": False, "backend": "xla"}, None),
], ids=["x", "mesh", "hetero", "dotproduct", "general_nu", "maxmin", "coords",
        "mps", "reference_args"])
def test_unported_options_raise(kwargs, exc):
    """Options the port does not have raise (the reference's own error for
    bare heterogeneous noise); the ported ones build and run, and where the
    reference takes the same arguments, give its full_loglik."""
    args = {"m": 5, "device": "cpu", **kwargs}
    if exc is None:
        y = np.sin(6.0 * _SMALL[:, 0])
        model = ResponseNNGP(_SMALL, y, dtype=torch.float64, **args)
        with torch.no_grad():
            u = torch.zeros((1, model.full_dim()), dtype=torch.float64)
            assert torch.isfinite(model.full_logpost(u)).all()
            if "backend" in kwargs:
                ref = JaxResponseNNGP(_SMALL, y, m=5, dtype=jnp.float64, **kwargs)
                np.testing.assert_allclose(
                    model.full_loglik(u).numpy(),
                    np.asarray(ref.full_loglik(jnp.zeros(model.full_dim()))),
                    rtol=1e-8)
        return
    with pytest.raises(exc):
        ResponseNNGP(_SMALL, np.ones(60), **args)
    if exc is TypeError:  # the reference raises the same
        with pytest.raises(TypeError):
            JaxResponseNNGP(_SMALL, np.ones(60), m=5, noise="heterogeneous")


def test_cuda_instance_m_takes_the_smallest_built_m():
    """Any m >= 1 runs on the card: up to 20 on the smallest built instance
    M >= m, above it (21 and 25 among them) on the rolled instance with
    arrays for 32, above 32 (33 and 40 among them) on the large-m instance,
    sized by m itself; below 1 it raises and names the bound."""
    want = {**{m: 7 for m in range(1, 8)}, **{m: 10 for m in range(8, 11)},
            **{m: 15 for m in range(11, 16)}, **{m: 20 for m in range(16, 21)},
            **{m: 32 for m in range(21, 33)}}
    assert {m: cuda_instance_m(m) for m in range(1, 33)} == want
    assert {m: cuda_instance_m(m) for m in (33, 40, 64)} == {33: 33, 40: 40, 64: 64}
    for m in (0, -1):
        with pytest.raises(ValueError, match="m >= 1"):
            cuda_instance_m(m)


def test_ctypes_signatures_match_the_c_entries():
    """Every C entry of csrc/*.cu is bound with one ctypes type per
    parameter, in order: a pointer for each pointer, an int for each int
    (a pointer passed as an int would be cut to 32 bits)."""
    entries = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "pynngp_tpu_torch", "csrc", "*.cu"))):
        with open(path) as fh:
            for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', fh.read()):
                entries[name] = ["p" if "*" in a else "i" for a in params.split(",")]
    assert set(entries) == set(_build._SIGNATURES)
    for name, kinds in entries.items():
        bound = ["p" if t is ctypes.c_void_p else "i" for t in _build._SIGNATURES[name]]
        assert bound == kinds, name


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        # on a card the model builds; the kernels are tested in test_torch_cuda
        ResponseNNGP(_SMALL, np.ones(60), m=7, device="cuda")
        return
    with pytest.raises(RuntimeError):
        ResponseNNGP(_SMALL, np.ones(60), m=7, device="cuda")


def test_port_sources_import_no_jax():
    """No module of the port (nor chip_smoke.py, nor the port's examples)
    imports jax, optax or the reference package; the port's modules import
    no scikit-learn either (the image example reads its bundled photograph
    where it is installed)."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    paths += glob.glob(os.path.join(ROOT, "examples", "torch_*.py"))
    for dirpath, _, files in os.walk(os.path.join(ROOT, "pynngp_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    names = {os.path.relpath(p, ROOT) for p in paths}
    assert {"pynngp_tpu_torch/predict.py", "pynngp_tpu_torch/models/seq.py",
            "pynngp_tpu_torch/smoke.py", "examples/torch_spatial_regression.py",
            "examples/torch_image_kriging.py"} <= names
    for path in paths:
        with open(path) as fh:
            src = fh.read()
        bad_imports = ["import jax", "from jax", "import optax", "from pynngp_tpu.",
                       "import pynngp_tpu\n", "from pynngp_tpu import"]
        if not os.path.relpath(path, ROOT).startswith("examples"):
            bad_imports += ["import sklearn", "from sklearn"]
        for bad in bad_imports:
            assert bad not in src, (path, bad)
