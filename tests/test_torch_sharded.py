"""The port's site and chain sharding (``pynngp_tpu_torch.parallel``, the
sharded kernel wrappers of ``ops/``) on the CPU, float64, n <= 600, m <= 8.

- Against the reference's sharded Pallas path in interpret mode
  (``make_sharded_diff_suffstats``, ``make_sharded_pallas_bf`` on a mesh of
  the conftest's virtual devices): value, gradient and B/F, rtol 1e-8.
- Against the port's own unsharded plain versions on meshes (1, 2), (1, 4)
  and (2, 2) of "cpu": every kernel's sums rtol 1e-10 and its per-site
  outputs exactly, the y cotangent included.
- The host tables (``pad_data_for_sharding``, ``shard_color_tables``,
  ``color_child_pairs(n_shards=)``) bit for bit, and
  ``make_sharded_chromatic`` against the reference's with the same normal
  draws, rtol 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from pynngp_tpu import kernels as jkernels
from pynngp_tpu import neighbors as jneighbors
from pynngp_tpu import vecchia as jvecchia
from pynngp_tpu.ops import pallas_bf as pb
from pynngp_tpu.parallel import sharded as jsharded
from pynngp_tpu_torch import kernels, neighbors, vecchia
from pynngp_tpu_torch.ops import bf as bops
from pynngp_tpu_torch.ops import diff_suffstats as dops
from pynngp_tpu_torch.ops import suffstats as fops
from pynngp_tpu_torch.ops.site_tables import (
    MAX_SITE_INDEX,
    chain_groups,
    make_site_tables,
    shard_site_tables,
    with_children,
)
from pynngp_tpu_torch.parallel import (
    make_mesh,
    make_sharded_bf,
    make_sharded_chromatic,
    make_sharded_loglik,
    pad_data_for_sharding,
    shard_color_tables,
    shard_vecchia_data,
)

JITTER = 2.0**-20
POINTS = ((0.25, 0.125), (0.5, 0.0625), (0.125, 0.25))  # (phi, alpha), C = 3
MESHES = [(1, 2), (1, 4), (2, 2)]
N, M = 600, 8


def _mesh(shape):
    return make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


def _jax_mesh(shape):
    devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    return JaxMesh(devs, axis_names=("chains", "sites"))


@pytest.fixture(scope="module", autouse=True)
def _single_torch_thread():
    """Loops of small tensor ops (the general-nu Bessel series above all):
    more intra-op threads buy nothing and, beside other test workers, cost
    a great deal."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(3)
    coords = rng.uniform(size=(N, 2))
    y = rng.standard_normal(N)
    data, tab = vecchia.make_vecchia_data(coords, M, dtype=torch.float64, device="cpu")
    # the reference's data keep float32 distances: the port's copy of them
    # for the comparison with its Pallas kernels
    jdata, _ = jvecchia.make_vecchia_data(coords, M)
    data32, _ = vecchia.make_vecchia_data(coords, M, dtype=torch.float32, device="cpu")
    return {"coords": coords, "data": data, "jdata": jdata, "data32": data32,
            "order": tab.order,
            "y": torch.as_tensor(y[tab.order]),
            "v": torch.as_tensor(rng.uniform(0.5, 2.0, N)),
            "x": torch.as_tensor(rng.standard_normal(N))}


def _leaf(vals):
    return torch.tensor(vals, dtype=torch.float64, requires_grad=True)


@pytest.mark.parametrize("hetero", [False, True], ids=["homogeneous", "hetero"])
def test_sharded_value_grad_and_bf_match_the_reference_pallas(problem, hetero):
    """(logdet, quad), their phi and alpha gradient and B/F of the port's
    sharded wrappers on a (1, 2) mesh against the reference's
    ``make_sharded_diff_suffstats`` and ``make_sharded_pallas_bf`` on a
    (1, 2) mesh of virtual devices (Pallas interpret mode), rtol 1e-8."""
    jkern, kern = jkernels.Exponential(), kernels.Exponential()
    jmesh, mesh = _jax_mesh((1, 2)), _mesh((1, 2))
    cache = pb.shard_lane_cache(
        pb.make_lane_cache(problem["jdata"], dtype=jnp.float64, layout="dist",
                           shards=2), jmesh)
    noise = problem["v"] if hetero else None
    jnoise = None if noise is None else jnp.asarray(noise.numpy())
    suff = pb.make_sharded_diff_suffstats(jkern, cache, jmesh, jitter=JITTER,
                                          noise_v=jnoise)
    vg = jax.jit(jax.value_and_grad(
        lambda ph, al, y: (lambda o: 0.7 * o[0] + 1.3 * o[1])(suff(ph, al, y)),
        argnums=(0, 1)))
    bf_ref = pb.make_sharded_pallas_bf(jkern, cache, jmesh, jitter=JITTER,
                                       noise_v=jnoise)
    tables = shard_site_tables(make_site_tables(problem["data32"], dtype=torch.float64,
                                                shards=2, device="cpu"), mesh)
    phi, alpha = _leaf([p for p, _ in POINTS]), _leaf([a for _, a in POINTS])
    ld, q = dops.diff_suffstats(kern, tables, phi, alpha, problem["y"], JITTER,
                                noise_v=noise)
    value = (0.7 * ld + 1.3 * q).detach()
    y_j = jnp.asarray(problem["y"].numpy())
    b, f = bops.bf(kern, tables, phi.detach(), alpha.detach(), JITTER, noise_v=noise)
    for c, (ph, al) in enumerate(POINTS):
        got_g = torch.autograd.grad(0.7 * ld[c] + 1.3 * q[c], (phi, alpha),
                                    retain_graph=True)
        want, (g_phi, g_alpha) = vg(ph, al, y_j)
        np.testing.assert_allclose(float(value[c]), float(want), rtol=1e-8)
        np.testing.assert_allclose([float(got_g[0][c]), float(got_g[1][c])],
                                   [float(g_phi), float(g_alpha)], rtol=1e-8)
        b_ref, f_ref = bf_ref({"phi": ph}, al)
        np.testing.assert_allclose(b[c].detach().numpy(), np.asarray(b_ref),
                                   rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(f[c].detach().numpy(), np.asarray(f_ref), rtol=1e-8)


CASES = {
    "sqexp_dist": (kernels.SqExp(), "dist", False),
    "exponential_coords_hetero": (kernels.Exponential(), "coords", True),
    "matern_nu_dist": (kernels.Matern(), "dist", False),
}


@pytest.fixture(scope="module")
def nu_problem():
    """A smaller problem for the general-nu Matern, whose plain version runs
    the Bessel series in eager PyTorch (n = 300, m = 6)."""
    rng = np.random.default_rng(4)
    coords = rng.uniform(size=(300, 2))
    data, tab = vecchia.make_vecchia_data(coords, 6, dtype=torch.float64, device="cpu")
    return {"coords": coords, "data": data, "order": tab.order, "n": 300,
            "y": torch.as_tensor(rng.standard_normal(300)[tab.order]),
            "v": torch.as_tensor(rng.uniform(0.5, 2.0, 300)),
            "x": torch.as_tensor(rng.standard_normal(300))}


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "1x4", "2x2"])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_wrappers_match_the_unsharded_plain_versions(problem, nu_problem, case,
                                                            shape):
    """Kernels 1, 2 (with the EMIT_Y planes and the y cotangent of a
    per-chain y) and 3 through the sharded wrappers against the same
    functions on the unsharded tables: sums and gradients rtol 1e-10, the
    per-site outputs exactly; the launches count under ``_sharded``."""
    kern, layout, hetero = CASES[case]
    if kern.samples_nu:
        problem = nu_problem
    n = problem.get("n", N)
    n_pad_shards = shape[1]
    full = with_children(make_site_tables(
        problem["data"], dtype=torch.float64, layout=layout,
        coords_host=problem["coords"][problem["order"]], shards=n_pad_shards, device="cpu"))
    sharded = shard_site_tables(full, _mesh(shape))
    assert sharded.n_pad == full.n_pad and sharded.cells[0][-1].reach == full.n_pad
    # one shard straddles n; at 4 shards of 256 the last holds padding only
    assert any(t.off < n < t.reach for t in sharded.cells[0])
    noise = problem["v"] if hetero else None
    nu = _leaf([0.8, 1.7, 1.2]) if kern.samples_nu else None
    phi, alpha = _leaf([p for p, _ in POINTS]), _leaf([a for _, a in POINTS])
    beta = _leaf([0.1, -0.2, 0.3])
    before = dops.COUNTS[fops.instance("vecchia_grad", kern, full, True, hetero,
                                       sharded=True)].plain
    outs = {}
    for name, tab in (("full", full), ("sharded", sharded)):
        y = problem["y"] - beta[:, None] * problem["x"]  # the residual y - x beta_c
        ld, q = dops.diff_suffstats(kern, tab, phi, alpha, y, JITTER, nu, noise)
        leaves = (phi, alpha, beta) + ((nu,) if nu is not None else ())
        grads = torch.autograd.grad((0.7 * ld + 1.3 * q).sum(), leaves)
        with torch.no_grad():
            k1 = fops.suffstats(kern, tab, phi, alpha, y, JITTER, nu, noise)
            _, b_y, rof = dops.value_and_grad_sums(kern, tab, phi, alpha, y, JITTER,
                                                   emit_y=True, nu=nu, noise_v=noise)
            bf = bops.bf_planes(kern, tab, phi, alpha, JITTER, nu, noise)
        outs[name] = dict(sums=torch.stack([ld, q, k1[0], k1[1]]), grads=grads,
                          site=(k1[2], k1[3], b_y, rof) + tuple(bf))
    got, want = outs["sharded"], outs["full"]
    np.testing.assert_allclose(got["sums"].detach().numpy(),
                               want["sums"].detach().numpy(), rtol=1e-10)
    for g, w in zip(got["grads"], want["grads"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10, atol=1e-12)
    if not kern.samples_nu:
        # the general-nu plain version's float64 Bessel series may round
        # differently in another batch; the closed forms give the same bits
        for g, w in zip(got["site"], want["site"]):
            assert torch.equal(g, w)
    else:
        for g, w in zip(got["site"], want["site"]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10, atol=1e-13)
    after = dops.COUNTS[fops.instance("vecchia_grad", kern, full, True, hetero,
                                      sharded=True)].plain
    assert after == before + 2 * shape[0] * shape[1]  # two EMIT_Y calls


def test_sharded_loglik_and_bf_functions(problem):
    """``shard_vecchia_data`` and the reference-named ``make_sharded_*``
    functions against the unsharded ``vecchia_loglik`` and ``vecchia_bf`` of
    the port, rtol 1e-10, on a (2, 2) mesh."""
    mesh = _mesh((2, 2))
    kern, data, y = kernels.Exponential(), problem["data"], problem["y"]
    tables, y_own, y_full, valid = shard_vecchia_data(data, mesh, y=y)
    assert y_own.shape == valid.shape == (tables.n_pad,) and int(valid.sum()) == N
    phi = torch.tensor([0.25, 0.5, 0.125], dtype=torch.float64)
    sigma2 = torch.tensor([1.1, 0.9, 1.3], dtype=torch.float64)
    alpha = torch.tensor([0.125, 0.0625, 0.25], dtype=torch.float64)
    got = make_sharded_loglik(kern, mesh, N, JITTER)(
        {"phi": phi}, sigma2, alpha, tables, y_own, y_full, valid)
    b, f = make_sharded_bf(kern, mesh, N, JITTER)({"phi": phi}, alpha, tables)
    for c in range(3):
        want = vecchia.vecchia_loglik(kern, {"phi": phi[c]}, data, y, sigma2[c],
                                      alpha=alpha[c], jitter=JITTER)
        np.testing.assert_allclose(float(got[c]), float(want), rtol=1e-10)
        b_w, f_w = vecchia.vecchia_bf(kern, {"phi": phi[c]}, data, alpha=alpha[c],
                                      jitter=JITTER)
        np.testing.assert_allclose(b[c].numpy(), b_w.numpy(), rtol=1e-10, atol=1e-13)
        np.testing.assert_allclose(f[c].numpy(), f_w.numpy(), rtol=1e-10)


@pytest.mark.parametrize("shards", [3, 4, 8])
def test_pad_data_for_sharding_is_the_references(shards):
    rng = np.random.default_rng(5)
    coords = rng.uniform(size=(205, 2))
    data, _ = vecchia.make_vecchia_data(coords, 9, dtype=torch.float64, device="cpu")
    jdata, _ = jvecchia.make_vecchia_data(coords, 9, dtype=jnp.float64)
    got, valid = pad_data_for_sharding(data, shards)
    want, jvalid = jsharded.pad_data_for_sharding(jdata, shards)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    for name in ("coords", "nn_idx", "nn_mask", "nn_dist", "nn_cross_dist"):
        a, b = getattr(got, name), getattr(want, name)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("shards", [1, 3, 4])
def test_color_tables_are_the_references(shards):
    """``shard_color_tables`` and ``color_child_pairs(n_shards=)`` bit for
    bit, on a real moral-graph colouring."""
    rng = np.random.default_rng(6)
    tab = neighbors.build_neighbor_table(rng.uniform(size=(300, 2)), 6, cache=False)
    colors = neighbors.color_moral_graph(tab.nn_idx, tab.nn_mask)
    for got, want in zip(shard_color_tables(colors, shards),
                         jsharded.shard_color_tables(colors, shards)):
        np.testing.assert_array_equal(got, want)
    ch = neighbors.build_children_table(tab.nn_idx, tab.nn_mask)
    sites, smask = neighbors.color_site_table(colors)
    for n_shards in (0, shards):
        got = neighbors.color_child_pairs(colors, sites, smask, ch.child_idx,
                                          ch.child_mask, n_shards=n_shards)
        want = jneighbors.color_child_pairs(colors, sites, smask, ch.child_idx,
                                            ch.child_mask, n_shards=n_shards)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(1, 2), (2, 4)], ids=["1x2", "2x4"])
def test_sharded_chromatic_matches_the_reference(shape):
    """The port's ``make_sharded_chromatic`` (chains batched, split over the
    mesh's chain rows) against the reference's on a mesh of virtual devices
    with the same standard normals, rtol 1e-10."""
    rng = np.random.default_rng(8)
    n, chains = 240, 3
    coords = rng.uniform(size=(n, 2))
    data, tab = vecchia.make_vecchia_data(coords, 6, dtype=torch.float64, device="cpu")
    ch = neighbors.build_children_table(tab.nn_idx, tab.nn_mask)
    colors = neighbors.color_moral_graph(tab.nn_idx, tab.nn_mask)
    n_colors = int(colors.max()) + 1
    csites, csmask = shard_color_tables(colors, shape[1])
    tables = make_site_tables(data, dtype=torch.float64, device="cpu")
    b, f = bops.bf_planes(kernels.Exponential(), tables,
                          torch.tensor([0.2, 0.3, 0.25], dtype=torch.float64), 0.0, 1e-6)
    b = b[:, :, :n]
    nbr = torch.as_tensor(tab.nn_idx.T.astype(np.int64))
    child_idx = torch.as_tensor(ch.child_idx.astype(np.int64))
    cmask = torch.as_tensor(ch.child_mask, dtype=torch.float64)
    slot = torch.as_tensor(ch.child_slot.astype(np.int64))
    b_child = b[:, slot, child_idx] * cmask  # B_{j, l} of child j at slot l
    fprec = 1.0 / f[:, :n]
    fp_child = fprec[:, child_idx] * cmask
    ytil = torch.as_tensor(rng.standard_normal((chains, n))) / 0.1
    v = 1.0 / (10.0 + fprec + (b_child * b_child * fp_child).sum(-1))
    sd = torch.sqrt(v)
    w = torch.as_tensor(rng.standard_normal((chains, n)))
    resid = w - (b * w[:, nbr]).sum(1)
    eps = torch.as_tensor(rng.standard_normal((chains, n)))
    got = make_sharded_chromatic(_mesh(shape), n_colors)(
        csites, csmask, w, resid, eps, child_idx, b_child, fp_child, v, sd, ytil, fprec)
    ref = jsharded.make_sharded_chromatic(_jax_mesh((1, shape[1])), n_colors)
    j = lambda t, c: jnp.asarray(t[c].numpy())
    for c in range(chains):
        want = ref(jnp.asarray(csites), jnp.asarray(csmask), j(w, c), j(resid, c),
                   j(eps, c), jnp.asarray(ch.child_idx), j(b_child, c), j(fp_child, c),
                   j(v, c), j(sd, c), j(ytil, c), j(fprec, c))
        np.testing.assert_allclose(got[c].numpy(), np.asarray(want), rtol=1e-10,
                                   atol=1e-12)
    assert not torch.equal(got, w)


def test_mesh_shapes_and_refusals(problem):
    assert make_mesh(2, 2, devices=["cpu"] * 4).shape == {"chains": 2, "sites": 2}
    assert make_mesh(2, devices=["cpu"] * 6).shape == {"chains": 2, "sites": 3}
    with pytest.raises(ValueError, match="mesh 2x2 != 3 devices"):
        make_mesh(2, 2, devices=["cpu"] * 3)
    assert chain_groups(5, 2) == [(0, slice(0, 3)), (1, slice(3, 5))]
    assert chain_groups(1, 2) == [(0, slice(0, 1))]
    # tables padded for 1 shard do not cut into 4 whole blocks
    with pytest.raises(ValueError, match="shards=4"):
        shard_site_tables(make_site_tables(problem["data"], device="cpu"), _mesh((1, 4)))
    # off and n ride the kernels' float32 params row: a launch whose global
    # site indices reach 2^24 is refused before it is made
    tables = make_site_tables(problem["data"], device="cpu")
    far = tables._replace(off=MAX_SITE_INDEX - tables.n_pad + 128)
    params = fops.params_array(0.25, 0.125, JITTER, N, torch.float32, off=far.off)
    with pytest.raises(ValueError, match="2\\^24"):
        fops.cuda_args(far, params)
    # a noise plane for a shard reaches past its last site
    shard = shard_site_tables(make_site_tables(problem["data"], shards=2, device="cpu"),
                              _mesh((1, 2))).cells[0][1]
    assert fops.noise_plane(shard, problem["v"]).shape == (shard.reach,)
