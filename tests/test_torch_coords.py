"""The coords table layout of the port (coordinate planes, every distance
recomputed) against the reference's coords ``LaneCache`` and its Pallas
kernels in interpret mode, in float64, and the layout rule of the models.

The reference rounds the centred coordinates to float32 in either dtype
(``pallas_bf.py:247-248``), and so does the port: both then recompute the
distances in float64 from the same float32 values, so the kernels' plain
versions agree with the Pallas bodies to rounding, rtol 1e-8.  Parameters are
exact in float32 (phi, alpha, jitter = 2^-20, nu), because the reference's
``_params_vec`` rounds them through float32.  The general-nu cases run at
n = 300, m = 6: interpret mode with the Bessel series is slow."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu import kernels as jkernels
from pynngp_tpu import priors as jpriors
from pynngp_tpu import vecchia as jvecchia
from pynngp_tpu.models.response import ResponseNNGP as JaxResponseNNGP
from pynngp_tpu.ops import pallas_bf as pb
from pynngp_tpu_torch import convert, kernels, priors, vecchia
from pynngp_tpu_torch.distance import Euclidean
from pynngp_tpu_torch.models.latent import LatentNNGP
from pynngp_tpu_torch.models.response import ResponseNNGP
from pynngp_tpu_torch.ops import bf as bops
from pynngp_tpu_torch.ops import diff_suffstats as dops
from pynngp_tpu_torch.ops import site_tables
from pynngp_tpu_torch.ops import suffstats as fops
from pynngp_tpu_torch.ops.site_tables import (
    choose_layout,
    make_site_tables,
    unpack_distances,
    with_children,
)

JITTER = 2.0**-20
PHIS = (0.25, 0.125)  # C = 2 chains
ALPHAS = (0.125, 0.0625)
UTM = np.array([5.4e6, 3.1e6])  # the offset of tests/test_pallas_coords.py:97-123
FAMILIES = [
    (jkernels.SqExp(), kernels.SqExp()),
    (jkernels.Exponential(), kernels.Exponential()),
    (jkernels.Matern(nu=1.5), kernels.Matern(nu=1.5)),
    (jkernels.Spherical(), kernels.Spherical()),
]
_IDS = [repr(k[1]) for k in FAMILIES]
NU_A, NU_B = float(np.float32(0.8)), float(np.float32(1.7))
NU_CASES = {
    "sampled": (jkernels.Matern(), kernels.Matern(), (NU_A, NU_B)),
    "static": (jkernels.Matern(nu=NU_A), kernels.Matern(nu=NU_A), None),
}


def _problem(n, m, seed, offset=0.0):
    """Both packages' coords tables over the same sites, in float64."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2)) + offset
    y = rng.standard_normal(n)
    jdata, jtab = jvecchia.make_vecchia_data(coords, m, precompute_distances=False)
    cache = pb.make_lane_cache(jdata, dtype=jnp.float64, layout="coords",
                               coords_host=coords[jtab.order], nn_idx_host=jtab.nn_idx)
    data, tab = vecchia.make_vecchia_data(coords, m, dtype=torch.float64,
                                          precompute_distances=False, device="cpu")
    np.testing.assert_array_equal(tab.order, jtab.order)
    tables = make_site_tables(data, dtype=torch.float64, layout="coords",
                              coords_host=coords[tab.order], device="cpu")
    y_ord = y[tab.order]
    return {"n": n, "m": m, "cache": cache, "tables": tables,
            "y_jax": jnp.asarray(y_ord, jnp.float64), "y": torch.as_tensor(y_ord)}


@pytest.fixture(scope="module")
def problem():
    return _problem(1500, 7, seed=3)


@pytest.fixture(scope="module")
def nu_problem():
    return _problem(300, 6, seed=5)


# ---- tables ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("offset", [0.0, 1.0], ids=["unit", "utm"])
def test_coords_site_tables_match_lane_cache(dtype, offset):
    """make_site_tables(layout="coords") equals the reference's coords lane
    cache carried across by convert.site_tables_from_lane_cache, bit for bit,
    in either dtype and with a UTM-style offset: the centring happens in
    float64 before the rounding to float32."""
    rng = np.random.default_rng(9)
    n, m = 800, 6
    coords = rng.uniform(size=(n, 2)) + offset * UTM
    jdata, jtab = jvecchia.make_vecchia_data(coords, m, precompute_distances=False)
    cache = pb.make_lane_cache(jdata, dtype=getattr(jnp, dtype), layout="coords",
                               coords_host=coords[jtab.order])
    want = convert.site_tables_from_lane_cache(
        np.asarray(cache.tab_a), np.asarray(cache.tab_b), np.asarray(cache.nn_idx),
        n, layout="coords")
    data, tab = vecchia.make_vecchia_data(coords, m, precompute_distances=False, device="cpu")
    got = make_site_tables(data, dtype=getattr(torch, dtype), layout="coords",
                           coords_host=coords[tab.order], device="cpu")
    assert got.layout == want.layout == "coords" and got.dim == 2
    assert got.tab_a.shape == (2, got.n_pad) and got.tab_b.shape == (2 * m, got.n_pad)
    for name in ("tab_a", "tab_b", "nn_idx"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.is_contiguous()
        assert torch.equal(a, b), name
    # float32 values whatever the dtype; centred, so no offset survives
    assert torch.equal(got.tab_b, got.tab_b.float().to(got.dtype))
    assert float(got.tab_a.abs().max()) < 1.0
    # the distances are those of the sites to within float32 rounding
    d_in, _ = unpack_distances(got)
    pts = coords[tab.order]
    exact = np.sqrt(((pts[:, None, :] - pts[tab.nn_idx]) ** 2).sum(-1))
    np.testing.assert_allclose(d_in[:n].double().numpy(), exact, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_coords_site_tables_in_four_dimensions_match_lane_cache(dtype):
    """d = 4: make_site_tables(layout="coords") takes any coordinate
    dimension, as the reference's coords lane cache does, and the two agree
    bit for bit: (4, n_pad) own and (4 m, n_pad) neighbor planes."""
    rng = np.random.default_rng(19)
    n, m = 400, 7
    coords = rng.uniform(size=(n, 4))
    jdata, jtab = jvecchia.make_vecchia_data(coords, m, precompute_distances=False)
    cache = pb.make_lane_cache(jdata, dtype=getattr(jnp, dtype), layout="coords",
                               coords_host=coords[jtab.order])
    want = convert.site_tables_from_lane_cache(
        np.asarray(cache.tab_a), np.asarray(cache.tab_b), np.asarray(cache.nn_idx),
        n, layout="coords")
    data, tab = vecchia.make_vecchia_data(coords, m, precompute_distances=False, device="cpu")
    got = make_site_tables(data, dtype=getattr(torch, dtype), layout="coords",
                           coords_host=coords[tab.order], device="cpu")
    assert got.dim == 4 and got.tab_b.shape == (4 * m, got.n_pad)
    for name in ("tab_a", "tab_b", "nn_idx"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    d_in, _ = unpack_distances(got)
    pts = coords[tab.order]
    exact = np.sqrt(((pts[:, None, :] - pts[tab.nn_idx]) ** 2).sum(-1))
    np.testing.assert_allclose(d_in[:n].double().numpy(), exact, atol=1e-6)


def test_convert_refuses_a_cache_over_other_sites(problem):
    c = problem["cache"]
    with pytest.raises(ValueError, match="coords-layout"):
        convert.site_tables_from_lane_cache(np.asarray(c.tab_a), np.asarray(c.tab_b),
                                            np.asarray(c.nn_idx), 1000, layout="coords")
    with pytest.raises(ValueError, match="layout"):
        convert.site_tables_from_lane_cache(np.asarray(c.tab_a), np.asarray(c.tab_b),
                                            np.asarray(c.nn_idx), 1500, layout="lanes")


# ---- the kernels' plain versions against the Pallas coords branch -----------

@pytest.mark.parametrize("fam", FAMILIES, ids=_IDS)
def test_coords_suffstats_and_bf_match_pallas(problem, fam):
    """Kernels 1 and 3 on the coords layout: (logdet, quad, F, r) against
    pallas_suffstats and (B, F) against pallas_bf on the reference's coords
    cache, rtol 1e-8 (B also atol 1e-12)."""
    jkern, kern = fam
    p, n = problem, problem["n"]
    phi = torch.tensor(PHIS, dtype=torch.float64)
    alpha = torch.tensor(ALPHAS, dtype=torch.float64)
    before = (fops.COUNT_COORDS.plain, bops.COUNT_COORDS.plain)
    logdet, quad, f, r = fops.suffstats(kern, p["tables"], phi, alpha, p["y"], JITTER)
    b, f3 = bops.bf(kern, p["tables"], phi, alpha, JITTER)
    assert (fops.COUNT_COORDS.plain, bops.COUNT_COORDS.plain) == (before[0] + 1,
                                                                  before[1] + 1)
    for c in range(len(PHIS)):
        params = {"phi": jnp.float64(PHIS[c])}
        ld_j, q_j, f_j, r_j = pb.pallas_suffstats(
            jkern, params, p["cache"], p["y_jax"], jnp.float64(ALPHAS[c]), jitter=JITTER)
        np.testing.assert_allclose(float(logdet[c]), float(ld_j), rtol=1e-8)
        np.testing.assert_allclose(float(quad[c]), float(q_j), rtol=1e-8)
        np.testing.assert_allclose(f[c, :n].numpy(), np.asarray(f_j).reshape(-1)[:n],
                                   rtol=1e-8)
        np.testing.assert_allclose(r[c, :n].numpy(), np.asarray(r_j).reshape(-1)[:n],
                                   rtol=1e-8, atol=1e-10)
        b_j, fb_j = pb.pallas_bf(jkern, params, p["cache"], jnp.float64(ALPHAS[c]),
                                 jitter=JITTER)
        np.testing.assert_allclose(b[c].numpy(), np.asarray(b_j), rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(f3[c].numpy(), np.asarray(fb_j), rtol=1e-8)


@pytest.mark.parametrize("y_grad", [False, True], ids=["y_data", "y_grad"])
@pytest.mark.parametrize("fam", FAMILIES[:2], ids=_IDS[:2])
def test_coords_value_and_grad_match_jax(problem, fam, y_grad):
    """Kernel 2 on the coords layout, and with y_grad its EMIT_Y outputs
    through the dy gather: (logdet, quad) and the gradient in (phi, alpha)
    and y against jax.grad of make_diff_suffstats on the coords cache (the
    coords branch of _grad_kernel in interpret mode), rtol 1e-8; dy also
    atol 1e-10 of its largest entry."""
    jkern, kern = fam
    p = problem
    suff = pb.make_diff_suffstats(jkern, p["cache"], jitter=JITTER, y_grad=y_grad)

    def scalar(phi, alpha, y):
        ld, q = suff(phi, alpha, y)
        return 0.7 * ld + 1.3 * q, (ld, q)

    vg = jax.jit(jax.value_and_grad(scalar, argnums=(0, 1, 2), has_aux=True))
    tables = with_children(p["tables"])
    leaf = lambda v: torch.tensor(v, dtype=torch.float64, requires_grad=True)
    phi, alpha = leaf(PHIS), leaf(ALPHAS)
    y = p["y"].clone().requires_grad_(y_grad)
    count = dops.COUNT_Y_COORDS if y_grad else dops.COUNT_COORDS
    before = count.plain
    ld, q = dops.diff_suffstats(kern, tables, phi, alpha, y, JITTER)
    assert count.plain == before + 1
    leaves = (phi, alpha) + ((y,) if y_grad else ())
    for c in range(len(PHIS)):
        grads = torch.autograd.grad((0.7 * ld + 1.3 * q)[c], leaves, retain_graph=True)
        (_, (ld_j, q_j)), (gp_j, ga_j, gy_j) = vg(
            jnp.float64(PHIS[c]), jnp.float64(ALPHAS[c]), p["y_jax"])
        np.testing.assert_allclose(float(ld[c]), float(ld_j), rtol=1e-8)
        np.testing.assert_allclose(float(q[c]), float(q_j), rtol=1e-8)
        np.testing.assert_allclose(float(grads[0][c]), float(gp_j), rtol=1e-8)
        np.testing.assert_allclose(float(grads[1][c]), float(ga_j), rtol=1e-8)
        if y_grad:
            gy_j = np.asarray(gy_j)
            np.testing.assert_allclose(grads[2].numpy(), gy_j, rtol=1e-8,
                                       atol=1e-10 * np.abs(gy_j).max())


@pytest.mark.parametrize("case", list(NU_CASES))
def test_coords_general_nu_suffstats_and_bf_match_pallas(nu_problem, case):
    """Kernels 1 and 3 with the general-nu Matern on the coords layout,
    sampled and static nu, against the Pallas bodies, rtol 1e-8."""
    jkern, kern, nus = NU_CASES[case]
    p, n = nu_problem, nu_problem["n"]
    phi = torch.tensor(PHIS, dtype=torch.float64)
    alpha = torch.tensor(ALPHAS, dtype=torch.float64)
    nu_t = None if nus is None else torch.tensor(nus, dtype=torch.float64)
    before = (fops.COUNT_NU_COORDS.plain, bops.COUNT_NU_COORDS.plain)
    logdet, quad, f, _ = fops.suffstats(kern, p["tables"], phi, alpha, p["y"], JITTER,
                                        nu_t)
    b, f3 = bops.bf(kern, p["tables"], phi, alpha, JITTER, nu_t)
    assert (fops.COUNT_NU_COORDS.plain, bops.COUNT_NU_COORDS.plain) == (before[0] + 1,
                                                                        before[1] + 1)
    for c in range(len(PHIS)):
        params = {"phi": jnp.float64(PHIS[c])}
        if nus is not None:
            params["nu"] = jnp.float64(nus[c])
        ld_j, q_j, f_j, _ = pb.pallas_suffstats(
            jkern, params, p["cache"], p["y_jax"], jnp.float64(ALPHAS[c]), jitter=JITTER)
        np.testing.assert_allclose(float(logdet[c]), float(ld_j), rtol=1e-8)
        np.testing.assert_allclose(float(quad[c]), float(q_j), rtol=1e-8)
        np.testing.assert_allclose(f[c, :n].numpy(), np.asarray(f_j).reshape(-1)[:n],
                                   rtol=1e-8)
        b_j, fb_j = pb.pallas_bf(jkern, params, p["cache"], jnp.float64(ALPHAS[c]),
                                 jitter=JITTER)
        np.testing.assert_allclose(b[c].numpy(), np.asarray(b_j), rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(f3[c].numpy(), np.asarray(fb_j), rtol=1e-8)


@pytest.mark.parametrize("y_grad", [False, True], ids=["y_data", "y_grad"])
def test_coords_sampled_nu_value_and_grad_match_jax(nu_problem, y_grad):
    """Kernel 2's general-nu instances on the coords layout, with the nu
    sums and, with y_grad, the y cotangent, against jax.grad of the
    reference's suff_nu on the coords cache, rtol 1e-8."""
    jkern, kern = jkernels.Matern(), kernels.Matern()
    p = nu_problem
    suff = pb.make_diff_suffstats(jkern, p["cache"], jitter=JITTER, y_grad=y_grad)

    def scalar(phi, alpha, y, nu):
        ld, q = suff(phi, alpha, y, nu)
        return 0.7 * ld + 1.3 * q, (ld, q)

    vg = jax.jit(jax.value_and_grad(scalar, argnums=(0, 1, 2, 3), has_aux=True))
    tables = with_children(p["tables"])
    leaf = lambda v: torch.tensor(v, dtype=torch.float64, requires_grad=True)
    phi, alpha, nu = leaf(PHIS), leaf(ALPHAS), leaf([NU_A, NU_B])
    y = p["y"].clone().requires_grad_(y_grad)
    count = dops.COUNT_Y_NU_COORDS if y_grad else dops.COUNT_NU_COORDS
    before = count.plain
    ld, q = dops.diff_suffstats(kern, tables, phi, alpha, y, JITTER, nu)
    assert count.plain == before + 1
    leaves = (phi, alpha, nu) + ((y,) if y_grad else ())
    for c, v in enumerate((NU_A, NU_B)):
        grads = torch.autograd.grad((0.7 * ld + 1.3 * q)[c], leaves, retain_graph=True)
        (_, (ld_j, q_j)), (gp_j, ga_j, gy_j, gn_j) = vg(
            jnp.float64(PHIS[c]), jnp.float64(ALPHAS[c]), p["y_jax"], jnp.float64(v))
        np.testing.assert_allclose(float(ld[c]), float(ld_j), rtol=1e-8)
        np.testing.assert_allclose(float(q[c]), float(q_j), rtol=1e-8)
        np.testing.assert_allclose(float(grads[0][c]), float(gp_j), rtol=1e-8)
        np.testing.assert_allclose(float(grads[1][c]), float(ga_j), rtol=1e-8)
        np.testing.assert_allclose(float(grads[2][c]), float(gn_j), rtol=1e-8)
        if y_grad:
            gy_j = np.asarray(gy_j)
            np.testing.assert_allclose(grads[3].numpy(), gy_j, rtol=1e-8,
                                       atol=1e-10 * np.abs(gy_j).max())


# ---- the response model on the coords layout -------------------------------

def test_response_model_on_coords_matches_reference():
    """ResponseNNGP(lane_layout="coords") against the reference's Pallas
    backend on the coords layout, float64, n = 600: the log-likelihood
    without gradient (kernel 1's plain version) and the log-posterior's value
    and gradient (kernel 2's), rtol 1e-8 (the gradient's logit-phi entry, a
    difference of terms a thousand times its size, atol 1e-8 of the largest
    entry).  At u = 0 the point is exact in float32: phi the midpoint 0.3125
    of its prior, alpha = 1."""
    rng = np.random.default_rng(12)
    n = 600
    coords = rng.uniform(size=(n, 2))
    y = np.sin(6.0 * coords[:, 0]) + 0.3 * rng.standard_normal(n)
    kwargs = dict(kernel="sqexp", m=6, jitter=2.0**-20, lane_layout="coords")
    jm = JaxResponseNNGP(coords, y, backend="pallas", dtype=jnp.float64,
                         priors={"phi": jpriors.Uniform(0.0625, 0.5625)}, **kwargs)
    tm = ResponseNNGP(coords, y, device="cpu", dtype=torch.float64,
                      priors={"phi": priors.Uniform(0.0625, 0.5625)}, **kwargs)
    assert tm.lane_layout == "coords" and tm.tables.layout == "coords"
    u = np.zeros(3)
    with torch.no_grad():
        before = fops.COUNT_COORDS.plain
        ll = tm.full_loglik(torch.tensor(u)[None])
        assert fops.COUNT_COORDS.plain == before + 1
    np.testing.assert_allclose(ll[0].item(), float(jm.full_loglik(jnp.asarray(u))),
                               rtol=1e-8)
    jv, jg = jax.value_and_grad(jm.full_logpost)(jnp.asarray(u))
    tv, tg = tm.full_value_and_grad(torch.tensor(u)[None])
    np.testing.assert_allclose(tv[0].item(), float(jv), rtol=1e-8)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg[0].numpy(), jg, rtol=1e-8, atol=1e-8 * np.abs(jg).max())


def test_response_model_on_coords_in_four_dimensions_matches_reference():
    """d = 4 on the coords layout (the port's kernels read the coordinates
    from the fourth on where they use them; the plain versions take any d):
    ResponseNNGP(lane_layout="coords") against the reference's Pallas coords
    branch, n = 400, m = 7, the log-likelihood and the log-posterior's value
    and gradient, rtol 1e-8 (the gradient also atol 1e-8 of its largest
    entry), at a point exact in float32."""
    rng = np.random.default_rng(14)
    n = 400
    coords = rng.uniform(size=(n, 4))
    y = np.sin(4.0 * coords[:, 0] + 2.0 * coords[:, 3]) + 0.3 * rng.standard_normal(n)
    kwargs = dict(kernel="exponential", m=7, jitter=2.0**-20, lane_layout="coords")
    jm = JaxResponseNNGP(coords, y, backend="pallas", dtype=jnp.float64,
                         priors={"phi": jpriors.Uniform(0.0625, 0.5625)}, **kwargs)
    tm = ResponseNNGP(coords, y, device="cpu", dtype=torch.float64,
                      priors={"phi": priors.Uniform(0.0625, 0.5625)}, **kwargs)
    assert tm.tables.layout == "coords" and tm.tables.dim == 4
    u = np.array([0.2, 0.0, 0.2])
    with torch.no_grad():
        ll = tm.full_loglik(torch.tensor(u)[None])
    np.testing.assert_allclose(ll[0].item(), float(jm.full_loglik(jnp.asarray(u))),
                               rtol=1e-8)
    jv, jg = jax.value_and_grad(jm.full_logpost)(jnp.asarray(u))
    tv, tg = tm.full_value_and_grad(torch.tensor(u)[None])
    np.testing.assert_allclose(tv[0].item(), float(jv), rtol=1e-8)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg[0].numpy(), jg, rtol=1e-8, atol=1e-8 * np.abs(jg).max())


# ---- the layout rule and the distance tables -------------------------------

def test_auto_rule_on_either_side_of_the_threshold():
    """"auto" is dist at and below COORDS_LAYOUT_MIN_SITES sites and coords
    above; coords needs the Euclidean metric and falls back to dist without
    it (the reference's _coords_layout condition); any other name raises."""
    t = site_tables.COORDS_LAYOUT_MIN_SITES
    assert choose_layout("auto", t) == "dist"
    assert choose_layout("auto", t + 1) == "coords"
    assert choose_layout("auto", t + 1, euclidean=False) == "dist"
    assert choose_layout("coords", 10) == "coords"
    assert choose_layout("coords", 10, euclidean=False) == "dist"
    assert choose_layout("dist", t + 1) == "dist"
    with pytest.raises(ValueError, match="lane_layout"):
        choose_layout("lanes", 10)


def test_models_choose_the_layout_by_n(monkeypatch):
    """Both models take the rule's layout: the response model by default and
    the latent model always, with the threshold moved to 100 sites."""
    monkeypatch.setattr(site_tables, "COORDS_LAYOUT_MIN_SITES", 100)
    rng = np.random.default_rng(4)
    for n, want in ((100, "dist"), (101, "coords")):
        coords = rng.uniform(size=(n, 2))
        y = rng.standard_normal(n)
        for model in (ResponseNNGP(coords, y, m=5, device="cpu"),
                      LatentNNGP(coords, y, m=5, device="cpu")):
            assert model.lane_layout == model.tables.layout == want
    assert ResponseNNGP(coords, y, m=5, lane_layout="dist",
                        device="cpu").tables.layout == "dist"


def test_the_coords_path_builds_no_pair_distance_table(monkeypatch):
    """precompute_distances=False leaves both distance tables None, and on
    the coords layout neither model makes an (n, m, m) array: the one routine
    that makes it, Euclidean.pairwise_np, is made to raise."""
    rng = np.random.default_rng(6)
    coords = rng.uniform(size=(150, 2))
    y = rng.standard_normal(150)
    data, _ = vecchia.make_vecchia_data(coords, 5, precompute_distances=False, device="cpu")
    assert data.nn_dist is None and data.nn_cross_dist is None

    def refuse(*args, **kwargs):
        raise AssertionError("an (n, m, m) distance table was built")

    monkeypatch.setattr(Euclidean, "pairwise_np", refuse)
    monkeypatch.setattr(site_tables, "COORDS_LAYOUT_MIN_SITES", 100)
    for model in (ResponseNNGP(coords, y, m=5, device="cpu"),
                  ResponseNNGP(coords, y, m=5, lane_layout="coords", device="cpu"),
                  LatentNNGP(coords, y, m=5, device="cpu")):
        assert model.tables.layout == "coords"
    with pytest.raises(AssertionError, match="distance table"):
        ResponseNNGP(coords, y, m=5, lane_layout="dist", device="cpu")


def test_latent_dist_layout_without_precomputed_distances():
    """LatentNNGP(precompute_distances=False) below the threshold takes the
    dist layout and computes its tables from the ordered coordinates: the
    same tables as with the precomputed distances, to rounding."""
    rng = np.random.default_rng(7)
    coords = rng.uniform(size=(120, 2))
    y = rng.standard_normal(120)
    a = LatentNNGP(coords, y, m=5, device="cpu", dtype=torch.float64)
    b = LatentNNGP(coords, y, m=5, device="cpu", dtype=torch.float64,
                   precompute_distances=False)
    assert a.tables.layout == b.tables.layout == "dist"
    torch.testing.assert_close(a.tables.tab_a, b.tables.tab_a, rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(a.tables.tab_b, b.tables.tab_b, rtol=1e-12, atol=1e-15)
