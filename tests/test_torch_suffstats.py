"""The port's forward Vecchia suffstats (kernel 1's plain version on CPU
tensors) against the reference's Pallas kernel in interpret mode, in
float64, and the port's batched B/F oracle against the dense numpy gold.

Parameters are exact in float32 (phi, alpha, jitter = 2^-20), because the
reference's ``_params_vec`` rounds them through float32; the port keeps
them in float64.  With identical tables, interpret-mode Pallas in float64
agrees with the XLA path to ~1e-10, so the port is held to rtol 1e-8.  The
general-nu Matern cases (sampled and static nu, through the Bessel K_nu) run
at n = 300, m = 6: interpret mode with the Bessel series is slow.  Their nu
is rounded to float32 for the same reason as phi and alpha."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu import kernels as jkernels
from pynngp_tpu import vecchia as jvecchia
from pynngp_tpu.gold import dense_gp
from pynngp_tpu.ops import pallas_bf as pb
from pynngp_tpu_torch import kernels, vecchia
from pynngp_tpu_torch.ops import suffstats as ops
from pynngp_tpu_torch.ops.site_tables import make_site_tables

JITTER = 2.0**-20
PHIS = (0.25, 0.125, 0.5)  # C = 3 chains
ALPHAS = (0.125, 0.25, 0.0625)
KERNELS = [
    (jkernels.SqExp(), kernels.SqExp()),
    (jkernels.Exponential(), kernels.Exponential()),
    (jkernels.Spherical(), kernels.Spherical()),
    (jkernels.Matern(nu=0.5), kernels.Matern(nu=0.5)),
    (jkernels.Matern(nu=1.5), kernels.Matern(nu=1.5)),
    (jkernels.Matern(nu=2.5), kernels.Matern(nu=2.5)),
]
_IDS = [repr(k[1]) for k in KERNELS]
NU_A, NU_B = float(np.float32(0.8)), float(np.float32(1.7))
# (reference kernel, port kernel, per-chain nu or None for a static nu)
NU_CASES = {
    "sampled": (jkernels.Matern(), kernels.Matern(), (NU_A, NU_B)),
    "static": (jkernels.Matern(nu=NU_A), kernels.Matern(nu=NU_A), None),
}


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(3)
    n, m = 1500, 7  # ragged: n pads to 1536 here, to 8192 in the lane cache
    coords = rng.uniform(size=(n, 2))
    y = rng.standard_normal(n)
    jdata, jtab = jvecchia.make_vecchia_data(coords, m)
    cache = pb.make_lane_cache(jdata, dtype=jnp.float64, layout="dist")
    y_ord = y[jtab.order]
    # the same float32 distance tables, held in float64
    data, tab = vecchia.make_vecchia_data(coords, m, dtype=torch.float32, device="cpu")
    tables = make_site_tables(data, dtype=torch.float64, device="cpu")
    return {"cache": cache, "y_jax": jnp.asarray(y_ord, jnp.float64),
            "tables": tables, "y": torch.as_tensor(y_ord), "n": n}


def _problem(n, m, seed):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2))
    y = rng.standard_normal(n)
    jdata, jtab = jvecchia.make_vecchia_data(coords, m)
    cache = pb.make_lane_cache(jdata, dtype=jnp.float64, layout="dist")
    y_ord = y[jtab.order]
    data, _ = vecchia.make_vecchia_data(coords, m, dtype=torch.float32, device="cpu")
    return {"cache": cache, "y_jax": jnp.asarray(y_ord, jnp.float64),
            "tables": make_site_tables(data, dtype=torch.float64, device="cpu"),
            "y": torch.as_tensor(y_ord), "n": n}


@pytest.fixture(scope="module")
def nu_problem():
    return _problem(300, 6, seed=5)


@pytest.mark.parametrize("case", list(NU_CASES))
def test_general_nu_suffstats_matches_pallas(nu_problem, case):
    """Kernel 1's plain version with the general-nu Matern against
    pallas_suffstats in interpret mode (the _matern_rho_general branch),
    float64, rtol 1e-8."""
    jkern, kern, nus = NU_CASES[case]
    p = nu_problem
    chains = 2
    nu_t = None if nus is None else torch.tensor(nus, dtype=torch.float64)
    logdet, quad, f, r = ops.suffstats(
        kern, p["tables"], torch.tensor(PHIS[:chains], dtype=torch.float64),
        torch.tensor(ALPHAS[:chains], dtype=torch.float64), p["y"], JITTER, nu_t)
    n = p["n"]
    for c in range(chains):
        params = {"phi": jnp.float64(PHIS[c])}
        if nus is not None:
            params["nu"] = jnp.float64(nus[c])
        ld_j, q_j, f_j, r_j = pb.pallas_suffstats(
            jkern, params, p["cache"], p["y_jax"], jnp.float64(ALPHAS[c]),
            jitter=JITTER)
        np.testing.assert_allclose(float(logdet[c]), float(ld_j), rtol=1e-8)
        np.testing.assert_allclose(float(quad[c]), float(q_j), rtol=1e-8)
        np.testing.assert_allclose(f[c, :n].numpy(),
                                   np.asarray(f_j).reshape(-1)[:n], rtol=1e-8)
        np.testing.assert_allclose(r[c, :n].numpy(),
                                   np.asarray(r_j).reshape(-1)[:n], rtol=1e-8,
                                   atol=1e-10)


def test_general_nu_counts_and_argument_checks(nu_problem):
    """The general family counts in COUNT_NU; a kernel that samples nu needs
    one, and a kernel that samples none refuses one."""
    t, y = nu_problem["tables"], nu_problem["y"]
    before = (ops.COUNT.plain, ops.COUNT_NU.plain, ops.COUNT_NU.launches)
    ops.suffstats(kernels.Matern(), t, 0.25, 0.125, y, JITTER, nu=1.25)
    assert (ops.COUNT.plain, ops.COUNT_NU.plain, ops.COUNT_NU.launches) == (
        before[0], before[1] + 1, before[2])
    with pytest.raises(ValueError, match="samples nu"):
        ops.suffstats(kernels.Matern(), t, 0.25, 0.125, y, JITTER)
    with pytest.raises(ValueError, match="takes no nu"):
        ops.suffstats(kernels.SqExp(), t, 0.25, 0.125, y, JITTER, nu=1.0)
    row = ops.params_array(0.25, 0.125, JITTER, 300, torch.float64,
                           nu=ops.kernel_nu(kernels.Matern(nu=NU_A)))
    assert row.shape == (1, 6) and float(row[0, 4]) == NU_A


def test_general_nu_vecchia_loglik_matches_dense_gold():
    """The batched oracle with a per-chain nu against the dense numpy gold
    (scipy's K_nu), rtol 1e-9."""
    rng = np.random.default_rng(17)
    n, m = 200, 5
    coords = rng.uniform(size=(n, 2))
    y = rng.standard_normal(n)
    data, tab = vecchia.make_vecchia_data(coords, m, dtype=torch.float64, device="cpu")
    y_ord = torch.as_tensor(y[tab.order])
    sigma2, phi, tau2 = 1.3, 0.2, 0.15
    nus = (0.8, 1.7)
    got = vecchia.vecchia_loglik(
        kernels.Matern(), {"phi": torch.tensor([phi, phi], dtype=torch.float64),
                           "nu": torch.tensor(nus, dtype=torch.float64)},
        data, y_ord, sigma2, alpha=tau2 / sigma2, jitter=0.0)
    for c, nu in enumerate(nus):
        want = dense_gp.vecchia_loglik_dense(
            y[tab.order], coords[tab.order], tab.nn_idx, tab.nn_mask, "matern",
            sigma2, phi, tau2, nu=nu)
        np.testing.assert_allclose(float(got[c]), want, rtol=1e-9)


@pytest.mark.parametrize("jkern,kern", KERNELS, ids=_IDS)
def test_suffstats_matches_pallas(problem, jkern, kern):
    run = jax.jit(lambda phi, alpha: pb.pallas_suffstats(
        jkern, {"phi": phi}, problem["cache"], problem["y_jax"], alpha,
        jitter=JITTER))
    logdet, quad, f, r = ops.suffstats(
        kern, problem["tables"], torch.tensor(PHIS, dtype=torch.float64),
        torch.tensor(ALPHAS, dtype=torch.float64), problem["y"], JITTER)
    n = problem["n"]
    assert logdet.shape == quad.shape == (3,)
    assert f.shape == r.shape == (3, problem["tables"].n_pad)
    for c, (phi, alpha) in enumerate(zip(PHIS, ALPHAS)):
        ld_j, q_j, f_j, r_j = run(jnp.float64(phi), jnp.float64(alpha))
        np.testing.assert_allclose(float(logdet[c]), float(ld_j), rtol=1e-8)
        np.testing.assert_allclose(float(quad[c]), float(q_j), rtol=1e-8)
        np.testing.assert_allclose(f[c, :n].numpy(),
                                   np.asarray(f_j).reshape(-1)[:n], rtol=1e-8)
        np.testing.assert_allclose(r[c, :n].numpy(),
                                   np.asarray(r_j).reshape(-1)[:n], rtol=1e-8,
                                   atol=1e-10)


def test_loglik_matches_pallas_loglik(problem):
    want = pb.pallas_loglik(jkernels.SqExp(), {"phi": jnp.float64(0.25)},
                            problem["cache"], problem["y_jax"], 1.5, 0.125,
                            jitter=JITTER)
    got = ops.loglik(kernels.SqExp(), problem["tables"],
                     torch.tensor([0.25], dtype=torch.float64), problem["y"],
                     1.5, 0.125, JITTER)
    np.testing.assert_allclose(float(got[0]), float(want), rtol=1e-8)


def test_plain_version_counts_and_cpu_route(problem):
    """CPU tensors go to the plain version and never count a launch."""
    before = (ops.COUNT.launches, ops.COUNT.plain)
    ops.suffstats(kernels.SqExp(), problem["tables"], 0.25, 0.125,
                  problem["y"], JITTER)
    assert ops.COUNT.launches == before[0]
    assert ops.COUNT.plain == before[1] + 1


@pytest.mark.parametrize("name,kern", [("sqexp", kernels.SqExp()),
                                       ("exponential", kernels.Exponential()),
                                       ("spherical", kernels.Spherical())])
def test_vecchia_loglik_matches_dense_gold(name, kern):
    rng = np.random.default_rng(17)
    n, m = 200, 5
    coords = rng.uniform(size=(n, 2))
    y = rng.standard_normal(n)
    data, tab = vecchia.make_vecchia_data(coords, m, dtype=torch.float64, device="cpu")
    y_ord = torch.as_tensor(y[tab.order])
    sigma2, phi, tau2 = 1.3, 0.2, 0.15
    got = vecchia.vecchia_loglik(kern, {"phi": phi}, data, y_ord, sigma2,
                                 alpha=tau2 / sigma2, jitter=0.0)
    want = dense_gp.vecchia_loglik_dense(
        y[tab.order], coords[tab.order], tab.nn_idx, tab.nn_mask, name,
        sigma2, phi, tau2)
    np.testing.assert_allclose(float(got), want, rtol=1e-10)


def test_plain_suffstats_matches_batched_bf():
    """Kernel 1's plain version (site tables, slot masks from the site
    index) equals the oracle built from the (n, m) neighbor table.  B.c
    and u.u are the same number reached by different solves: rtol 1e-8."""
    rng = np.random.default_rng(4)
    n, m = 400, 6
    coords = rng.uniform(size=(n, 2))
    y = rng.standard_normal(n)
    data, tab = vecchia.make_vecchia_data(coords, m, dtype=torch.float64, device="cpu")
    y_ord = torch.as_tensor(y[tab.order])
    kern = kernels.Matern(nu=1.5)
    b, f = vecchia.vecchia_bf(kern, {"phi": 0.3}, data, alpha=0.2, jitter=JITTER)
    ld, q, resid = vecchia.vecchia_suffstats(b, f, y_ord, data)
    tables = make_site_tables(data, dtype=torch.float64, device="cpu")
    ld2, q2, f2, r2 = ops.suffstats(kern, tables, 0.3, 0.2, y_ord, JITTER)
    np.testing.assert_allclose(float(ld2[0]), float(ld), rtol=1e-8)
    np.testing.assert_allclose(float(q2[0]), float(q), rtol=1e-8)
    np.testing.assert_allclose(f2[0, :n].numpy(), f.numpy(), rtol=1e-8)
    np.testing.assert_allclose(r2[0, :n].numpy(), resid.numpy(), rtol=1e-8,
                               atol=1e-10)


def _m20_problem(m, layout):
    """Both packages' tables (dist or coords) over the same 300 sites, y and
    per-site noise weights v in ordered site space, in float64."""
    rng = np.random.default_rng(12)
    n = 300
    coords = rng.uniform(size=(n, 2))
    y = rng.standard_normal(n)
    v = rng.uniform(0.25, 4.0, n)
    on_coords = layout == "coords"
    jdata, jtab = jvecchia.make_vecchia_data(coords, m, precompute_distances=not on_coords)
    cache = pb.make_lane_cache(jdata, dtype=jnp.float64, layout=layout,
                               coords_host=coords[jtab.order] if on_coords else None)
    data, tab = vecchia.make_vecchia_data(coords, m, dtype=torch.float32,
                                          precompute_distances=not on_coords, device="cpu")
    np.testing.assert_array_equal(tab.order, jtab.order)
    order = tab.order
    return {"n": n, "cache": cache,
            "tables": make_site_tables(data, dtype=torch.float64, layout=layout,
                                       coords_host=coords[order], device="cpu"),
            "y_jax": jnp.asarray(y[order]), "y": torch.as_tensor(y[order]),
            "v_jax": jnp.asarray(v[order]), "v": torch.as_tensor(v[order])}


@pytest.mark.parametrize("weighted", [False, True], ids=["homogeneous", "weights"])
@pytest.mark.parametrize("layout", ["dist", "coords"])
@pytest.mark.parametrize("m", [16, 20])
def test_m20_suffstats_matches_pallas(m, layout, weighted):
    """Kernel 1's plain version at m = 16 and 20 (the shapes of its M = 20
    instance) on both layouts, with and without noise weights, against
    pallas_suffstats in interpret mode: (logdet, quad, F, r), rtol 1e-8 (r
    also atol 1e-10)."""
    p = _m20_problem(m, layout)
    jkern, kern = KERNELS[0]  # sqexp, config 5's family
    n = p["n"]
    v, v_jax = (p["v"], p["v_jax"]) if weighted else (None, None)
    logdet, quad, f, r = ops.suffstats(
        kern, p["tables"], torch.tensor(PHIS, dtype=torch.float64),
        torch.tensor(ALPHAS, dtype=torch.float64), p["y"], JITTER, noise_v=v)
    run = jax.jit(lambda phi, alpha: pb.pallas_suffstats(
        jkern, {"phi": phi}, p["cache"], p["y_jax"], alpha, jitter=JITTER, noise_v=v_jax))
    for c, (phi, alpha) in enumerate(zip(PHIS, ALPHAS)):
        ld_j, q_j, f_j, r_j = run(jnp.float64(phi), jnp.float64(alpha))
        np.testing.assert_allclose(float(logdet[c]), float(ld_j), rtol=1e-8)
        np.testing.assert_allclose(float(quad[c]), float(q_j), rtol=1e-8)
        np.testing.assert_allclose(f[c, :n].numpy(), np.asarray(f_j).reshape(-1)[:n],
                                   rtol=1e-8)
        np.testing.assert_allclose(r[c, :n].numpy(), np.asarray(r_j).reshape(-1)[:n],
                                   rtol=1e-8, atol=1e-10)
