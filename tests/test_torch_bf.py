"""The port's kriging weights B and conditional variances F (kernel 3's plain
version on CPU tensors) against the reference's Pallas kernel in interpret
mode and its XLA ``vecchia_bf``, in float64.

Parameters are exact in float32 (phi, alpha, jitter = 2^-20), because the
reference's ``_params_vec`` rounds them through float32; the port keeps them
in float64.  Both packages factor the same float32 distance tables held in
float64, so B and F agree to rounding: rtol 1e-8 (atol 1e-12 on B, whose
small entries are differences of O(1) terms).  The general-nu Matern cases
run at n = 300, m = 6 with nu rounded to float32 like phi and alpha
(interpret mode with the Bessel series is slow)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu import kernels as jkernels
from pynngp_tpu import vecchia as jvecchia
from pynngp_tpu.ops import pallas_bf as pb
from pynngp_tpu_torch import convert, kernels, vecchia
from pynngp_tpu_torch.ops import bf as ops
from pynngp_tpu_torch.ops.site_tables import make_site_tables

JITTER = 2.0**-20
PHIS = (0.25, 0.125, 0.5)  # C = 3 chains
ALPHAS = {"nugget": (0.125, 0.25, 0.0625), "zero": (0.0, 0.0, 0.0)}
FAMILIES = {
    "exponential": (jkernels.Exponential(), kernels.Exponential()),
    "matern32": (jkernels.Matern(nu=1.5), kernels.Matern(nu=1.5)),
}


NU_A, NU_B = float(np.float32(0.8)), float(np.float32(1.7))
# (reference kernel, port kernel, per-chain nu or None for a static nu)
NU_CASES = {
    "sampled": (jkernels.Matern(), kernels.Matern(), (NU_A, NU_B)),
    "static": (jkernels.Matern(nu=NU_A), kernels.Matern(nu=NU_A), None),
}


def _problem(m):
    rng = np.random.default_rng(8)
    n = 300  # ragged: pads to 384 here, to 8192 in the lane cache
    coords = rng.uniform(size=(n, 2))
    jdata, jtab = jvecchia.make_vecchia_data(coords, m)
    cache = pb.make_lane_cache(jdata, dtype=jnp.float64, layout="dist")
    # the same float32 distance tables, held in float64
    jdata64 = jdata._replace(nn_dist=jnp.asarray(jdata.nn_dist, jnp.float64),
                             nn_cross_dist=jnp.asarray(jdata.nn_cross_dist,
                                                       jnp.float64))
    data, _ = vecchia.make_vecchia_data(coords, m, dtype=torch.float32, device="cpu")
    # both packages build the float32 tables from the same float64 distances:
    # a comparison of B below holds the factorizations, not the tables
    for name in ("nn_dist", "nn_cross_dist"):
        ref, got = np.asarray(getattr(jdata, name)), getattr(data, name)
        assert ref.dtype == got.dtype == np.float32 and np.array_equal(ref, got), name
    data64 = data._replace(coords=data.coords.double(),
                           nn_dist=data.nn_dist.astype(np.float64),
                           nn_cross_dist=data.nn_cross_dist.astype(np.float64))
    tables = make_site_tables(data, dtype=torch.float64, device="cpu")
    return {"n": n, "m": m, "cache": cache, "jdata": jdata64, "data": data64,
            "tables": tables, "w": rng.standard_normal((3, n))}


@pytest.fixture(scope="module", params=[5, 7], ids=["m5", "m7"])
def problem(request):
    return _problem(request.param)


def _port_bf(problem, kern, alphas):
    return ops.bf(kern, problem["tables"], torch.tensor(PHIS, dtype=torch.float64),
                  torch.tensor(alphas, dtype=torch.float64), JITTER)


@pytest.mark.parametrize("alphas", list(ALPHAS), ids=list(ALPHAS))
@pytest.mark.parametrize("family", list(FAMILIES), ids=list(FAMILIES))
def test_bf_matches_pallas_and_xla(problem, family, alphas):
    jkern, kern = FAMILIES[family]
    b, f = _port_bf(problem, kern, ALPHAS[alphas])
    n, m = problem["n"], problem["m"]
    assert b.shape == (3, n, m) and f.shape == (3, n)
    run = jax.jit(lambda phi, alpha: pb.pallas_bf(
        jkern, {"phi": phi}, problem["cache"], alpha, jitter=JITTER))
    for c, (phi, alpha) in enumerate(zip(PHIS, ALPHAS[alphas])):
        b_p, f_p = run(jnp.float64(phi), jnp.float64(alpha))
        b_x, f_x = jvecchia.vecchia_bf(jkern, {"phi": jnp.float64(phi)},
                                       problem["jdata"], alpha=alpha,
                                       jitter=JITTER)
        for b_j, f_j in ((b_p, f_p), (b_x, f_x)):
            np.testing.assert_allclose(b[c].numpy(), np.asarray(b_j), rtol=1e-8,
                                       atol=1e-12)
            np.testing.assert_allclose(f[c].numpy(), np.asarray(f_j), rtol=1e-8)


@pytest.fixture(scope="module")
def nu_problem():
    return _problem(6)


@pytest.mark.parametrize("alphas", list(ALPHAS), ids=list(ALPHAS))
@pytest.mark.parametrize("case", list(NU_CASES))
def test_general_nu_bf_matches_pallas(nu_problem, case, alphas):
    """Kernel 3's plain version with the general-nu Matern against pallas_bf
    in interpret mode (_bf_kernel reading nu), float64, rtol 1e-8 (B atol
    1e-12); the latent model's alpha = 0 among the cases."""
    jkern, kern, nus = NU_CASES[case]
    chains = 2
    nu_t = None if nus is None else torch.tensor(nus, dtype=torch.float64)
    before = (ops.COUNT.plain, ops.COUNT_NU.plain)
    b, f = ops.bf(kern, nu_problem["tables"],
                  torch.tensor(PHIS[:chains], dtype=torch.float64),
                  torch.tensor(ALPHAS[alphas][:chains], dtype=torch.float64),
                  JITTER, nu_t)
    assert (ops.COUNT.plain, ops.COUNT_NU.plain) == (before[0], before[1] + 1)
    assert b.shape == (chains, nu_problem["n"], 6)
    for c in range(chains):
        params = {"phi": jnp.float64(PHIS[c])}
        if nus is not None:
            params["nu"] = jnp.float64(nus[c])
        b_j, f_j = pb.pallas_bf(jkern, params, nu_problem["cache"],
                                ALPHAS[alphas][c], jitter=JITTER)
        np.testing.assert_allclose(b[c].numpy(), np.asarray(b_j), rtol=1e-8,
                                   atol=1e-12)
        np.testing.assert_allclose(f[c].numpy(), np.asarray(f_j), rtol=1e-8)


def test_general_nu_batched_oracle_equals_plain_version(nu_problem):
    """The row-major oracle with a per-chain nu (kernels.correlation, floor
    1e-12) equals kernel 3's plain version (fused_correlation, floor 1e-8)
    where no distance falls between the floors: rtol 1e-8."""
    kern = kernels.Matern()
    phi = torch.tensor(PHIS[:2], dtype=torch.float64)
    nu = torch.tensor((NU_A, NU_B), dtype=torch.float64)
    alpha = torch.tensor(ALPHAS["nugget"][:2], dtype=torch.float64)
    b, f = vecchia.vecchia_bf(kern, {"phi": phi, "nu": nu}, nu_problem["data"],
                              alpha=alpha, jitter=JITTER)
    b_k, f_k = ops.bf(kern, nu_problem["tables"], phi, alpha, JITTER, nu)
    np.testing.assert_allclose(b_k.numpy(), b.numpy(), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(f_k.numpy(), f.numpy(), rtol=1e-8)


def test_planes_layout_padding_and_counts(problem):
    """bf_planes is plane-major over n_pad sites; bf is a view of it; CPU
    tensors go to the plain version and never count a launch."""
    kern = kernels.Exponential()
    t = problem["tables"]
    before = (ops.COUNT.launches, ops.COUNT.plain)
    planes_b, planes_f = ops.bf_planes(kern, t, torch.tensor(PHIS), 0.125, JITTER)
    assert (ops.COUNT.launches, ops.COUNT.plain) == (before[0], before[1] + 1)
    assert planes_b.shape == (3, t.m, t.n_pad) and planes_b.is_contiguous()
    assert planes_f.shape == (3, t.n_pad)
    b, f = _port_bf(problem, kern, (0.125,) * 3)
    assert torch.equal(b, planes_b[:, :, :t.n].transpose(1, 2))
    assert torch.equal(f, planes_f[:, :t.n])
    assert b.untyped_storage().nbytes() == planes_b.untyped_storage().nbytes()
    # invalid slots (site <= slot) hold exactly 0
    for site in range(t.m):
        assert (planes_b[:, site:, site] == 0).all()


@pytest.mark.parametrize("jitter", [JITTER, 0.0], ids=["jitter", "nojitter"])
def test_padded_sites_are_b0_f1(problem, jitter):
    """Padded sites have all-zero tables: with alpha = 0 their system is the
    singular all-ones matrix.  The wrapper returns B = 0, F = 1 there and
    finite values everywhere, so log F and 1/F are safe over n_pad."""
    t = problem["tables"]
    assert t.n_pad > t.n
    b, f = ops.bf_planes(kernels.Exponential(), t, torch.tensor(PHIS), 0.0, jitter)
    assert (b[:, :, t.n:] == 0).all() and (f[:, t.n:] == 1).all()
    assert torch.isfinite(b).all() and torch.isfinite(f).all()
    assert (f > 0).all()


def test_plane_suffstats_matches_reference(problem):
    """logdet, quad and residuals of a per-chain w under plane-major B/F
    against the reference's vecchia_suffstats and the port's row-major one."""
    jkern, kern = FAMILIES["exponential"]
    t = problem["tables"]
    nbr = problem["data"].nn_idx.T.contiguous()
    planes_b, planes_f = ops.bf_planes(kern, t, torch.tensor(PHIS), 0.0, JITTER)
    w = torch.as_tensor(problem["w"])
    logdet, quad, resid = ops.plane_suffstats(planes_b, planes_f, w, nbr)
    b, f = _port_bf(problem, kern, ALPHAS["zero"])
    ld_r, q_r, r_r = vecchia.vecchia_suffstats(b, f, w, problem["data"])
    np.testing.assert_allclose(logdet.numpy(), ld_r.numpy(), rtol=1e-12)
    np.testing.assert_allclose(quad.numpy(), q_r.numpy(), rtol=1e-12)
    np.testing.assert_allclose(resid.numpy(), r_r.numpy(), rtol=1e-10, atol=1e-12)
    for c, phi in enumerate(PHIS):
        b_x, f_x = jvecchia.vecchia_bf(jkern, {"phi": jnp.float64(phi)},
                                       problem["jdata"], alpha=0.0, jitter=JITTER)
        ld_j, q_j, r_j = jvecchia.vecchia_suffstats(
            b_x, f_x, jnp.asarray(problem["w"][c]), problem["jdata"])
        np.testing.assert_allclose(float(logdet[c]), float(ld_j), rtol=1e-8)
        np.testing.assert_allclose(float(quad[c]), float(q_j), rtol=1e-8)
        np.testing.assert_allclose(resid[c].numpy(), np.asarray(r_j), rtol=1e-8,
                                   atol=1e-10)
    # a shared y broadcasts over the chains
    ld_s, q_s, _ = ops.plane_suffstats(planes_b, planes_f, w[0], nbr)
    assert ld_s.shape == (3,)
    np.testing.assert_allclose(float(q_s[0]), float(quad[0]), rtol=1e-12)


def test_batched_vecchia_bf_equals_per_chain(problem):
    """The port's row-major oracle with a chain axis equals its single-chain
    form, and the plain version of kernel 3 (slot masks from the site index)
    equals the oracle built from the (n, m) neighbor table."""
    kern = kernels.Matern(nu=1.5)
    data = problem["data"]
    alphas = ALPHAS["nugget"]
    b, f = vecchia.vecchia_bf(kern, {"phi": torch.tensor(PHIS)}, data,
                              alpha=torch.tensor(alphas), jitter=JITTER)
    assert b.shape == (3, problem["n"], problem["m"])
    for c, (phi, alpha) in enumerate(zip(PHIS, alphas)):
        b1, f1 = vecchia.vecchia_bf(kern, {"phi": phi}, data, alpha=alpha,
                                    jitter=JITTER)
        np.testing.assert_allclose(b[c].numpy(), b1.numpy(), rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(f[c].numpy(), f1.numpy(), rtol=1e-12)
    b_k, f_k = _port_bf(problem, kern, alphas)
    np.testing.assert_allclose(b_k.numpy(), b.numpy(), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(f_k.numpy(), f.numpy(), rtol=1e-8)


def test_bf_planes_from_rows_round_trip(problem):
    t = problem["tables"]
    planes_b, planes_f = ops.bf_planes(kernels.Exponential(), t,
                                       torch.tensor(PHIS), 0.0, JITTER)
    b, f = ops.bf(kernels.Exponential(), t, torch.tensor(PHIS), 0.0, JITTER)
    back_b, back_f = convert.bf_planes_from_rows(b.numpy(), f.numpy())
    assert torch.equal(back_b, planes_b) and torch.equal(back_f, planes_f)


# ---- m = 16 and 20: the M = 20 instance's shapes, both layouts, weights ----

def _m20_problem(m, layout):
    """Both packages' tables (dist or coords) over the same 300 sites, and
    per-site noise weights v in ordered site space, in float64."""
    rng = np.random.default_rng(11)
    n = 300
    coords = rng.uniform(size=(n, 2))
    v = rng.uniform(0.25, 4.0, n)
    on_coords = layout == "coords"
    jdata, jtab = jvecchia.make_vecchia_data(coords, m, precompute_distances=not on_coords)
    cache = pb.make_lane_cache(jdata, dtype=jnp.float64, layout=layout,
                               coords_host=coords[jtab.order] if on_coords else None)
    data, tab = vecchia.make_vecchia_data(coords, m, dtype=torch.float32,
                                          precompute_distances=not on_coords, device="cpu")
    np.testing.assert_array_equal(tab.order, jtab.order)
    tables = make_site_tables(data, dtype=torch.float64, layout=layout,
                              coords_host=coords[tab.order], device="cpu")
    return {"n": n, "cache": cache, "tables": tables, "v_jax": jnp.asarray(v[tab.order]),
            "v": torch.as_tensor(v[tab.order])}


@pytest.mark.parametrize("weighted", [False, True], ids=["homogeneous", "weights"])
@pytest.mark.parametrize("layout", ["dist", "coords"])
@pytest.mark.parametrize("m", [16, 20])
def test_m20_bf_matches_pallas(m, layout, weighted):
    """Kernel 3's plain version at m = 16 and 20 (the shapes of its M = 20
    instance) on both layouts, with and without noise weights, at a nugget
    and at the latent model's alpha = 0, against pallas_bf in interpret
    mode: rtol 1e-8, B also atol 1e-12; B = 0 on the invalid slots of the
    first m sites."""
    p = _m20_problem(m, layout)
    jkern, kern = FAMILIES["exponential"]
    v, v_jax = (p["v"], p["v_jax"]) if weighted else (None, None)
    run = jax.jit(lambda phi, alpha: pb.pallas_bf(jkern, {"phi": phi}, p["cache"], alpha,
                                                  jitter=JITTER, noise_v=v_jax))
    for alphas in ALPHAS.values():
        b, f = ops.bf(kern, p["tables"], torch.tensor(PHIS, dtype=torch.float64),
                      torch.tensor(alphas, dtype=torch.float64), JITTER, noise_v=v)
        assert b.shape == (3, p["n"], m) and f.shape == (3, p["n"])
        head = torch.arange(m)
        assert (b[:, head, :][:, head[:, None] <= head[None, :]] == 0).all()
        for c, (phi, alpha) in enumerate(zip(PHIS, alphas)):
            b_p, f_p = run(jnp.float64(phi), jnp.float64(alpha))
            np.testing.assert_allclose(b[c].numpy(), np.asarray(b_p), rtol=1e-8, atol=1e-12)
            np.testing.assert_allclose(f[c].numpy(), np.asarray(f_p), rtol=1e-8)
