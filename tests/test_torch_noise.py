"""Heterogeneous (per-site) noise in the port against the reference, in
float64: the noise models, ``vecchia_bf`` with a per-site nugget, and both
models with ``HeterogeneousNoise(v)`` (the kernels' plain versions are held
to the Pallas bodies in tests/test_torch_noise_kernels.py).

v varies from site to site and the models take it in the user's order: a v
that is constant, or one that a model forgot to permute into ordered site
space, could not tell the two apart."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu import kernels as jkernels
from pynngp_tpu import noise as jnoise
from pynngp_tpu import priors as jpriors
from pynngp_tpu import vecchia as jvecchia
from pynngp_tpu.models.latent import LatentNNGP as JaxLatentNNGP
from pynngp_tpu.models.response import ResponseNNGP as JaxResponseNNGP
from pynngp_tpu_torch import diagnostics, kernels, noise, priors, vecchia
from pynngp_tpu_torch.models.latent import LatentNNGP
from pynngp_tpu_torch.models.response import ResponseNNGP

JITTER = 2.0**-20


@pytest.fixture(scope="module", autouse=True)
def _single_torch_thread():
    """Loops of small tensor ops: more intra-op threads buy nothing beside
    other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _weights(n, seed=7):
    return np.random.default_rng(seed).uniform(0.25, 4.0, n)


# ---- the noise models -------------------------------------------------------

def test_noise_models_match_reference():
    v = _weights(50)
    tau2 = 0.3
    for ours, theirs in ((noise.HomogeneousNoise(), jnoise.HomogeneousNoise()),
                         (noise.HeterogeneousNoise(v), jnoise.HeterogeneousNoise(v))):
        assert ours.name == theirs.name
        np.testing.assert_allclose(
            ours.variance(torch.tensor(tau2, dtype=torch.float64), 50).numpy(),
            np.asarray(theirs.variance(jnp.float64(tau2), 50)), rtol=1e-15)
        got = ours.weights(50, dtype=torch.float64)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(theirs.weights(50, jnp.float64)))
    assert isinstance(noise.get_noise("Homogeneous"), noise.HomogeneousNoise)
    got = noise.get_noise("heterogeneous", v=v)
    np.testing.assert_array_equal(got.v.numpy(), v)
    obj = noise.HeterogeneousNoise(v)
    assert noise.get_noise(obj) is obj
    # heterogeneous noise needs its weights, in both packages
    with pytest.raises(TypeError):
        jnoise.get_noise("heterogeneous")
    with pytest.raises(TypeError):
        noise.get_noise("heterogeneous")


# ---- vecchia_bf with a per-site nugget ---------------------------------------

def test_vector_alpha_bf_matches_reference_and_dense_solves():
    """vecchia_bf with a per-site alpha v against the reference's
    vecchia_bf (vecchia.py:140-143), rtol 1e-10, with one chain and with
    two (a (C, n) alpha, and an (n,) one shared by per-chain phi), and
    against per-site dense solves with the neighbors' nuggets on the
    diagonal (the reference's tests/test_noise_models.py:16-44)."""
    rng = np.random.default_rng(11)
    n, m = 60, 6
    coords = rng.uniform(size=(n, 2))
    jdata, jtab = jvecchia.make_vecchia_data(coords, m, dtype=jnp.float64)
    data, tab = vecchia.make_vecchia_data(coords, m, dtype=torch.float64, device="cpu")
    v = _weights(n)[tab.order]
    av = 0.2 * v
    kern, jkern = kernels.Exponential(), jkernels.Exponential()
    b, f = vecchia.vecchia_bf(kern, {"phi": 0.4}, data, alpha=torch.as_tensor(av),
                              jitter=0.0)
    b_j, f_j = jvecchia.vecchia_bf(jkern, {"phi": jnp.float64(0.4)}, jdata,
                                   alpha=jnp.asarray(av), jitter=0.0)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_j), rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), rtol=1e-10)
    pts = coords[tab.order]
    for i in (0, 3, 17, n - 1):
        sel = tab.nn_idx[i][tab.nn_mask[i]]
        k = len(sel)
        if k == 0:
            assert float(f[i]) == pytest.approx(1.0 + av[i])
            continue
        d_nn = np.sqrt(((pts[sel][:, None] - pts[sel][None]) ** 2).sum(-1))
        d_in = np.sqrt(((pts[i] - pts[sel]) ** 2).sum(-1))
        c_nn = np.exp(-d_nn / 0.4) + np.diag(av[sel])
        c_in = np.exp(-d_in / 0.4)
        bi = np.linalg.solve(c_nn, c_in)
        np.testing.assert_allclose(b[i, :k].numpy(), bi, rtol=1e-9)
        np.testing.assert_allclose(float(f[i]), 1.0 + av[i] - c_in @ bi, rtol=1e-9)
    # chains: per-chain phi with a shared (n,) alpha v, and a (C, n) alpha v
    phis = torch.tensor([0.4, 0.25], dtype=torch.float64)
    rows = torch.as_tensor(np.stack([av, 0.5 * av]))
    b2, f2 = vecchia.vecchia_bf(kern, {"phi": phis}, data, alpha=torch.as_tensor(av),
                                jitter=0.0)
    b3, f3 = vecchia.vecchia_bf(kern, {"phi": phis}, data, alpha=rows, jitter=0.0)
    assert b2.shape == b3.shape == (2, n, m) and f2.shape == f3.shape == (2, n)
    for c in range(2):
        for got_b, got_f, a in ((b2, f2, av), (b3, f3, rows[c].numpy())):
            want_b, want_f = jvecchia.vecchia_bf(
                jkern, {"phi": jnp.float64(phis[c])}, jdata, alpha=jnp.asarray(a),
                jitter=0.0)
            np.testing.assert_allclose(got_b[c].numpy(), np.asarray(want_b),
                                       rtol=1e-10, atol=1e-14)
            np.testing.assert_allclose(got_f[c].numpy(), np.asarray(want_f), rtol=1e-10)


# ---- the response model -------------------------------------------------------

def _field(n, seed, with_x):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2))
    v = rng.uniform(0.25, 4.0, n)
    y = np.sin(6.0 * coords[:, 0]) * np.cos(4.0 * coords[:, 1]) \
        + np.sqrt(0.09 * v) * rng.standard_normal(n)
    x = None
    if with_x:
        x = np.column_stack([np.ones(n), rng.standard_normal(n)])
        y = y + x @ np.array([1.0, -2.0])
    return coords, y, x, v


@pytest.fixture(scope="module", params=[("dist", 0), ("dist", 2), ("coords", 0),
                                        ("coords", 2)],
                ids=["dist-p0", "dist-p2", "coords-p0", "coords-p2"])
def response_pair(request):
    """Both packages' ResponseNNGP with HeterogeneousNoise(v), v in the
    user's order.  The reference runs its XLA backend on the dist layout and
    its Pallas coords branch in interpret mode on the coords layout."""
    layout, p = request.param
    coords, y, x, v = _field(300, 17, p > 0)
    kw = dict(kernel="sqexp", m=6, x=x, jitter=JITTER, lane_layout=layout)
    backend = "xla" if layout == "dist" else "pallas"
    jm = JaxResponseNNGP(coords, y, backend=backend, dtype=jnp.float64,
                         noise=jnoise.HeterogeneousNoise(v),
                         priors={"phi": jpriors.Uniform(0.0625, 0.5625)}, **kw)
    tm = ResponseNNGP(coords, y, device="cpu", dtype=torch.float64,
                      noise=noise.HeterogeneousNoise(v),
                      priors={"phi": priors.Uniform(0.0625, 0.5625)}, **kw)
    assert tm.tables.layout == layout
    return jm, tm


def test_response_hetero_logposts_match(response_pair):
    """_theta_logpost (the MWG target, kernel 1 or with fixed effects kernel
    3) and full_logpost with its gradient (kernel 2, with fixed effects its
    EMIT_Y instances) at a point, rtol 1e-8 (the gradient also atol 1e-8 of
    its largest entry).  The point is exact in float32, as the Pallas
    bodies' parameter row rounds it: phi the prior's midpoint 0.3125, alpha
    = tau2 / sigma2 = 1."""
    jm, tm = response_pair
    u = np.concatenate([[0.3, 0.0, 0.3], [0.4, -1.5][:tm.p]])
    jv, jg = jax.value_and_grad(jm.full_logpost)(jnp.asarray(u))
    tv, tg = tm.full_value_and_grad(torch.tensor(u)[None])
    np.testing.assert_allclose(tv[0].item(), float(jv), rtol=1e-8)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg[0].numpy(), jg, rtol=1e-8, atol=1e-8 * np.abs(jg).max())
    theta = np.asarray([u[1], u[2] - u[0]])
    sigma2 = float(np.exp(u[0]))
    beta = u[3:] if tm.p else np.zeros(1)
    j_val, j_aux = jm._theta_logpost(jnp.asarray(theta), jnp.float64(sigma2),
                                     jnp.asarray(beta))
    t_val, t_aux = tm._theta_logpost(torch.tensor(theta)[None],
                                     torch.tensor([sigma2], dtype=torch.float64),
                                     torch.tensor(beta)[None])
    np.testing.assert_allclose(float(t_val[0]), float(j_val), rtol=1e-8)
    np.testing.assert_allclose(float(t_aux["logdet"][0]), float(j_aux["logdet"]),
                               rtol=1e-8)
    np.testing.assert_allclose(float(t_aux["quad"][0]), float(j_aux["quad"]),
                               rtol=1e-8)


def test_response_hetero_weights_are_permuted_into_ordered_space(response_pair):
    """The model's padded weights are v[order] with 1 on the padded sites;
    the same model fed v already in ordered space gives another
    log-likelihood (the permutation matters for a v that varies)."""
    jm, tm = response_pair
    v_user = tm.noise.v.numpy()
    got = tm._noise_v.numpy()
    np.testing.assert_array_equal(got[:tm.n], v_user[tm.table.order])
    assert (got[tm.n:] == 1).all()
    np.testing.assert_array_equal(got[:tm.n], np.asarray(jm._noise_w))


def test_response_hetero_mwg_recovers_tau2_as_the_reference():
    """The reference's test_response_hetero_runs_and_recovers_tau2 recipe
    (n = 300, exponential, m = 8, v ~ U(0.25, 4), tau2 = 0.1, 300 + 400
    draws) in both packages, 4 chains each: the posterior means of tau2,
    sigma2 and phi agree within 4 combined Monte Carlo standard errors plus
    2%, and the port's tau2 is within 0.1 of the truth."""
    from tests.conftest import simulate_gp_field

    rng = np.random.default_rng(1234)
    coords, _, y0 = simulate_gp_field(rng, n=300, name="exponential", sigma2=1.0,
                                      phi=0.3, tau2=0.0)
    v = rng.uniform(0.25, 4.0, 300)
    y = y0 + np.sqrt(0.1 * v) * rng.standard_normal(300)
    jm = JaxResponseNNGP(coords, y, kernel="exponential", m=8, dtype=jnp.float64,
                         backend="xla", noise=jnoise.HeterogeneousNoise(v))
    tm = ResponseNNGP(coords, y, kernel="exponential", m=8, dtype=torch.float64,
                      device="cpu", noise=noise.HeterogeneousNoise(v))
    ref = jm.sample(n_samples=400, n_burn=300, n_chains=4, seed=4)
    got = tm.sample(n_samples=400, n_burn=300, n_chains=4, seed=4)
    assert np.isfinite(got["loglik"]).all()
    assert abs(got["tau2"].mean() - 0.1) < 0.1
    for key in ("tau2", "sigma2", "phi"):
        a, b = np.asarray(got[key]), np.asarray(ref[key])
        se2 = a.var() / diagnostics.ess(a) + b.var() / diagnostics.ess(b)
        assert abs(a.mean() - b.mean()) <= 4.0 * np.sqrt(se2) + 0.02 * abs(b.mean()), (
            key, a.mean(), b.mean(), np.sqrt(se2))


# ---- the latent model -----------------------------------------------------------

@pytest.fixture(scope="module")
def latent_pair():
    coords, y, _, v = _field(200, 23, False)
    kw = dict(kernel="exponential", m=6)
    jm = JaxLatentNNGP(coords, y, backend="xla", dtype=jnp.float64,
                       noise=jnoise.HeterogeneousNoise(v), **kw)
    tm = LatentNNGP(coords, y, device="cpu", dtype=torch.float64,
                    noise=noise.HeterogeneousNoise(v), **kw)
    w0 = np.random.default_rng(3).standard_normal(200)
    init = {"phi": 0.3, "sigma2": 0.9, "tau2": 0.15, "w": w0}
    js = jm.init_state(jax.random.PRNGKey(0), init)
    ts = tm.init_state(2, init)
    return jm, tm, js, ts


def _close(got, want, **kw):
    kw.setdefault("rtol", 1e-8)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **kw)


def test_latent_hetero_moments_loglik_and_tau2_update_match(latent_pair):
    """Per-site noise variance tau2 v_i: the conditional moments of w, the
    log density (sum log(tau2 v_i)) and the inverse-gamma parameters of
    tau2 | w (weighted residuals) against the reference, rtol 1e-8."""
    jm, tm, js, ts = latent_pair
    np.testing.assert_array_equal(tm._noise_w.numpy(), np.asarray(jm._noise_w))
    mu_j, v_j = jm.conditional_moments(js.w, js.b, js.f, js.sigma2, js.tau2, js.beta)
    mu, v = tm.conditional_moments(ts.w, ts.b, ts.f, ts.sigma2, ts.tau2, ts.beta)
    for c in range(2):
        _close(mu[c], mu_j, atol=1e-12)
        _close(v[c], v_j)
    _close(tm.loglik(ts), np.full(2, float(jm.loglik(js))))
    # the reference's tau2 update, written out from its step (latent.py:642-650)
    r = np.asarray(jm.data.y) - np.asarray(js.w)
    pr_t = jm.priors["tau2"]
    shape, scale = tm._tau2_conditional(ts.w, ts.beta)
    _close(shape, pr_t.a + 0.5 * jm.n)
    _close(scale, np.full(2, pr_t.b + 0.5 * np.sum(r * r / np.asarray(jm._noise_w))))


@pytest.mark.parametrize("w_update", ["chromatic", "sequential"])
def test_latent_hetero_sweep_matches_on_shared_eps(latent_pair, w_update):
    """One sweep of each kind with per-site noise from the reference's own
    normal draw: w to rtol 1e-8."""
    jm, tm, js, ts = latent_pair
    key = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.normal(key, (tm.n,), jnp.float64))
    w_j = getattr(jm, f"_update_w_{w_update}")(key, js.w, js.b, js.f, js.sigma2,
                                               js.tau2, js.beta)
    w_t = getattr(tm, f"_update_w_{w_update}")(torch.as_tensor(np.stack([eps, eps])),
                                               ts.w, ts.b, ts.f, ts.sigma2, ts.tau2,
                                               ts.beta)
    _close(w_t[0], w_j, atol=1e-12)
    _close(w_t[1], w_j, atol=1e-12)


def _latent_x(v):
    coords, y, x, _ = _field(200, 29, True)
    return LatentNNGP(coords, y, kernel="exponential", m=6, x=x, device="cpu",
                      dtype=torch.float64, noise=noise.HeterogeneousNoise(v))


def test_latent_weighted_beta_update_matches_dense_computation():
    """beta | w, tau2 under heterogeneous noise is the V^-1-weighted
    conditional (precision X' V^-1 X / tau2 + I/s^2, right-hand side
    X' V^-1 (y - w) / tau2), a deliberate departure from the reference's
    unweighted update: held to a dense numpy computation.  With v = 1 it
    is exactly the reference's update."""
    v = _weights(200, 31)
    tm = _latent_x(v)
    rng = np.random.default_rng(8)
    w = rng.standard_normal((2, 200))
    tau2 = np.array([0.2, 0.05])
    eps = rng.standard_normal((2, 2))
    beta, mean, chol = tm._draw_beta(torch.as_tensor(w), torch.as_tensor(tau2),
                                     torch.as_tensor(eps))
    xmat, y = tm.x.numpy(), tm.y.numpy()
    vo = v[tm.table.order]
    scale = tm.priors["beta_scale"]
    for c in range(2):
        prec = xmat.T @ (xmat / vo[:, None]) / tau2[c] + np.eye(2) / scale**2
        rhs = xmat.T @ ((y - w[c]) / vo) / tau2[c]
        lo = np.linalg.cholesky(prec)
        _close(mean[c], np.linalg.solve(prec, rhs))
        _close(chol[c], lo)
        _close(beta[c], np.linalg.solve(prec, rhs) + np.linalg.solve(lo.T, eps[c]))
    # v = 1: the reference's update (latent.py:652-663), written out
    ones = _latent_x(np.ones(200))
    beta1, _, _ = ones._draw_beta(torch.as_tensor(w), torch.as_tensor(tau2),
                                  torch.as_tensor(eps))
    for c in range(2):
        prec = xmat.T @ xmat / tau2[c] + np.eye(2) / scale**2
        rhs = xmat.T @ (y - w[c]) / tau2[c]
        lo = np.linalg.cholesky(prec)
        _close(beta1[c], np.linalg.solve(prec, rhs) + np.linalg.solve(lo.T, eps[c]))
