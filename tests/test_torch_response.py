"""The port's ResponseNNGP against the reference's (XLA backend, float64):
deterministic pieces to rtol 1e-8, the Adam MAP trace to rtol 1e-6, a
reference sampler state carried across, and posterior means within Monte
Carlo error (the two packages draw different random streams)."""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu import kernels as jkernels
from pynngp_tpu import priors as jpriors
from pynngp_tpu.models.response import ResponseNNGP as JaxResponseNNGP
from pynngp_tpu_torch import convert, diagnostics, kernels, priors
from pynngp_tpu_torch.models.response import ResponseNNGP
from pynngp_tpu_torch.utils.metrics import MetricsLogger

INIT = {"phi": 0.3, "alpha": 0.1, "sigma2": 1.0}
U_POINTS = [(0.1, -1.0, -2.0), (-0.3, 0.5, -1.2), (0.0, -2.5, -3.0)]


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(21)
    n = 300
    coords = rng.uniform(size=(n, 2))
    field = np.sin(6.0 * coords[:, 0]) * np.cos(4.0 * coords[:, 1])
    y = field + 0.3 * rng.standard_normal(n)
    jm = JaxResponseNNGP(coords, y, kernel="sqexp", m=6, backend="xla",
                         dtype=jnp.float64)
    tm = ResponseNNGP(coords, y, kernel="sqexp", m=6, device="cpu",
                      dtype=torch.float64)
    return jm, tm


@pytest.fixture(scope="module", autouse=True)
def _single_torch_thread():
    """Long loops of small tensor ops: more intra-op threads buy nothing and,
    beside other test workers, cost a great deal."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("u", U_POINTS)
def test_logpost_and_gradient_match(models, u):
    jm, tm = models
    jv, jg = jax.value_and_grad(jm.full_logpost)(jnp.asarray(u, jnp.float64))
    ut = torch.tensor(u, dtype=torch.float64, requires_grad=True)
    tv = tm.full_logpost(ut)
    (tg,) = torch.autograd.grad(tv, ut)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-8)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-8)
    # sigma2-collapsed theta-block target at the projected point
    theta = np.asarray([u[1], u[2] - u[0]])
    sigma2 = float(np.exp(u[0]))
    j_val, j_aux = jm._theta_logpost(jnp.asarray(theta), jnp.float64(sigma2),
                                     jnp.zeros(1, jnp.float64))
    t_val, t_aux = tm._theta_logpost(torch.tensor(theta)[None],
                                     torch.tensor([sigma2], dtype=torch.float64))
    np.testing.assert_allclose(float(t_val[0]), float(j_val), rtol=1e-8)
    np.testing.assert_allclose(float(t_aux["logdet"][0]), float(j_aux["logdet"]),
                               rtol=1e-8)
    np.testing.assert_allclose(float(t_aux["quad"][0]), float(j_aux["quad"]),
                               rtol=1e-8)


def test_batched_logpost_equals_pointwise(models):
    _, tm = models
    pts = torch.tensor(U_POINTS, dtype=torch.float64)
    batched = tm.full_logpost(pts)
    single = torch.stack([tm.full_logpost(p) for p in pts])
    np.testing.assert_allclose(batched.numpy(), single.numpy(), rtol=1e-12)


@pytest.mark.parametrize("collapsed", [True, False])
def test_init_state_matches(models, collapsed):
    jm, tm = models
    jm.collapsed = tm.collapsed = collapsed
    try:
        js = jm.init_state(jax.random.PRNGKey(0), INIT)
        ts = tm.init_state(2, INIT)
    finally:
        jm.collapsed = tm.collapsed = True
    for name in ("theta_u", "sigma2", "value", "logdet", "quad", "log_steps",
                 "accept"):
        got = getattr(ts, name).numpy()
        want = np.broadcast_to(np.asarray(getattr(js, name)), got.shape)
        np.testing.assert_allclose(got, want, rtol=1e-8, err_msg=name)
    assert ts.iteration.tolist() == [0, 0]


def test_theta_proposal_projection_matches(models):
    jm, tm = models
    a = np.random.default_rng(2).standard_normal((3, 3))
    cov = a @ a.T + np.eye(3)
    u = np.asarray([0.2, -1.1, -2.3])
    np.testing.assert_array_equal(tm.theta_proposal_cov(cov),
                                  jm.theta_proposal_cov(cov))
    np.testing.assert_array_equal(tm.theta_proposal_center(torch.tensor(u)),
                                  jm.theta_proposal_center(u))


def test_map_trace_matches(models):
    jm, tm = models
    jres = jm.fit_map(n_steps=20)
    tres = tm.fit_map(n_steps=20)
    np.testing.assert_allclose(tres.trace.numpy(), np.asarray(jres.trace),
                               rtol=1e-6)
    np.testing.assert_allclose(tres.u.numpy(), np.asarray(jres.u), rtol=1e-6)
    np.testing.assert_allclose(tres.laplace_cov.numpy(),
                               np.asarray(jres.laplace_cov), rtol=1e-4,
                               atol=1e-8)


def test_state_from_jax_steps_in_the_port(models):
    jm, tm = models
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    states = jax.vmap(lambda k: jm.init_state(k, INIT))(keys)
    step = jax.jit(jax.vmap(lambda k, s: jm.step(k, s, n_adapt=100)))
    for i in range(3):
        states = step(jax.random.split(jax.random.PRNGKey(10 + i), 4), states)
    state_np = jax.tree.map(np.asarray, states)
    ts = convert.response_state_from_jax(state_np, dtype=torch.float64)
    assert ts.theta_u.shape == (4, 2) and ts.iteration.tolist() == [3] * 4
    j_val = jax.vmap(lambda t, s, b: jm._theta_logpost(t, s, b)[0])(
        states.theta_u, states.sigma2, states.beta)
    t_val, _ = tm._theta_logpost(ts.theta_u, ts.sigma2)
    np.testing.assert_allclose(t_val.numpy(), np.asarray(j_val), rtol=1e-8)
    np.testing.assert_allclose(t_val.numpy(), state_np.value, rtol=1e-8)

    gen = torch.Generator().manual_seed(0)
    nxt = tm.step(gen, ts, n_adapt=100)
    for name, before in ts._asdict().items():
        after = getattr(nxt, name)
        assert after.shape == before.shape and after.dtype == before.dtype, name
        assert torch.isfinite(after.to(torch.float64)).all(), name
    assert nxt.iteration.tolist() == [4] * 4


@pytest.fixture(scope="module")
def reference_draws(models):
    jm, _ = models
    return jm.sample(2000, n_burn=500, n_chains=4, seed=0, init=INIT)


@pytest.mark.parametrize("sampler", ["rw_sweep", "indep_mix"])
def test_posterior_means_agree(models, reference_draws, sampler):
    """Both packages target the same posterior: means of sigma2, phi, tau2
    from 4 chains x 2000 draws agree within 4 combined Monte Carlo standard
    errors (sd / sqrt(ESS) per package)."""
    _, tm = models
    kwargs = {}
    if sampler == "indep_mix":
        mp = tm.fit_map(n_steps=200)
        kwargs = {"proposal_cov": tm.theta_proposal_cov(mp.laplace_cov),
                  "proposal_center": tm.theta_proposal_center(mp.u)}
    draws = tm.sample(2000, n_burn=500, n_chains=4, seed=1, init=INIT, **kwargs)
    assert draws["phi"].shape == (4, 2000)
    for key in ("sigma2", "phi", "tau2"):
        a = np.asarray(draws[key], np.float64)
        b = np.asarray(reference_draws[key], np.float64)
        se2 = (a.var() / diagnostics.ess(a)) + (b.var() / diagnostics.ess(b))
        assert abs(a.mean() - b.mean()) <= 4.0 * np.sqrt(se2), (
            key, a.mean(), b.mean(), np.sqrt(se2))


def test_driver_metrics_lines_and_collect_every(models):
    _, tm = models
    logger = MetricsLogger(stream=io.StringIO())
    draws = tm.sample(50, n_burn=30, n_chains=3, seed=2, init=INIT, chunk=20,
                      metrics=logger, collect_every={"loglik": 4})
    assert draws["phi"].shape == (3, 50)
    assert draws["loglik"].shape == (3, 13)  # draws 0, 4, ..., 48
    events = [(r["event"], r["done"], r["total"]) for r in logger.history]
    assert events == [("burn", 20, 30), ("burn", 30, 30), ("sample", 20, 50),
                      ("sample", 40, 50), ("sample", 50, 50)]
    lines = logger.stream.getvalue().splitlines()
    assert [json.loads(x)["event"] for x in lines] == [e[0] for e in events]
    assert all(r["iters_per_sec"] > 0 for r in logger.history)


@pytest.mark.parametrize("name", ["InverseGamma", "Uniform", "LogNormal",
                                  "Normal"])
def test_priors_match_reference(name):
    args = {"InverseGamma": (2.5, 0.7), "Uniform": (0.1, 2.0),
            "LogNormal": (0.3, 1.4), "Normal": (-0.2, 0.8)}[name]
    x = np.asarray([0.05, 0.4, 1.0, 1.9, 2.5])
    got = getattr(priors, name)(*args).logpdf(torch.as_tensor(x)).numpy()
    want = np.asarray(getattr(jpriors, name)(*args).logpdf(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_transforms_match_reference():
    u = np.asarray([-40.0, -3.0, -0.5, 0.0, 0.7, 4.0, 35.0])
    t, jt = priors.logit_transform(0.1, 2.0), jpriors.logit_transform(0.1, 2.0)
    ut = torch.as_tensor(u)
    for fn in ("forward", "log_jac"):
        np.testing.assert_allclose(getattr(t, fn)(ut).numpy(),
                                   np.asarray(getattr(jt, fn)(jnp.asarray(u))),
                                   rtol=1e-12)
    x = np.asarray([0.2, 1.0, 1.9])
    np.testing.assert_allclose(t.inverse(torch.as_tensor(x)).numpy(),
                               np.asarray(jt.inverse(jnp.asarray(x))), rtol=1e-12)


# ---- fixed effects (x=) ---------------------------------------------------

INIT_X = {"phi": 0.3, "alpha": 0.1, "sigma2": 0.9, "beta": np.array([0.5, -1.0])}


@pytest.fixture(scope="module")
def models_x():
    rng = np.random.default_rng(5)
    n = 250
    coords = rng.uniform(size=(n, 2))
    x = np.column_stack([np.ones(n), rng.standard_normal(n)])
    y = (np.sin(5.0 * coords[:, 0]) + 0.3 * rng.standard_normal(n)
         + x @ np.array([1.0, -2.0]))
    jm = JaxResponseNNGP(coords, y, kernel="exponential", m=6, x=x,
                         backend="xla", dtype=jnp.float64)
    tm = ResponseNNGP(coords, y, kernel="exponential", m=6, x=x, device="cpu",
                      dtype=torch.float64)
    return jm, tm


@pytest.mark.parametrize("collapsed", [True, False])
def test_init_state_with_fixed_effects_matches(models_x, collapsed):
    jm, tm = models_x
    jm.collapsed = tm.collapsed = collapsed
    try:
        js = jm.init_state(jax.random.PRNGKey(0), INIT_X)
        ts = tm.init_state(2, INIT_X)
    finally:
        jm.collapsed = tm.collapsed = True
    for name in ("theta_u", "sigma2", "beta", "value", "logdet", "quad", "f"):
        got = getattr(ts, name).numpy()
        want = np.asarray(getattr(js, name))
        if name == "f":
            got = got[:, :tm.n]
        np.testing.assert_allclose(got, np.broadcast_to(want, got.shape),
                                   rtol=1e-8, err_msg=name)
    np.testing.assert_allclose(ts.b[0, :, :tm.n].T.numpy(), np.asarray(js.b),
                               rtol=1e-8, atol=1e-12)
    assert ts.b.shape == (2, 6, tm.tables.n_pad)


def test_beta_step_matches_on_shared_normal_draw(models_x):
    """The conjugate beta draw through the whitened design, from the
    reference's own normal draw (the k_beta key of its step): the mean and
    the precision's Cholesky factor against a numpy transcription of
    response.py:564-587, and beta, the refreshed quad and the refreshed
    theta-block value against the reference's stepped state.  rtol 1e-8."""
    jm, tm = models_x
    js = jm.init_state(jax.random.PRNGKey(0), INIT_X)
    key = jax.random.PRNGKey(12)
    nxt = jax.tree.map(np.asarray, jm.step(key, js, n_adapt=100))
    eps = np.asarray(jax.random.normal(jax.random.split(key, 3)[2], (2,),
                                       jnp.float64))
    # the reference's state after its theta move and sigma2 draw, carried over
    stack = lambda a: np.stack([a, a])
    ts = convert.response_state_from_jax(
        type(nxt)(*(stack(a) for a in nxt)), dtype=torch.float64)
    beta, quad, mean, chol = tm._draw_beta(ts.b, ts.f, ts.sigma2,
                                           torch.as_tensor(stack(eps)))
    np.testing.assert_allclose(beta[1].numpy(), nxt.beta, rtol=1e-8)
    np.testing.assert_allclose(quad[0].item(), nxt.quad, rtol=1e-8)
    nat = tm._natural(ts.theta_u)
    value = tm._collapsed_value(ts.theta_u, nat, ts.logdet, quad)
    np.testing.assert_allclose(value[0].item(), nxt.value, rtol=1e-8)
    # numpy transcription of the reference's whitened-design update
    vd = jm.data.vecchia
    xmat, yv = np.asarray(jm.data.x), np.asarray(jm.data.y)
    idx, msk = np.asarray(vd.nn_idx), np.asarray(vd.nn_mask)
    x_t = xmat - np.einsum("nm,nmp->np", nxt.b, xmat[idx] * msk[..., None])
    y_t = yv - np.sum(nxt.b * (yv[idx] * msk), axis=-1)
    d_inv = 1.0 / (nxt.sigma2 * nxt.f)
    prec = x_t.T @ (x_t * d_inv[:, None]) + np.eye(2) / 100.0**2
    np.testing.assert_allclose(mean[0].numpy(),
                               np.linalg.solve(prec, x_t.T @ (y_t * d_inv)),
                               rtol=1e-8)
    np.testing.assert_allclose(chol[1].numpy(), np.linalg.cholesky(prec),
                               rtol=1e-8)


def test_fixed_effects_state_from_jax_steps_in_the_port(models_x):
    jm, tm = models_x
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    states = jax.vmap(lambda k: jm.init_state(k, INIT_X))(keys)
    step = jax.jit(jax.vmap(lambda k, s: jm.step(k, s, n_adapt=100)))
    for i in range(3):
        states = step(jax.random.split(jax.random.PRNGKey(10 + i), 3), states)
    ts = convert.response_state_from_jax(jax.tree.map(np.asarray, states),
                                         dtype=torch.float64)
    assert ts.b.shape == (3, 6, tm.tables.n_pad) and ts.beta.shape == (3, 2)
    _, aux = tm._theta_logpost(ts.theta_u, ts.sigma2, ts.beta)
    np.testing.assert_allclose(aux["b"].numpy(), ts.b.numpy(), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(aux["f"].numpy(), ts.f.numpy(), rtol=1e-8)
    np.testing.assert_allclose(aux["logdet"].numpy(), ts.logdet.numpy(), rtol=1e-8)
    # the state's quad is the one refreshed by the beta draw at its own beta
    np.testing.assert_allclose(aux["quad"].numpy(), ts.quad.numpy(), rtol=1e-8)
    nxt = tm.step(torch.Generator().manual_seed(0), ts, n_adapt=100)
    for name, before in ts._asdict().items():
        after = getattr(nxt, name)
        assert after.shape == before.shape and after.dtype == before.dtype, name
        assert torch.isfinite(after.to(torch.float64)).all(), name


def test_fixed_effects_posterior_agrees_with_reference(models_x):
    """Posterior means of the slope, sigma2, phi and tau2 from 4 chains x 600
    draws within 4 combined Monte Carlo standard errors plus 2% (the two
    packages draw different random streams); the slope is recovered."""
    jm, tm = models_x
    init = {k: v for k, v in INIT_X.items() if k != "beta"}
    ref = jm.sample(600, n_burn=300, n_chains=4, seed=0, init=init)
    got = tm.sample(600, n_burn=300, n_chains=4, seed=1, init=init)
    assert got["beta"].shape == (4, 600, 2)
    assert abs(got["beta"][..., 1].mean() + 2.0) < 0.1
    pairs = [(got[k], np.asarray(ref[k])) for k in ("sigma2", "phi", "tau2")]
    pairs.append((got["beta"][..., 1], np.asarray(ref["beta"])[..., 1]))
    for a, b in pairs:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        se2 = a.var() / diagnostics.ess(a) + b.var() / diagnostics.ess(b)
        assert abs(a.mean() - b.mean()) <= 4.0 * np.sqrt(se2) + 0.02 * abs(b.mean())


def test_fixed_effects_joint_posterior_is_not_ported(models_x):
    """It is ported now: full_loglik and fit_map take a model with x=, through
    the y cotangent of the differentiable suffstats."""
    _, tm = models_x
    assert tm.full_dim() == 5
    res = tm.fit_map(n_steps=2)
    assert res.u.shape == (5,) and res.laplace_cov.shape == (5, 5)
    assert torch.isfinite(tm.full_loglik(torch.zeros(5, dtype=torch.float64)))


U_POINTS_X = [(0.1, -1.0, -2.0, 0.5, -1.5), (-0.3, 0.5, -1.2, 1.2, -2.2),
              (0.0, -2.5, -3.0, -0.4, 0.3)]


def test_full_logpost_with_fixed_effects_matches(models_x):
    """full_logpost with p = 2 at a batch of points: value and gradient,
    d/dbeta included, against jax.value_and_grad of the reference model at
    the same u, rtol 1e-8; the batch equals its points one by one."""
    jm, tm = models_x
    ut = torch.tensor(U_POINTS_X, dtype=torch.float64)
    tv, tg = tm.full_value_and_grad(ut)
    for i, u in enumerate(U_POINTS_X):
        jv, jg = jax.value_and_grad(jm.full_logpost)(jnp.asarray(u, jnp.float64))
        np.testing.assert_allclose(tv[i].item(), float(jv), rtol=1e-8)
        np.testing.assert_allclose(tg[i].numpy(), np.asarray(jg), rtol=1e-8)
        np.testing.assert_allclose(tm.full_logpost(ut[i]).item(), tv[i].item(),
                                   rtol=1e-12)
        np.testing.assert_allclose(tm.full_logprior(ut[i]).item(),
                                   float(jm.full_logprior(jnp.asarray(u))),
                                   rtol=1e-10)


def test_fixed_effects_pallas_backend_gradient_matches():
    """The same against the reference's Pallas backend (the fused kernels with
    emit_y in interpret mode and the _dy scatter) in float64, at n = 600 as
    tests/test_pallas.py:212-227: rtol 1e-8 of the value and of the gradient's
    largest entry.  The reference's kernels take
    (phi, alpha, jitter) through a float32 params row, so the point is chosen
    with all three exact in float32: phi = 0.3125, alpha = 1, jitter 2^-20."""
    rng = np.random.default_rng(12)
    n = 600
    coords = rng.uniform(size=(n, 2))
    x = rng.standard_normal((n, 2))
    y = rng.standard_normal(n) + x @ np.array([1.0, -0.5])
    kwargs = dict(x=x, kernel="sqexp", m=6, jitter=2.0**-20)
    jm = JaxResponseNNGP(coords, y, backend="pallas", dtype=jnp.float64,
                         priors={"phi": jpriors.Uniform(0.0625, 0.5625)}, **kwargs)
    tm = ResponseNNGP(coords, y, device="cpu", dtype=torch.float64,
                      priors={"phi": priors.Uniform(0.0625, 0.5625)}, **kwargs)
    np.testing.assert_allclose(
        tm._full_init_u({"phi": 0.3}).numpy(),
        np.asarray(jm._full_init_u(jax.random.PRNGKey(0), {"phi": 0.3}, jitter=0.0)),
        rtol=1e-12)
    u = np.array([0.0, 0.0, 0.0, 0.7, -0.2])
    jv, jg = jax.value_and_grad(jm.full_logpost)(jnp.asarray(u))
    tv, tg = tm.full_value_and_grad(torch.tensor(u)[None])
    np.testing.assert_allclose(tv[0].item(), float(jv), rtol=1e-8)
    # the logit-phi entry is a difference of terms a thousand times its size:
    # 1e-8 of the largest entry
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg[0].numpy(), jg, rtol=1e-8,
                               atol=1e-8 * np.abs(jg).max())


def test_fit_map_with_fixed_effects_reaches_the_reference_value(models_x):
    """fit_map(x=) ends at a log-posterior value within 1e-3 of the
    reference's MAP (values, not locations: Adam stalls at different points
    of a flat ridge), and recovers the slope."""
    jm, tm = models_x
    jres = jm.fit_map(n_steps=300)
    tres = tm.fit_map(n_steps=300)
    assert abs(tres.value.item() - float(jres.value)) <= 1e-3
    np.testing.assert_allclose(tres.trace[:20].numpy(),
                               np.asarray(jres.trace)[:20], rtol=1e-6)
    assert abs(tres.u[4].item() + 2.0) < 0.1
    # the projection onto the theta block ignores the beta coordinates
    cov = tm.theta_proposal_cov(tres.laplace_cov)
    assert cov.shape == (2, 2) and np.all(np.linalg.eigvalsh(cov) > 0)


def test_warm_init_disperses_by_the_metric(models_x):
    _, tm = models_x
    gen = torch.Generator().manual_seed(0)
    u = torch.arange(5, dtype=torch.float64)
    cov = torch.diag(torch.tensor([4.0, 1.0, 0.25, 0.01, 9.0], dtype=torch.float64))
    cov[0, 1] = cov[1, 0] = 0.5
    starts = tm._warm_init_u(u, cov, 4000, gen, init_jitter=2.0)
    assert starts.shape == (4000, 5)
    np.testing.assert_allclose(starts.mean(0).numpy(), u.numpy(), atol=0.4)
    np.testing.assert_allclose(starts.std(0).numpy(),
                               2.0 * np.sqrt(np.diag(cov.numpy())), rtol=0.1)
    same = tm._warm_init_u(u, None, 3, gen, init_jitter=0.0)
    np.testing.assert_array_equal(same.numpy(), np.broadcast_to(u.numpy(), (3, 5)))


# ---- sampled-nu Matern: theta block (phi, alpha, nu), u 4 + p wide ----------

INIT_NU = {"phi": 0.3, "alpha": 0.1, "sigma2": 1.0, "nu": 0.9}
U_POINTS_NU = [(0.1, -1.0, -2.0, 0.4), (-0.3, 0.5, -1.2, -1.5)]


@pytest.fixture(scope="module")
def models_nu():
    rng = np.random.default_rng(23)
    n = 150
    coords = rng.uniform(size=(n, 2))
    y = np.sin(9.0 * coords[:, 0]) * np.cos(7.0 * coords[:, 1]) \
        + 0.3 * rng.standard_normal(n)
    jm = JaxResponseNNGP(coords, y, kernel=jkernels.Matern(), m=5, backend="xla",
                         dtype=jnp.float64)
    tm = ResponseNNGP(coords, y, kernel=kernels.Matern(), m=5, device="cpu",
                      dtype=torch.float64)
    return jm, tm


def test_sampled_nu_layout_and_default_prior(models_nu):
    jm, tm = models_nu
    assert tm.theta_names == jm.theta_names == ("phi", "alpha", "nu")
    assert tm.full_dim() == jm.full_dim() == 4
    assert (tm.priors["nu"].lo, tm.priors["nu"].hi) == (0.1, 3.0)
    static = ResponseNNGP(np.random.default_rng(0).uniform(size=(30, 2)),
                          np.zeros(30), kernel=kernels.Matern(nu=0.8), m=3,
                          device="cpu")
    assert static.theta_names == ("phi", "alpha") and static.full_dim() == 3


@pytest.mark.parametrize("u", U_POINTS_NU)
def test_sampled_nu_logpost_matches(models_nu, u):
    """full_logpost, its prior and its gradient in (log sigma2, logit phi, log
    tau2) against the reference's XLA backend, rtol 1e-8, and the theta-block
    target at the projected point.  The logit-nu entry is left to
    tests/test_torch_sampled_nu.py: the XLA backend differentiates through
    K_nu where the fused kernels, and so the port, take a difference quotient
    of rho."""
    jm, tm = models_nu
    jv, jg = jax.value_and_grad(jm.full_logpost)(jnp.asarray(u, jnp.float64))
    ut = torch.tensor(u, dtype=torch.float64, requires_grad=True)
    tv = tm.full_logpost(ut)
    (tg,) = torch.autograd.grad(tv, ut)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-8)
    np.testing.assert_allclose(tg[:3].numpy(), np.asarray(jg)[:3], rtol=1e-8)
    assert np.isfinite(tg[3].item())
    np.testing.assert_allclose(tm.full_logprior(ut.detach()).item(),
                               float(jm.full_logprior(jnp.asarray(u, jnp.float64))),
                               rtol=1e-10)
    theta = np.asarray([u[1], u[2] - u[0], u[3]])
    sigma2 = float(np.exp(u[0]))
    for collapsed in (True, False):
        jm.collapsed = tm.collapsed = collapsed
        try:
            j_val, j_aux = jm._theta_logpost(jnp.asarray(theta), jnp.float64(sigma2),
                                             jnp.zeros(1, jnp.float64))
            t_val, t_aux = tm._theta_logpost(torch.tensor(theta)[None],
                                             torch.tensor([sigma2], dtype=torch.float64))
        finally:
            jm.collapsed = tm.collapsed = True
        np.testing.assert_allclose(float(t_val[0]), float(j_val), rtol=1e-8)
        np.testing.assert_allclose(float(t_aux["logdet"][0]), float(j_aux["logdet"]),
                                   rtol=1e-8)
        np.testing.assert_allclose(float(t_aux["quad"][0]), float(j_aux["quad"]),
                                   rtol=1e-8)


def test_sampled_nu_init_state_and_projection_match(models_nu):
    jm, tm = models_nu
    js = jm.init_state(jax.random.PRNGKey(0), INIT_NU)
    ts = tm.init_state(2, INIT_NU)
    assert ts.theta_u.shape == (2, 3) and ts.log_steps.shape == (2, 3)
    for name in ("theta_u", "sigma2", "value", "logdet", "quad", "log_steps", "accept"):
        got = getattr(ts, name).numpy()
        want = np.broadcast_to(np.asarray(getattr(js, name)), got.shape)
        np.testing.assert_allclose(got, want, rtol=1e-8, err_msg=name)
    carried = convert.response_state_from_jax(
        jax.tree.map(lambda a: np.asarray(a)[None], js), dtype=torch.float64)
    assert carried.theta_u.shape == (1, 3)
    t_val, _ = tm._theta_logpost(carried.theta_u, carried.sigma2)
    np.testing.assert_allclose(t_val.numpy(), carried.value.numpy(), rtol=1e-8)
    np.testing.assert_allclose(
        tm._full_init_u(INIT_NU).numpy(),
        np.asarray(jm._full_init_u(jax.random.PRNGKey(0), INIT_NU, jitter=0.0)),
        rtol=1e-12)
    a = np.random.default_rng(2).standard_normal((4, 4))
    cov = a @ a.T + np.eye(4)
    u = np.asarray([0.2, -1.1, -2.3, 0.6])
    np.testing.assert_array_equal(tm.theta_proposal_cov(cov), jm.theta_proposal_cov(cov))
    np.testing.assert_array_equal(tm.theta_proposal_center(torch.tensor(u)),
                                  jm.theta_proposal_center(u))
