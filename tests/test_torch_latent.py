"""The port's LatentNNGP against the reference's (XLA backend, float64).

Deterministic pieces (initial state, conditional moments, theta-block
values, loglik) agree to rtol 1e-8.  The two Gibbs sweeps are held to the
reference on the SAME standard normals: ``jax.random.normal(key, (n,))`` is
what the reference's sweep draws from ``key``, so the test draws it once and
hands it to the port; w then agrees to rtol 1e-8.  Whole runs draw different
random streams and are compared by posterior means within Monte Carlo error,
with the bounds of tests/test_latent_model.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu.models.latent import LatentNNGP as JaxLatentNNGP
from pynngp_tpu_torch import convert
from pynngp_tpu_torch.models.latent import LatentNNGP
from pynngp_tpu_torch.noise import HeterogeneousNoise
from pynngp_tpu_torch.ops import bf as bf_ops
from pynngp_tpu_torch.parallel import make_mesh

N, M = 200, 6
INIT = {"phi": 0.3, "sigma2": 0.9, "tau2": 0.15}


def _data(with_x):
    rng = np.random.default_rng(5)
    coords = rng.uniform(size=(N, 2))
    y = np.sin(5.0 * coords[:, 0]) * np.cos(3.0 * coords[:, 1]) \
        + 0.3 * rng.standard_normal(N)
    x = None
    if with_x:
        x = np.column_stack([np.ones(N), rng.standard_normal(N)])
        y = y + x @ np.array([1.0, -2.0])
    return coords, y, x, rng.standard_normal(N)


@pytest.fixture(scope="module", params=[False, True], ids=["p0", "p2"])
def pair(request):
    coords, y, x, w0 = _data(request.param)
    jm = JaxLatentNNGP(coords, y, kernel="exponential", m=M, x=x,
                       backend="xla", dtype=jnp.float64)
    tm = LatentNNGP(coords, y, kernel="exponential", m=M, x=x, device="cpu",
                    dtype=torch.float64)
    init = dict(INIT, w=w0)
    if request.param:
        init["beta"] = np.array([0.5, -1.0])
    js = jm.init_state(jax.random.PRNGKey(0), init)
    ts = tm.init_state(2, init)
    return jm, tm, js, ts


def _close(got, want, **kw):
    kw.setdefault("rtol", 1e-8)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **kw)


def test_static_structure_matches(pair):
    jm, tm, _, _ = pair
    assert tm.n_colors == jm.n_colors
    np.testing.assert_array_equal(tm.colors, jm.colors)
    np.testing.assert_array_equal(tm.color_sites.numpy(), np.asarray(jm.color_sites))
    np.testing.assert_array_equal(tm.child_idx.numpy(), np.asarray(jm.child_idx))
    # the port's pair tables carry one extra, always-empty column
    for got, want in zip((tm._pp, tm._pc, tm._pf, tm._pm), jm.cpairs):
        np.testing.assert_array_equal(got[:, :-1].numpy(), np.asarray(want))
        assert not got[:, -1].any()


def test_init_state_matches_through_convert(pair):
    jm, tm, js, ts = pair
    carried = convert.latent_state_from_jax(jax.tree.map(np.asarray, js),
                                            dtype=torch.float64)
    for name, got in ts._asdict().items():
        want = getattr(carried, name)
        assert want.shape[0] == 1 and got.shape[1:] == want.shape[1:], name
        assert got.dtype == want.dtype, name
        _close(got[0], want[0], atol=1e-12, err_msg=name)
        _close(got[1], want[0], atol=1e-12, err_msg=name)
    assert ts.b.shape == (2, M, tm.tables.n_pad)


def test_conditional_moments_match(pair):
    jm, tm, js, ts = pair
    mu_j, v_j = jm.conditional_moments(js.w, js.b, js.f, js.sigma2, js.tau2,
                                       js.beta)
    mu, v = tm.conditional_moments(ts.w, ts.b, ts.f, ts.sigma2, ts.tau2, ts.beta)
    assert mu.shape == v.shape == (2, N)
    for c in range(2):
        _close(mu[c], mu_j, atol=1e-12)
        _close(v[c], v_j)


@pytest.mark.parametrize("w_update", ["chromatic", "sequential"])
def test_sweep_matches_on_shared_eps(pair, w_update):
    """One sweep of each kind from the same eps: w to rtol 1e-8.  The second
    chain gets -eps, so the chains differ and the batching is exercised."""
    jm, tm, js, ts = pair
    key = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.normal(key, (N,), jnp.float64))
    sweep_j = getattr(jm, f"_update_w_{w_update}")
    sweep_t = getattr(tm, f"_update_w_{w_update}")
    w_j = sweep_j(key, js.w, js.b, js.f, js.sigma2, js.tau2, js.beta)
    w_before = ts.w.clone()
    w_t = sweep_t(torch.as_tensor(np.stack([eps, -eps])), ts.w, ts.b, ts.f,
                  ts.sigma2, ts.tau2, ts.beta)
    assert torch.equal(ts.w, w_before)  # the state's w is not updated in place
    _close(w_t[0], w_j, atol=1e-12)
    assert not np.allclose(w_t[1].numpy(), w_t[0].numpy())
    # -eps mirrors the draw around the conditional mean only for the first
    # colour/site; the whole sweep is checked by a second reference run
    w_j2 = _sweep_with_eps(jm, js, w_update, -eps)
    _close(w_t[1], w_j2, atol=1e-12)


def _sweep_with_eps(jm, js, w_update, eps):
    """The reference's sweep on given normals, by swapping its generator."""
    orig = jax.random.normal
    jax.random.normal = lambda key, shape, dtype=None: jnp.asarray(eps, dtype)
    try:
        return getattr(jm, f"_update_w_{w_update}")(
            jax.random.PRNGKey(0), js.w, js.b, js.f, js.sigma2, js.tau2, js.beta)
    finally:
        jax.random.normal = orig


@pytest.mark.parametrize("collapsed", [True, False])
def test_theta_block_values_and_loglik_match(pair, collapsed):
    jm, tm, js, ts = pair
    jm.collapsed = tm.collapsed = collapsed
    try:
        theta = np.array([-0.7])
        v_j, aux_j = jm._theta_logpost(jnp.asarray(theta), js.w, js.sigma2)
        v_t, aux_t = tm._theta_logpost(torch.as_tensor(theta).expand(2, 1), ts.w,
                                       ts.sigma2)
    finally:
        jm.collapsed = tm.collapsed = True
    _close(v_t, np.full(2, float(v_j)))
    _close(aux_t["logdet"][0], aux_j["logdet"])
    _close(aux_t["quad"][0], aux_j["quad"])
    b_rows = aux_t["b"][0, :, :N].T
    _close(b_rows, aux_j["b"], atol=1e-12)
    _close(aux_t["f"][0, :N], aux_j["f"])
    nat_t = tm._natural(torch.as_tensor(theta).expand(2, 1))
    _close(tm._collapsed_value(torch.as_tensor(theta).expand(2, 1), nat_t,
                               aux_t["logdet"], aux_t["quad"])[0],
           jm._collapsed_value(jnp.asarray(theta), jm._natural(jnp.asarray(theta)),
                               aux_j["logdet"], aux_j["quad"]))
    _close(tm.loglik(ts), np.full(2, float(jm.loglik(js))))


def test_reference_state_steps_in_the_port(pair):
    """A vmapped reference state after three of its own steps, carried
    across: the cached value, logdet and quad are what the port computes at
    that state, and the port steps on from it."""
    jm, tm, _, _ = pair
    init = dict(INIT)
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    states = jax.vmap(lambda k: jm.init_state(k, init))(keys)
    step = jax.jit(jax.vmap(lambda k, s: jm.step(k, s, n_adapt=100)))
    for i in range(3):
        states = step(jax.random.split(jax.random.PRNGKey(20 + i), 3), states)
    ts = convert.latent_state_from_jax(jax.tree.map(np.asarray, states),
                                       dtype=torch.float64)
    assert ts.w.shape == (3, N) and ts.iteration.tolist() == [3] * 3
    b, f, logdet, quad = tm._suffstats(ts.theta_u, ts.w)
    _close(b, ts.b, atol=1e-12)
    _close(f, ts.f)
    _close(logdet, ts.logdet)
    _close(quad, ts.quad_w)
    nat = tm._natural(ts.theta_u)
    _close(tm._collapsed_value(ts.theta_u, nat, logdet, quad), ts.value)
    nxt = tm.step(torch.Generator().manual_seed(0), ts, n_adapt=100)
    for name, before in ts._asdict().items():
        after = getattr(nxt, name)
        assert after.shape == before.shape and after.dtype == before.dtype, name
        assert torch.isfinite(after.to(torch.float64)).all(), name
    assert nxt.iteration.tolist() == [4] * 3


def test_beta_draw_matches_on_shared_eps(pair):
    """beta | w, tau2 of the latent model from the reference's own normal
    draw (the k_beta key of its step)."""
    jm, tm, js, ts = pair
    if not jm.p:  # without fixed effects beta is a placeholder that stays 0
        nxt = tm.step(torch.Generator().manual_seed(0), ts)
        assert nxt.beta.shape == (2, 1) and not nxt.beta.any()
        return
    key = jax.random.PRNGKey(9)
    k_beta = jax.random.split(key, 5)[3]
    eps = np.asarray(jax.random.normal(k_beta, (jm.p,), jnp.float64))
    # the reference's update, written out from its step (latent.py:652-663)
    xmat, tau2 = np.asarray(jm.data.x), float(js.tau2)
    prec = xmat.T @ xmat / tau2 + np.eye(jm.p) / jm.priors["beta_scale"] ** 2
    rhs = xmat.T @ (np.asarray(jm.data.y) - np.asarray(js.w)) / tau2
    chol = np.linalg.cholesky(prec)
    want = np.linalg.solve(prec, rhs) + np.linalg.solve(chol.T, eps)
    beta, mean, chol_t = tm._draw_beta(ts.w, ts.tau2,
                                       torch.as_tensor(eps).expand(2, jm.p))
    _close(beta[0], want)
    _close(mean[1], np.linalg.solve(prec, rhs))
    _close(chol_t[0], chol)


# ---- whole path ---------------------------------------------------------

@pytest.fixture(scope="module")
def sampled():
    coords, y, _, _ = _data(False)
    jm = JaxLatentNNGP(coords, y, kernel="exponential", m=M, backend="xla",
                       dtype=jnp.float64)
    tm = LatentNNGP(coords, y, kernel="exponential", m=M, device="cpu",
                    dtype=torch.float64)
    ref = jm.sample(500, n_burn=300, n_chains=2, seed=7, init=INIT)
    got = tm.sample(500, n_burn=300, n_chains=2, seed=7, init=INIT)
    return tm, ref, got


def test_posterior_means_agree_with_reference(sampled):
    """Means of sigma2, tau2, phi within 5 crude Monte Carlo standard errors
    plus 5% (tests/test_latent_model.py:75-79); site-wise means of w
    correlate above 0.98 (l.81-83)."""
    _, ref, got = sampled
    assert got["phi"].shape == (2, 500) and got["w"].shape == (2, 500, N)
    assert all(np.isfinite(v).all() for v in got.values())
    for name in ("sigma2", "tau2", "phi"):
        a, b = np.asarray(got[name]), np.asarray(ref[name])
        se = np.sqrt(a.var() / 50 + b.var() / 50)
        assert abs(a.mean() - b.mean()) < 5 * se + 0.05 * abs(b.mean()), (
            name, a.mean(), b.mean(), se)
    wa = got["w"].mean(axis=(0, 1))
    wb = np.asarray(ref["w"]).mean(axis=(0, 1))
    assert np.corrcoef(wa, wb)[0, 1] > 0.98


def test_same_seed_gives_identical_draws_and_w_every_thins_only_w(sampled):
    """A run is reproducible from its seed (the scatters of the sweep
    accumulate, but their live indices are distinct), and w_every keeps rows
    0, k, 2k, ... of the unthinned run, bit for bit."""
    tm, _, _ = sampled
    full = tm.sample(24, n_burn=10, n_chains=2, seed=3, init=INIT)
    again = tm.sample(24, n_burn=10, n_chains=2, seed=3, init=INIT)
    thin = tm.sample(24, n_burn=10, n_chains=2, seed=3, init=INIT, w_every=5)
    for key in full:
        np.testing.assert_array_equal(full[key], again[key], err_msg=key)
    assert thin["w"].shape == (2, 5, N)  # ceil(24 / 5)
    np.testing.assert_array_equal(thin["w"], full["w"][:, ::5])
    for key in ("sigma2", "tau2", "phi", "loglik"):
        np.testing.assert_array_equal(thin[key], full[key], err_msg=key)
    other = tm.sample(24, n_burn=10, n_chains=2, seed=4, init=INIT)
    assert not np.array_equal(other["phi"], full["phi"])


def test_w_draws_come_back_in_the_users_site_order(sampled):
    tm, _, got = sampled
    coords, y, _, _ = _data(False)
    w_mean = got["w"].mean(axis=(0, 1))
    assert np.corrcoef(w_mean, y)[0, 1] > 0.9  # ordered-space w would not
    single = tm.sample(6, n_burn=4, n_chains=1, seed=0, init=INIT,
                       collect_w=False)
    assert single["phi"].shape == (6,) and "w" not in single


@pytest.mark.parametrize("w_update,collapsed", [("sequential", True),
                                                ("chromatic", False)])
def test_other_sampler_modes_run_and_recover_the_slope(w_update, collapsed):
    coords, y, x, _ = _data(True)
    tm = LatentNNGP(coords, y, kernel="exponential", m=M, x=x, device="cpu",
                    dtype=torch.float64, w_update=w_update, collapsed=collapsed)
    before = (bf_ops.COUNT.launches, bf_ops.COUNT.plain)
    draws = tm.sample(60, n_burn=40, n_chains=2, seed=1, init=INIT,
                      collect_w=False)
    assert bf_ops.COUNT.launches == before[0] and bf_ops.COUNT.plain > before[1]
    assert draws["beta"].shape == (2, 60, 2)
    assert all(np.isfinite(v).all() for v in draws.values())
    assert abs(draws["beta"][..., 1].mean() + 2.0) < 0.3  # slope identifiable


_SMALL = np.random.default_rng(2).uniform(size=(60, 2))
_WEIGHTS = np.random.default_rng(3).uniform(0.25, 4.0, 60)


@pytest.mark.parametrize("kwargs,exc", [
    # a mesh is ported: two site shards on the CPU build and run
    ({"mesh": make_mesh(1, 2, devices=["cpu", "cpu"])}, None),
    # heterogeneous noise is ported; without its weights it raises TypeError,
    # as the reference's get_noise does
    ({"noise": "heterogeneous"}, TypeError),
    # the dot-product distance, the general-nu Matern with per-site noise
    # and the max-min ordering are ported: they build and give finite
    # values (exc None)
    ({"distance": "dotproduct"}, None),
    ({"kernel": "matern", "noise": HeterogeneousNoise(_WEIGHTS)}, None),
    ({"ordering": "maxmin"}, None),
    ({"w_update": "blocked"}, ValueError),
    ({"x": np.ones(60)}, ValueError),
    ({"device": "mps"}, ValueError),
    # the reference's backend argument, taken and ignored
    ({"backend": "pallas"}, None),
], ids=["mesh", "hetero", "dotproduct", "general_nu", "maxmin", "w_update",
        "x_shape", "mps", "backend"])
def test_unported_options_raise(kwargs, exc):
    """Options the port does not have raise (the reference's own error for
    bare heterogeneous noise); the ported ones build and run, and with the
    reference's backend argument give its log-density pieces."""
    args = {"m": 5, "device": "cpu", **kwargs}
    if exc is None:
        y = np.sin(6.0 * _SMALL[:, 0])
        # the reference's Pallas kernels take phi and the jitter in float32:
        # the comparison uses values it holds exactly
        jitter = 2.0**-13 if "backend" in kwargs else 1e-4
        model = LatentNNGP(_SMALL, y, dtype=torch.float64, jitter=jitter, **args)
        state = model.init_state(2, {"phi": 0.3, "nu": 1.0})
        state = model.step(torch.Generator().manual_seed(0), state)
        assert all(torch.isfinite(t.double()).all() for t in state)
        assert torch.isfinite(model.loglik(state)).all()
        if "backend" in kwargs:
            ref = JaxLatentNNGP(_SMALL, y, m=5, dtype=jnp.float64, jitter=jitter,
                                **kwargs)
            w = np.random.default_rng(4).standard_normal(60)
            got = model._suffstats(model._unconstrained(0.25)[None],
                                   torch.as_tensor(w)[None])
            want = ref._suffstats(ref._unconstrained(0.25), jnp.asarray(w))
            np.testing.assert_allclose([float(got[2][0]), float(got[3][0])],
                                       [float(want[2]), float(want[3])], rtol=1e-8)
        return
    with pytest.raises(exc):
        LatentNNGP(_SMALL, np.ones(60), **args)
    if exc is TypeError:  # the reference raises the same
        with pytest.raises(TypeError):
            JaxLatentNNGP(_SMALL, np.ones(60), m=5, noise="heterogeneous")


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        LatentNNGP(_SMALL, np.ones(60), m=7)
        return
    with pytest.raises(RuntimeError):
        LatentNNGP(_SMALL, np.ones(60), m=7)


# ---- sampled-nu Matern: theta block (phi, nu) -------------------------------


@pytest.fixture(scope="module")
def pair_nu():
    from pynngp_tpu import kernels as jkernels
    from pynngp_tpu_torch import kernels

    coords, y, _, w0 = _data(False)
    jm = JaxLatentNNGP(coords, y, kernel=jkernels.Matern(), m=M, backend="xla",
                       dtype=jnp.float64)
    tm = LatentNNGP(coords, y, kernel=kernels.Matern(), m=M, device="cpu",
                    dtype=torch.float64)
    init = dict(INIT, nu=0.8, w=w0)
    return jm, tm, jm.init_state(jax.random.PRNGKey(0), init), tm.init_state(2, init)


def test_sampled_nu_latent_init_state_matches_through_convert(pair_nu):
    jm, tm, js, ts = pair_nu
    assert tm.theta_names == jm.theta_names == ("phi", "nu")
    assert ts.theta_u.shape == ts.log_steps.shape == ts.accept.shape == (2, 2)
    carried = convert.latent_state_from_jax(jax.tree.map(np.asarray, js),
                                            dtype=torch.float64)
    for name, got in ts._asdict().items():
        want = getattr(carried, name)
        assert got.shape[1:] == want.shape[1:] and got.dtype == want.dtype, name
        _close(got[0], want[0], atol=1e-12, err_msg=name)
        _close(got[1], want[0], atol=1e-12, err_msg=name)


@pytest.mark.parametrize("collapsed", [True, False])
def test_sampled_nu_latent_theta_block_matches(pair_nu, collapsed):
    """The (phi, nu) block's target, B and F at another point against the
    reference's XLA backend, rtol 1e-8 (B atol 1e-12)."""
    jm, tm, js, ts = pair_nu
    jm.collapsed = tm.collapsed = collapsed
    try:
        theta = np.array([-0.7, 0.4])
        v_j, aux_j = jm._theta_logpost(jnp.asarray(theta), js.w, js.sigma2)
        v_t, aux_t = tm._theta_logpost(torch.as_tensor(theta).expand(2, 2), ts.w,
                                       ts.sigma2)
    finally:
        jm.collapsed = tm.collapsed = True
    _close(v_t, np.full(2, float(v_j)))
    _close(aux_t["logdet"][0], aux_j["logdet"])
    _close(aux_t["quad"][0], aux_j["quad"])
    _close(aux_t["b"][0, :, :N].T, aux_j["b"], atol=1e-12)
    _close(aux_t["f"][0, :N], aux_j["f"])
    _close(tm.loglik(ts), np.full(2, float(jm.loglik(js))))


def _cache_is_the_states_own(tm, state):
    """The cached B, F, logdet, quad and value are those of the state's own
    (phi, nu, w): what a stale w or a stale B/F in the step would break."""
    b, f, logdet, quad = tm._suffstats(state.theta_u, state.w)
    _close(state.b, b, atol=1e-12)
    _close(state.f, f)
    _close(state.logdet, logdet)
    _close(state.quad_w, quad)
    nat = tm._natural(state.theta_u)
    _close(state.value, tm._collapsed_value(state.theta_u, nat, logdet, quad))


def test_sampled_nu_reference_state_steps_in_the_port(pair_nu):
    """Reference states after three of the reference's own steps of the
    (phi, nu) sampler, carried across: their cache is, to rtol 1e-8, what the
    port computes at their (phi, nu, w), so the two steps keep the same
    quantities at the same points; the port steps on and keeps it so."""
    jm, tm, _, _ = pair_nu
    init = dict(INIT, nu=0.8)
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    states = jax.vmap(lambda k: jm.init_state(k, init))(keys)
    step = jax.jit(jax.vmap(lambda k, s: jm.step(k, s, n_adapt=100)))
    for i in range(3):
        states = step(jax.random.split(jax.random.PRNGKey(20 + i), 3), states)
    ts = convert.latent_state_from_jax(jax.tree.map(np.asarray, states),
                                       dtype=torch.float64)
    assert ts.theta_u.shape == (3, 2) and ts.iteration.tolist() == [3] * 3
    _cache_is_the_states_own(tm, ts)
    _cache_is_the_states_own(tm, tm.step(torch.Generator().manual_seed(0), ts,
                                         n_adapt=100))


def test_sampled_nu_latent_steps_keep_the_cache_with_the_state(pair_nu):
    """Twelve steps of four chains: both sub-blocks accept in some chains and
    reject in others, and after every step the cache is the state's own."""
    _, tm, _, _ = pair_nu
    gen = torch.Generator().manual_seed(11)
    state = tm.init_state(4, dict(INIT, nu=0.8))
    for _ in range(12):
        state = tm.step(gen, state, n_adapt=100)
        _cache_is_the_states_own(tm, state)
    moved = (state.theta_u != state.theta_u[:1]).any(0)
    assert moved.tolist() == [True, True]  # phi and nu both moved, differently
    assert (state.accept > 0).all() and (state.accept < 12).all()


def test_sampled_nu_latent_sampler_runs(pair_nu):
    _, tm, _, _ = pair_nu
    before = bf_ops.COUNT_NU.plain
    draws = tm.sample(6, n_burn=4, n_chains=2, seed=0, init=dict(INIT, nu=0.8))
    assert bf_ops.COUNT_NU.plain > before
    assert draws["nu"].shape == draws["phi"].shape == (2, 6)
    assert all(np.isfinite(v).all() for v in draws.values())
    assert (draws["nu"] > 0.1).all() and (draws["nu"] < 3.0).all()


def test_a_start_at_a_non_finite_log_density_raises_and_names_jitter():
    """A repeated site without jitter has F = 0 and log F = -inf: the chains
    would start at a value that no proposal can be compared with.
    init_state raises and names the remedy; with a jitter it starts.  m = 1
    keeps every conditioning set a single site, so that the neighbors'
    own matrix stays positive definite and only F breaks down."""
    coords = _SMALL.copy()
    coords[31] = coords[30]
    y = np.random.default_rng(3).standard_normal(60)
    args = dict(kernel="sqexp", m=1, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="jitter"):
        LatentNNGP(coords, y, jitter=0.0, **args).init_state(2, INIT)
    with pytest.raises(ValueError, match="jitter"):
        LatentNNGP(coords, y, jitter=0.0, **args).sample(2, n_burn=2, init=INIT)
    state = LatentNNGP(coords, y, jitter=1e-4, **args).init_state(2, INIT)
    assert torch.isfinite(state.value).all()


def test_a_nan_proposal_is_rejected_with_probability_zero():
    from pynngp_tpu_torch.samplers.mwg import _mh_accept

    accept, prob = _mh_accept(torch.Generator().manual_seed(0),
                              torch.tensor([float("nan"), 0.5, -1e9]))
    assert accept.tolist() == [False, True, False]
    assert prob.tolist() == [0.0, 1.0, 0.0]
