"""The port's HMC module against the reference's (``pynngp_tpu.samplers.hmc``),
float64 on the CPU.  Deterministic pieces take the same numpy inputs through
both and agree to rtol 1e-10; whatever is drawn from an RNG is compared by
moments, because ``jax.random`` and ``torch.Generator`` streams differ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu.models.response import ResponseNNGP as JaxResponseNNGP
from pynngp_tpu.samplers import hmc as jhmc
from pynngp_tpu_torch import convert, diagnostics
from pynngp_tpu_torch.models.response import ResponseNNGP
from pynngp_tpu_torch.samplers import hmc

RTOL = 1e-10
C, D = 3, 5


@pytest.fixture(scope="module", autouse=True)
def _single_torch_thread():
    """These tests are long loops of small tensor ops: more intra-op threads
    buy nothing and, beside other test workers, cost a great deal."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


@pytest.fixture(scope="module")
def metric():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((C, D, D))
    dense = a @ a.transpose(0, 2, 1) + D * np.eye(D)
    return {"dense": dense, "diag": rng.uniform(0.2, 3.0, size=(C, D)),
            "r": rng.standard_normal((C, D))}


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_mass_velocity_and_kinetic_match(metric, kind):
    im, r = metric[kind], metric["r"]
    got_v = hmc.mass_velocity(_t(im), _t(r)).numpy()
    got_k = hmc.kinetic(_t(r), _t(im)).numpy()
    for c in range(C):
        np.testing.assert_allclose(
            got_v[c], np.asarray(jhmc.mass_velocity(jnp.asarray(im[c]), jnp.asarray(r[c]))),
            rtol=RTOL)
        np.testing.assert_allclose(
            got_k[c], float(jhmc._kinetic(jnp.asarray(r[c]), jnp.asarray(im[c]))),
            rtol=RTOL)


def _quadratic(rng):
    a = rng.standard_normal((D, D))
    prec = np.linalg.inv(a @ a.T + D * np.eye(D))
    mean = rng.standard_normal(D)

    def jlogpost(z):
        d = z - jnp.asarray(mean)
        return -0.5 * d @ jnp.asarray(prec) @ d

    def tvg(z):
        d = z - _t(mean)
        g = -(d @ _t(prec))
        return 0.5 * (d * g).sum(-1), g

    return jax.value_and_grad(jlogpost), tvg, mean, np.linalg.inv(prec)


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_leapfrog_on_a_quadratic_target_matches(metric, kind):
    rng = np.random.default_rng(1)
    jvg, tvg, _, _ = _quadratic(rng)
    z0 = rng.standard_normal((C, D))
    im, r0 = metric[kind], metric["r"]
    eps = np.array([0.05, 0.11, 0.2])
    _, g0 = tvg(_t(z0))
    z, r, g, v = hmc.leapfrog(tvg, _t(z0), _t(r0), g0, _t(eps), _t(im), 7)
    for c in range(C):
        zc = jnp.asarray(z0[c])
        want = jhmc.leapfrog(jvg, zc, jnp.asarray(r0[c]), jvg(zc)[1], eps[c],
                             jnp.asarray(im[c]), 7)
        for got, ref in zip((z[c], r[c], g[c], v[c]), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                                       atol=1e-13)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(31)
    n = 300
    coords = rng.uniform(size=(n, 2))
    x = np.column_stack([np.ones(n), rng.standard_normal(n)])
    y = (np.sin(5.0 * coords[:, 0]) + 0.3 * rng.standard_normal(n)
         + x @ np.array([1.0, -2.0]))
    jm = JaxResponseNNGP(coords, y, kernel="exponential", m=6, x=x,
                         backend="xla", dtype=jnp.float64)
    tm = ResponseNNGP(coords, y, kernel="exponential", m=6, x=x, device="cpu",
                      dtype=torch.float64)
    return jm, tm


def test_leapfrog_on_the_model_matches(models):
    """Four leapfrog steps on the joint posterior with fixed effects, from the
    same (z, r) and a dense metric: every step is one value-and-gradient call
    for both chains in the port, through the y cotangent.  rtol 1e-8, the
    tolerance of the gradients themselves."""
    jm, tm = models
    rng = np.random.default_rng(2)
    z0 = np.array([[0.1, -1.0, -2.0, 0.5, -1.5], [-0.3, 0.5, -1.2, 1.2, -2.2]])
    r0 = rng.standard_normal((2, 5))
    a = rng.standard_normal((5, 5))
    im = 1e-3 * (a @ a.T + 5 * np.eye(5))
    jvg = jax.jit(jax.value_and_grad(jm.full_logpost))
    _, g0 = tm.full_value_and_grad(_t(z0))
    eps = np.array([0.05, 0.02])
    z, r, g, v = hmc.leapfrog(tm.full_value_and_grad, _t(z0), _t(r0), g0, _t(eps),
                              _t(im).expand(2, 5, 5), 4)
    for c in range(2):
        zc = jnp.asarray(z0[c])
        want = jhmc.leapfrog(jvg, zc, jnp.asarray(r0[c]), jvg(zc)[1], eps[c],
                             jnp.asarray(im), 4)
        for got, ref in zip((z[c], r[c], g[c], v[c]), want):
            ref = np.asarray(ref)
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-8,
                                       atol=1e-8 * np.abs(ref).max())


def test_dual_averaging_matches():
    rng = np.random.default_rng(3)
    eps0 = np.array([0.3, 1.0, 2.5])
    da, jda = hmc.da_init(_t(eps0)), [jhmc.da_init(jnp.asarray(e)) for e in eps0]
    for _ in range(25):
        ap = rng.uniform(size=3)
        da = hmc.da_update(da, _t(ap), target=0.8)
        jda = [jhmc.da_update(d, jnp.asarray(a), target=0.8) for d, a in zip(jda, ap)]
        for name in da._fields:
            np.testing.assert_allclose(getattr(da, name).numpy(),
                                       [float(getattr(d, name)) for d in jda],
                                       rtol=RTOL, atol=1e-15, err_msg=name)


@pytest.mark.parametrize("regularize", [True, False])
def test_welford_matches(regularize):
    rng = np.random.default_rng(4)
    wf = hmc.welford_init(C, D, torch.float64)
    jwf = [jhmc.welford_init(D, jnp.float64) for _ in range(C)]
    for _ in range(12):
        x = rng.standard_normal((C, D)) * 3.0 + 1.0
        wf = hmc.welford_update(wf, _t(x))
        jwf = [jhmc.welford_update(w, jnp.asarray(xc)) for w, xc in zip(jwf, x)]
    var = hmc.welford_variance(wf, regularize).numpy()
    for c in range(C):
        np.testing.assert_allclose(wf.mean[c].numpy(), np.asarray(jwf[c].mean), rtol=RTOL)
        np.testing.assert_allclose(wf.m2[c].numpy(), np.asarray(jwf[c].m2), rtol=RTOL)
        np.testing.assert_allclose(
            var[c], np.asarray(jhmc.welford_variance(jwf[c], regularize)), rtol=RTOL)
    assert wf.count.tolist() == [12.0] * C


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_draw_momentum_covariance(metric, kind):
    """r ~ N(0, M) with M the inverse of the inverse metric: 20,000 draws
    recover M within 5% of its scale."""
    im = metric[kind][0]
    mass = np.linalg.inv(im) if kind == "dense" else np.diag(1.0 / im)
    gen = torch.Generator().manual_seed(0)
    n = 20_000
    r = hmc.draw_momentum(gen, _t(im).expand((n,) + im.shape)).numpy()
    assert r.shape == (n, D)
    scale = np.sqrt(np.outer(np.diag(mass), np.diag(mass)))
    np.testing.assert_allclose(np.cov(r.T) / scale, mass / scale, atol=0.05)
    np.testing.assert_allclose(r.mean(0) / np.sqrt(np.diag(mass)), 0.0, atol=0.04)


def test_find_reasonable_step_size_crosses_one_half():
    rng = np.random.default_rng(5)
    _, tvg, mean, _ = _quadratic(rng)
    gen = torch.Generator().manual_seed(1)
    z = _t(mean + rng.standard_normal((8, D)))
    im = torch.ones((8, D), dtype=torch.float64)
    eps = hmc.find_reasonable_step_size(tvg, z, im, gen)
    assert eps.shape == (8,) and (eps > 0).all()
    # every chain ends on a power of two of the starting step 1.0
    np.testing.assert_allclose(np.log2(eps.numpy()), np.round(np.log2(eps.numpy())),
                               atol=1e-12)


def test_warmup_bookkeeping_matches_from_reference_states():
    """The reference's HMC chain is run through a whole warmup (window closes,
    metric resets, the switch to the averaged step size); from each of its
    states, carried across by ``hmc_state_from_jax``, the port's ``adapt``
    with the reference's next point and acceptance statistic gives the
    reference's next dual-averaging, Welford and metric state.  rtol 1e-10."""
    rng = np.random.default_rng(6)
    jvg, _, _, _ = _quadratic(rng)
    n_burn = 80
    init_fn, step_fn = jhmc.make_hmc_kernel(jvg, n_burn, n_leapfrog=4)
    step = jax.jit(step_fn)
    state = init_fn(jax.random.PRNGKey(0), jnp.zeros(D, jnp.float64))
    schedule = hmc.schedule_tensors(n_burn, torch.device("cpu"))
    resets = 0
    for i in range(n_burn + 5):
        nxt = step(jax.random.PRNGKey(100 + i), state)
        prev = convert.hmc_state_from_jax(jax.tree.map(np.asarray, state),
                                          dtype=torch.float64)
        assert prev.z.shape == (1, D) and prev.iteration.tolist() == [i]
        da, wf, inv_mass = hmc.adapt(prev, _t(nxt.z)[None], _t(nxt.info.accept_prob)[None],
                                     n_burn, schedule, 0.8, dense=False)
        for name in da._fields:
            np.testing.assert_allclose(getattr(da, name)[0].numpy(),
                                       np.asarray(getattr(nxt.da, name)),
                                       rtol=RTOL, atol=1e-14, err_msg=f"{i} {name}")
        for name in wf._fields:
            np.testing.assert_allclose(getattr(wf, name)[0].numpy(),
                                       np.asarray(getattr(nxt.wf, name)),
                                       rtol=RTOL, atol=1e-14, err_msg=f"{i} {name}")
        np.testing.assert_allclose(inv_mass[0].numpy(), np.asarray(nxt.inv_mass),
                                   rtol=RTOL)
        resets += int(not np.array_equal(np.asarray(nxt.inv_mass),
                                         np.asarray(state.inv_mass)))
        state = nxt
    assert resets >= 2  # the metric was adopted at window closes


def test_hmc_recovers_a_correlated_gaussian():
    """4 chains x 1500 draws after 600 burn-in on a correlated 5-d Gaussian:
    means within 4 Monte Carlo standard errors (sd / sqrt(ESS)), variances
    within 25%, correlations within 0.1."""
    rng = np.random.default_rng(7)
    _, tvg, mean, cov = _quadratic(rng)
    gen = torch.Generator().manual_seed(0)
    init_fn, step_fn = hmc.make_hmc_kernel(tvg, 600, n_leapfrog=16)
    state = init_fn(gen, torch.zeros((4, D), dtype=torch.float64))
    draws = []
    for i in range(2100):
        state = step_fn(gen, state)
        if i >= 600:
            draws.append(state.z)
    x = torch.stack(draws, 1).numpy()  # (4, 1500, D)
    assert not bool(state.info.diverging.any())
    for j in range(D):
        se = np.sqrt(cov[j, j] / diagnostics.ess(x[..., j]))
        assert abs(x[..., j].mean() - mean[j]) <= 4.0 * se, (j, x[..., j].mean(), mean[j])
    flat = x.reshape(-1, D)
    np.testing.assert_allclose(flat.var(0), np.diag(cov), rtol=0.25)
    sd = np.sqrt(np.diag(cov))
    np.testing.assert_allclose(np.corrcoef(flat.T), cov / np.outer(sd, sd), atol=0.1)
