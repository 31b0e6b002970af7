"""The port's NUTS against the reference's (``pynngp_tpu.samplers.nuts``),
float64 on the CPU.  Deterministic pieces agree exactly or to rtol 1e-10 on
the same numpy inputs; sampled quantities are compared by posterior moments
within Monte Carlo error (the RNG streams differ), with the bounds of
tests/test_nuts.py and tests/test_response_model.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu.models.response import ResponseNNGP as JaxResponseNNGP
from pynngp_tpu.samplers import nuts as jnuts
from pynngp_tpu_torch import convert, diagnostics
from pynngp_tpu_torch.models.response import ResponseNNGP
from pynngp_tpu_torch.samplers import hmc, nuts

D = 5


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


@pytest.mark.parametrize("n_burn", [1, 7, 40, 150, 300, 500, 1000])
def test_warmup_schedule_is_the_reference_schedule(n_burn):
    got, want = nuts._warmup_schedule(n_burn), jnuts._warmup_schedule(n_burn)
    for a, b in zip(got, want):
        assert a.dtype == np.bool_ and np.array_equal(a, b)


@pytest.mark.parametrize("max_bits", [1, 6, 10])
def test_trailing_zeros_matches(max_bits):
    for i in range(2**max_bits + 3):
        assert nuts._trailing_zeros(i, max_bits) == int(
            jnuts._trailing_zeros(jnp.int32(i), max_bits))


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_is_turning_matches(kind):
    rng = np.random.default_rng(0)
    n = 64
    if kind == "dense":
        a = rng.standard_normal((n, D, D))
        im = a @ a.transpose(0, 2, 1) + np.eye(D)
    else:
        im = rng.uniform(0.1, 2.0, size=(n, D))
    r_l, r_r, rho = (rng.standard_normal((n, D)) for _ in range(3))
    got = nuts._is_turning(_t(im), _t(r_l), _t(r_r), _t(rho)).numpy()
    want = [bool(jnuts._is_turning(jnp.asarray(im[c]), jnp.asarray(r_l[c]),
                                   jnp.asarray(r_r[c]), jnp.asarray(rho[c])))
            for c in range(n)]
    assert got.tolist() == want and 0 < sum(want) < n


def _gaussian(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((D, D))
    cov = a @ a.T + D * np.eye(D)
    mean = rng.standard_normal(D) * 2.0
    prec = np.linalg.inv(cov)

    def jlogpost(z):
        d = z - jnp.asarray(mean)
        return -0.5 * d @ jnp.asarray(prec) @ d

    def tvg(z):
        d = z - _t(mean)
        g = -(d @ _t(prec))
        return 0.5 * (d * g).sum(-1), g

    return jax.value_and_grad(jlogpost), tvg, mean, cov


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_warmup_bookkeeping_matches_from_reference_states(dense):
    """The reference's NUTS chain is run through a whole warmup; from each of
    its states, carried across by ``nuts_state_from_jax``, the port computes
    the same step size and, given the reference's next point and acceptance
    statistic, the same dual-averaging, Welford and metric state (window
    closes, the step-size clamp of a dense metric, the frozen dense metric).
    rtol 1e-10."""
    jvg, _, _, cov = _gaussian(1)
    n_burn, max_depth = 80, 5
    init_im = 0.9 * cov if dense else None
    init_fn, step_fn = jnuts.make_nuts_kernel(
        jvg, n_burn, max_depth,
        init_inv_mass=None if init_im is None else jnp.asarray(init_im))
    step = jax.jit(step_fn)
    state = init_fn(jax.random.PRNGKey(0), jnp.zeros(D, jnp.float64))
    schedule = hmc.schedule_tensors(n_burn, torch.device("cpu"))
    lo, hi = np.log(0.01), np.log(2.0)
    clamp = (lambda ls: torch.clamp(ls, lo, hi)) if dense else (lambda ls: ls)
    changed = 0
    for i in range(n_burn + 5):
        nxt = step(jax.random.PRNGKey(100 + i), state)
        prev = convert.nuts_state_from_jax(jax.tree.map(np.asarray, state),
                                           dtype=torch.float64)
        assert prev.z.shape == (1, D) and prev.iteration.tolist() == [i]
        assert prev.info.depth.dtype == torch.int32
        assert prev.info.diverging.dtype == torch.bool
        da, wf, inv_mass = hmc.adapt(prev, _t(nxt.z)[None],
                                     _t(nxt.info.accept_prob)[None], n_burn,
                                     schedule, 0.8, dense, clamp)
        for node, ref in ((da, nxt.da), (wf, nxt.wf)):
            for name in node._fields:
                np.testing.assert_allclose(getattr(node, name)[0].numpy(),
                                           np.asarray(getattr(ref, name)),
                                           rtol=1e-10, atol=1e-14,
                                           err_msg=f"{i} {name}")
        np.testing.assert_allclose(inv_mass[0].numpy(), np.asarray(nxt.inv_mass),
                                   rtol=1e-10)
        changed += int(not np.array_equal(np.asarray(nxt.inv_mass),
                                          np.asarray(state.inv_mass)))
        assert int(nxt.info.depth) <= max_depth
        state = nxt
    assert changed == 0 if dense else changed >= 2


def _run(init_fn, step_fn, z0, n_burn, n_draws, seed=0):
    gen = torch.Generator().manual_seed(seed)
    state = init_fn(gen, z0)
    start = state
    draws, infos = [], []
    for i in range(n_burn + n_draws):
        state = step_fn(gen, state)
        infos.append(state.info)
        if i >= n_burn:
            draws.append(state.z)
    return start, state, torch.stack(draws, 1).numpy(), infos


def test_nuts_recovers_a_correlated_gaussian():
    """4 chains x 1000 draws after 500 burn-in on a correlated 5-d Gaussian
    from the unit metric: means within 4 Monte Carlo standard errors,
    variances within 25%, correlations within 0.1, no divergence after warmup; the tree
    never exceeds max_depth or 2^max_depth - 1 leapfrog steps."""
    _, tvg, mean, cov = _gaussian(2)
    max_depth = 6
    init_fn, step_fn = nuts.make_nuts_kernel(tvg, 500, max_depth)
    _, state, x, infos = _run(init_fn, step_fn, torch.zeros((4, D), dtype=torch.float64),
                              500, 1000)
    assert not any(bool(i.diverging.any()) for i in infos[500:])  # after warmup
    assert max(int(i.depth.max()) for i in infos) <= max_depth
    assert max(int(i.n_leapfrog.max()) for i in infos) <= 2**max_depth - 1
    assert min(int(i.n_leapfrog.min()) for i in infos) >= 1
    assert state.iteration.tolist() == [1500] * 4
    for j in range(D):
        se = np.sqrt(cov[j, j] / diagnostics.ess(x[..., j]))
        assert abs(x[..., j].mean() - mean[j]) <= 4.0 * se, (j, x[..., j].mean(), mean[j])
    flat = x.reshape(-1, D)
    np.testing.assert_allclose(flat.var(0), np.diag(cov), rtol=0.25)
    sd = np.sqrt(np.diag(cov))
    np.testing.assert_allclose(np.corrcoef(flat.T), cov / np.outer(sd, sd), atol=0.1)
    # warmup adopted a diagonal metric near the marginal variances
    np.testing.assert_allclose(state.inv_mass.numpy(),
                               np.broadcast_to(np.diag(cov), (4, D)), rtol=0.6)


def test_dense_metric_is_frozen_and_the_step_is_clamped():
    _, tvg, mean, cov = _gaussian(3)
    init_fn, step_fn = nuts.make_nuts_kernel(tvg, 120, 5, init_inv_mass=_t(cov))
    start, state, x, infos = _run(init_fn, step_fn,
                                  _t(np.broadcast_to(mean, (3, D))), 120, 200)
    assert start.inv_mass.shape == (3, D, D)
    assert torch.equal(state.inv_mass, start.inv_mass)
    step = torch.exp(state.da.log_step_avg)
    assert ((step >= 0.01 - 1e-12) & (step <= 2.0 + 1e-12)).all()
    assert max(int(i.depth.max()) for i in infos) <= 5
    # whitened by the exact covariance, the sampler recovers the mean
    se = np.sqrt(np.diag(cov) / diagnostics.ess(x[..., 0]))
    assert (np.abs(x.reshape(-1, D).mean(0) - mean) <= 5.0 * se).all()


def test_a_nan_energy_is_a_divergence_not_an_error():
    """A target that is NaN beyond a wall: leaves there get zero weight and
    end the tree as divergent (pynngp_tpu/samplers/nuts.py:113-116); the
    chain never moves onto them."""
    def tvg(z):
        v = -0.5 * (z * z).sum(-1)
        bad = z[:, 0] > 1.0
        nan = torch.full_like(v, torch.nan)
        return torch.where(bad, nan, v), torch.where(bad[:, None], nan[:, None], -z)

    init_fn, step_fn = nuts.make_nuts_kernel(tvg, 50, 5)
    _, state, x, infos = _run(init_fn, step_fn, torch.zeros((4, 2), dtype=torch.float64),
                              50, 300)
    assert np.isfinite(x).all() and (x[..., 0] <= 1.0).all()
    assert any(bool(i.diverging.any()) for i in infos)
    assert torch.isfinite(state.value).all() and torch.isfinite(state.grad).all()


# ---- the response model -----------------------------------------------------


def _field(seed, n, with_x):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2))
    y = np.sin(6.0 * coords[:, 0]) * np.cos(4.0 * coords[:, 1]) \
        + 0.3 * rng.standard_normal(n)
    x = None
    if with_x:
        x = np.column_stack([np.ones(n), rng.standard_normal(n)])
        y = y + x @ np.array([1.0, -2.0])
    return coords, y, x


@pytest.fixture(scope="module")
def models():
    coords, y, _ = _field(41, 300, False)
    jm = JaxResponseNNGP(coords, y, kernel="exponential", m=6, backend="xla",
                         dtype=jnp.float64)
    tm = ResponseNNGP(coords, y, kernel="exponential", m=6, device="cpu",
                      dtype=torch.float64)
    return jm, tm


def _agree(a, b):
    """|mean a - mean b| within 4 combined Monte Carlo standard errors + 2%."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    se2 = a.var() / max(diagnostics.ess(a), 4) + b.var() / max(diagnostics.ess(b), 4)
    return abs(a.mean() - b.mean()) <= 4.0 * np.sqrt(se2) + 0.02 * abs(b.mean())


@pytest.fixture(scope="module")
def nuts_draws(models):
    _, tm = models
    mp = tm.fit_map(n_steps=150)
    return tm.sample_nuts(300, n_burn=200, n_chains=4, seed=5, max_depth=6,
                          init_u=mp.u, init_inv_mass=mp.laplace_cov,
                          init_jitter=2.0)


def test_sample_nuts_draws(nuts_draws):
    assert set(nuts_draws) == {"sigma2", "phi", "tau2", "logpost", "diverging",
                               "depth", "n_leapfrog"}
    assert nuts_draws["depth"].max() <= 6 and nuts_draws["n_leapfrog"].max() <= 63
    assert nuts_draws["n_leapfrog"].min() >= 1
    assert all(v.shape == (4, 300) for v in nuts_draws.values())
    assert nuts_draws["diverging"].dtype == np.bool_
    assert all(np.isfinite(v).all() for v in nuts_draws.values())
    assert nuts_draws["diverging"].mean() < 0.05
    assert diagnostics.split_rhat(nuts_draws["tau2"]) < 1.1


def test_sample_nuts_agrees_with_the_ports_mwg(models, nuts_draws):
    _, tm = models
    mwg = tm.sample(1500, n_burn=400, n_chains=4, seed=6,
                    init={"phi": 0.3, "alpha": 0.1, "sigma2": 1.0})
    for key in ("sigma2", "phi", "tau2"):
        assert _agree(nuts_draws[key], mwg[key]), key
        ratio = nuts_draws[key].std() / mwg[key].std()
        assert 0.5 < ratio < 2.0, (key, ratio)


def test_sample_nuts_agrees_with_the_reference_nuts(models, nuts_draws):
    jm, _ = models
    ref = jm.sample_nuts(n_samples=400, n_burn=300, n_chains=2, seed=2, max_depth=6)
    for key in ("sigma2", "phi", "tau2"):
        assert _agree(nuts_draws[key], np.asarray(ref[key])), key


def test_sample_nuts_repeats_from_one_seed(models):
    _, tm = models
    kwargs = dict(n_burn=20, n_chains=3, seed=11, max_depth=4)
    a, b = tm.sample_nuts(12, **kwargs), tm.sample_nuts(12, **kwargs)
    c = tm.sample_nuts(12, **{**kwargs, "seed": 12})
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert not np.array_equal(a["phi"], c["phi"])
    one = tm.sample_nuts(5, n_burn=5, max_depth=3)
    assert one["phi"].shape == (5,)


# ---- the response model with a sampled-nu Matern ---------------------------


def test_sampled_nu_nuts_runs_on_the_four_wide_vector():
    """``Matern()``: the joint vector is [log sigma2, logit phi, log tau2,
    logit nu], the Laplace metric 4 x 4, and nu comes back with the other
    draws inside its prior's support; one seed gives one run.  (Posterior
    agreement with the reference: tests/test_torch_sampled_nu.py.)"""
    from pynngp_tpu_torch import kernels

    coords, y, _ = _field(44, 120, False)
    tm = ResponseNNGP(coords, y, kernel=kernels.Matern(), m=5, device="cpu",
                      dtype=torch.float64)
    assert tm.full_dim() == 4 and tm.theta_names == ("phi", "alpha", "nu")
    mp = tm.fit_map(n_steps=30)
    assert mp.u.shape == (4,) and mp.laplace_cov.shape == (4, 4)
    kwargs = dict(n_burn=8, n_chains=2, seed=5, max_depth=3, init_u=mp.u,
                  init_inv_mass=mp.laplace_cov, init_jitter=2.0)
    draws = tm.sample_nuts(8, **kwargs)
    assert set(draws) == {"sigma2", "phi", "tau2", "nu", "logpost", "diverging",
                          "depth", "n_leapfrog"}
    assert all(v.shape == (2, 8) for v in draws.values())
    assert all(np.isfinite(v).all() for v in draws.values())
    assert (draws["nu"] > 0.1).all() and (draws["nu"] < 3.0).all()
    again = tm.sample_nuts(8, **kwargs)
    for key in draws:
        np.testing.assert_array_equal(draws[key], again[key], err_msg=key)


def test_gradient_states_carry_the_nu_column():
    """convert.nuts_state_from_jax / hmc_state_from_jax with a 4-wide z: the
    reference's state fields pass through whatever their width."""
    from pynngp_tpu.samplers import hmc as jhmc

    rng = np.random.default_rng(0)
    c, d = 3, 4
    da = jhmc.DualAveraging(*(rng.standard_normal(c) for _ in jhmc.DualAveraging._fields))
    wf = jhmc.Welford(*(rng.standard_normal((c, d)) if name != "count"
                        else np.full(c, 5.0) for name in jhmc.Welford._fields))
    info = jnuts.NUTSInfo(*(np.zeros(c, np.int32) if name in ("depth", "n_leapfrog")
                            else (np.zeros(c, bool) if name == "diverging"
                                  else rng.standard_normal(c))
                            for name in jnuts.NUTSInfo._fields))
    state = jnuts.NUTSState(z=rng.standard_normal((c, d)), value=rng.standard_normal(c),
                            grad=rng.standard_normal((c, d)), da=da, wf=wf,
                            inv_mass=rng.uniform(1, 2, (c, d)),
                            iteration=np.full(c, 7, np.int32), info=info)
    ts = convert.nuts_state_from_jax(state, dtype=torch.float64)
    assert ts.z.shape == ts.grad.shape == ts.inv_mass.shape == (c, d)
    np.testing.assert_array_equal(ts.z.numpy(), state.z)
    np.testing.assert_array_equal(ts.wf.mean.numpy(), wf.mean)
    assert ts.iteration.tolist() == [7] * c and ts.info.diverging.dtype == torch.bool
