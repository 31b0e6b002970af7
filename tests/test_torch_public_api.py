"""The JAX package's last public functions in the port, against the
reference, float64 on the CPU: ``laplace_variance`` and the ``rel_floor`` /
``fd_step`` arguments of ``laplace_moments``, ``default_params`` of every
kernel, the plain drivers ``run_mcmc`` / ``run_chains``, the chunked
driver's ``progress_fn``, and the single-chain ``nuts_sample`` /
``hmc_sample`` on the reference's Gaussian target and bounds
(tests/test_mapfit.py, tests/test_nuts.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu import kernels as jkernels
from pynngp_tpu.models import base as jbase
from pynngp_tpu.samplers import mapfit as jmapfit
from pynngp_tpu_torch import kernels
from pynngp_tpu_torch.models import base
from pynngp_tpu_torch.models.response import ResponseNNGP
from pynngp_tpu_torch.samplers import mapfit
from pynngp_tpu_torch.samplers.hmc import hmc_sample
from pynngp_tpu_torch.samplers.nuts import nuts_sample
from tests.conftest import simulate_gp_field


@pytest.fixture(scope="module", autouse=True)
def _single_torch_thread():
    """Long loops of small tensor ops: more intra-op threads buy nothing and,
    beside other test workers, cost a great deal."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# (batched torch target, JAX target, k, arguments, exact variance or None)
VAR_TRUE = np.array([0.5, 2.0, 0.01])
LAPLACE_CASES = {
    # tests/test_mapfit.py: exact on a Gaussian
    "quadratic": (lambda u: -0.5 * (u * u / torch.as_tensor(VAR_TRUE)).sum(-1),
                  lambda u: -0.5 * jnp.sum(u * u / jnp.asarray(VAR_TRUE)),
                  3, {}, VAR_TRUE),
    # a saddle: |eigenvalue| keeps the curvature scales
    "saddle": (lambda u: 2.0 * u[..., 0] ** 2 - 8.0 * u[..., 1] ** 2,
               lambda u: 2.0 * u[0] ** 2 - 8.0 * u[1] ** 2,
               2, {}, np.array([0.25, 0.0625])),
    # not quadratic, a nearly flat direction: the step and the floor matter
    "floor and step": (
        lambda u: (-0.5 * u[..., 0] ** 2 - 0.3 * u[..., 0] ** 4 + 0.2 * u[..., 0] * u[..., 2]
                   - 1e-9 * u[..., 1] ** 2 - 0.5 * torch.sin(u[..., 2]) ** 2),
        lambda u: (-0.5 * u[0] ** 2 - 0.3 * u[0] ** 4 + 0.2 * u[0] * u[2]
                   - 1e-9 * u[1] ** 2 - 0.5 * jnp.sin(u[2]) ** 2),
        3, {"rel_floor": 1e-3, "fd_step": 3e-2}, None),
}


@pytest.mark.parametrize("case", list(LAPLACE_CASES))
def test_laplace_variance_matches_the_reference(case):
    tfn, jfn, k, args, exact = LAPLACE_CASES[case]
    u0 = np.full(k, 0.1)
    got = mapfit.laplace_variance(tfn, torch.as_tensor(u0), **args)
    want = np.asarray(jmapfit.laplace_variance(jfn, jnp.asarray(u0), **args))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8)
    var, cov = mapfit.laplace_moments(tfn, torch.as_tensor(u0), **args)
    jvar, jcov = jmapfit.laplace_moments(jfn, jnp.asarray(u0), **args)
    np.testing.assert_array_equal(var.numpy(), got.numpy())
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), rtol=1e-8, atol=1e-14)
    if exact is not None and case == "quadratic":
        np.testing.assert_allclose(got.numpy(), exact, rtol=1e-6)


def test_laplace_variance_defaults_are_the_arguments():
    tfn = LAPLACE_CASES["floor and step"][0]
    u0 = torch.full((3,), 0.1, dtype=torch.float64)
    np.testing.assert_array_equal(
        mapfit.laplace_variance(tfn, u0).numpy(),
        mapfit.laplace_variance(tfn, u0, rel_floor=1e-8, fd_step=1e-3).numpy())
    assert not np.array_equal(
        mapfit.laplace_variance(tfn, u0).numpy(),
        mapfit.laplace_variance(tfn, u0, rel_floor=1e-3).numpy())


KERNELS = {"sqexp": ((), {}), "exponential": ((), {}), "spherical": ((), {}),
           "matern sampled nu": ((), {"name": "matern"}),
           "matern 1.5": ((), {"name": "matern", "nu": 1.5}),
           "matern 0.8": ((), {"name": "matern", "nu": 0.8})}


@pytest.mark.parametrize("which", list(KERNELS))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_default_params_are_the_references(which, dtype):
    kw = dict(KERNELS[which][1])
    name = kw.pop("name", which)
    ours = kernels.get_kernel(name, **kw).default_params(getattr(torch, dtype))
    ref = jkernels.get_kernel(name, **kw).default_params(getattr(jnp, dtype))
    assert sorted(ours) == sorted(ref)
    assert ("nu" in ours) == (which == "matern sampled nu")
    for key, val in ours.items():
        assert val.dtype == getattr(torch, dtype) and val.shape == ()
        assert val.item() == float(ref[key])
    assert kernels.Matern().default_params(device="cpu")["nu"].device.type == "cpu"


@pytest.fixture(scope="module")
def small_model():
    coords, _, y = simulate_gp_field(np.random.default_rng(5), n=60)
    return ResponseNNGP(coords, y, kernel="exponential", m=4, dtype=torch.float64,
                        device="cpu")


def test_run_chains_is_the_chunked_driver(small_model):
    """run_chains is one chunk of run_chains_chunked: the same draws bit for
    bit, whatever chunk the chunked run takes; run_mcmc on the same state
    and generator takes the same steps."""
    m = small_model
    step = lambda g, s: m.step(g, s, n_adapt=10)
    init = lambda c: m.init_state(c)
    args = (init, step, m.collect, 3, 12, 10, 2)
    state, draws = base.run_chains(torch.Generator().manual_seed(4), *args)
    for chunk in (3, 7):
        state_c, draws_c = base.run_chains_chunked(
            torch.Generator().manual_seed(4), *args, chunk=chunk)
        assert draws.keys() == draws_c.keys()
        for key in draws:
            assert draws[key].shape[:2] == (3, 12)
            assert np.array_equal(draws[key], draws_c[key]), key
        assert torch.equal(state.theta_u, state_c.theta_u)
    _, plain = base.run_mcmc(torch.Generator().manual_seed(4), init(3), step,
                             m.collect, 12, 10, 2)
    for key in draws:
        assert np.array_equal(np.swapaxes(plain[key].numpy(), 0, 1), draws[key]), key


@pytest.mark.parametrize("driver", ["run_mcmc", "run_chains"])
def test_plain_drivers_keep_the_references_draws(driver):
    """A deterministic step (s -> 0.9 s + 1 + chain), so that both
    packages' drivers take the same states: the kept draws, burn-in and
    thinning included, are the reference's."""
    n_samples, n_burn, thin = 5, 4, 3
    if driver == "run_mcmc":
        _, want = jbase.run_mcmc(jax.random.PRNGKey(0), jnp.asarray(2.0),
                                 lambda k, s: 0.9 * s + 1.0, lambda s: {"s": s},
                                 n_samples, n_burn, thin)
        _, got = base.run_mcmc(torch.Generator(), torch.tensor(2.0, dtype=torch.float64),
                               lambda g, s: 0.9 * s + 1.0, lambda s: {"s": s},
                               n_samples, n_burn, thin)
        got = got["s"].numpy()
    else:
        _, want = jbase.run_chains(
            jax.random.PRNGKey(0), lambda k: jnp.asarray(2.0),
            lambda k, s: 0.9 * s + 1.0, lambda s: {"s": s}, 3, n_samples, n_burn, thin)
        _, got = base.run_chains(
            torch.Generator(), lambda c: torch.full((c,), 2.0, dtype=torch.float64),
            lambda g, s: 0.9 * s + 1.0, lambda s: {"s": s}, 3, n_samples, n_burn, thin)
        got = got["s"]
    np.testing.assert_allclose(got, np.asarray(want["s"]), rtol=1e-14)
    assert got.shape == ((n_samples,) if driver == "run_mcmc" else (3, n_samples))


def test_fit_map_takes_the_references_seed(small_model):
    """fit_map(seed=) is accepted and, as in the reference, changes nothing."""
    a = small_model.fit_map(n_steps=5)
    b = small_model.fit_map(n_steps=5, seed=3)
    assert torch.equal(a.u, b.u) and torch.equal(a.laplace_cov, b.laplace_cov)


@pytest.mark.parametrize("thin", [1, 2])
def test_progress_calls_are_the_references(thin):
    """progress_fn gets the reference driver's (phase, done, total) calls
    for the same run, with n_burn and n_samples multiples of the chunk."""
    jcalls, calls = [], []
    kw = dict(n_chains=2, n_samples=12, n_burn=8, thin=thin, chunk=4)
    jbase.run_chains_chunked(
        jax.random.PRNGKey(0), lambda k: jnp.zeros(2), lambda k, s: s + 1.0,
        lambda s: {"x": s[0]}, progress_fn=lambda *a: jcalls.append(a), **kw)
    _, draws = base.run_chains_chunked(
        torch.Generator().manual_seed(0), lambda c: torch.zeros(c, 2),
        lambda g, s: s + 1.0, lambda s: {"x": s[:, 0]},
        progress_fn=lambda *a: calls.append(a), **kw)
    assert calls == [tuple(int(v) if not isinstance(v, str) else v for v in c)
                     for c in jcalls]
    assert calls[0] == ("burn", 4, 8) and calls[-1] == ("sample", 12, 12)
    assert draws["x"].shape == (2, 12)


def _mvn_target(dim, rng):
    """tests/test_nuts.py's 4-d Gaussian, its value and gradient at one
    point (d,)."""
    a = rng.standard_normal((dim, dim))
    cov = a @ a.T + dim * np.eye(dim)
    mean = rng.standard_normal(dim) * 2.0
    prec, mu = torch.as_tensor(np.linalg.inv(cov)), torch.as_tensor(mean)

    def value_and_grad(z):
        g = -(prec @ (z - mu))
        return 0.5 * ((z - mu) @ g), g

    return value_and_grad, mean, cov


@pytest.mark.parametrize("sampler", ["nuts", "hmc"])
def test_gaussian_target_moments(sampler):
    """The reference's test_gaussian_target_moments and its bounds, at
    1,000 + 400 iterations (the reference runs 2,000 + 800; the port's
    Python tree loop takes ~6 s for these on one thread)."""
    dim = 4
    vg, mean, cov = _mvn_target(dim, np.random.default_rng(1234))
    run = nuts_sample if sampler == "nuts" else hmc_sample
    draws, tuned = run(vg, torch.zeros(dim, dtype=torch.float64),
                       torch.Generator().manual_seed(0), n_samples=1000, n_burn=400)
    x = draws.numpy()
    assert x.shape == (1000, dim)
    assert tuned["inv_mass"].shape == (dim,) and float(tuned["step_size"]) > 0
    se = np.sqrt(np.diag(cov) / 200)  # generous: ESS >= 200 expected
    assert (np.abs(x.mean(0) - mean) < 4 * se).all(), (x.mean(0), mean)
    np.testing.assert_allclose(x.var(0), np.diag(cov), rtol=0.35)
    np.testing.assert_allclose(
        np.corrcoef(x.T), cov / np.sqrt(np.outer(np.diag(cov), np.diag(cov))),
        atol=0.15)


def test_single_chain_collect_and_thin():
    """collect_fn(z, value, info) sees one chain's values; thin keeps one
    draw in thin steps of the same run."""
    vg, _, _ = _mvn_target(2, np.random.default_rng(3))
    z0 = torch.zeros(2, dtype=torch.float64)
    every, _ = nuts_sample(vg, z0, torch.Generator().manual_seed(1), n_samples=12,
                           n_burn=6, collect_fn=lambda z, v, info: (z, v, info.depth))
    thinned, _ = nuts_sample(vg, z0, torch.Generator().manual_seed(1), n_samples=6,
                             n_burn=6, thin=2)
    z, v, depth = every
    assert z.shape == (12, 2) and v.shape == (12,) and depth.shape == (12,)
    assert torch.equal(thinned, z[1::2])
