"""The port's ADVI (``pynngp_tpu_torch.samplers.vi`` and
``ResponseNNGP.fit_advi``) against the reference's
(``pynngp_tpu.samplers.vi``), float64 on the CPU.

Given the reference's own standard normals (regenerated from its keys,
``normal(fold_in(key, i), (n_mc, k))``), ``advi_fit`` must agree with the
reference's after 50 steps at rtol 1e-8, mean-field and full rank, on the
Gaussian target of tests/test_smc_vi.py and on a small model's
``full_logpost``.  Whole fits are held to the reference tests' bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pynngp_tpu.models.response import ResponseNNGP as JaxResponseNNGP
from pynngp_tpu.samplers import vi as jvi
from pynngp_tpu_torch import convert
from pynngp_tpu_torch.models.response import ResponseNNGP
from pynngp_tpu_torch.ops import diff_suffstats as dops
from pynngp_tpu_torch.ops import suffstats as fops
from pynngp_tpu_torch.samplers import mapfit, vi
from tests.conftest import simulate_gp_field

MEAN = np.array([1.0, -1.0, 2.0, 0.0])
SD = np.array([0.5, 1.0, 0.2, 2.0])


@pytest.fixture(scope="module", autouse=True)
def _single_torch_thread():
    """Long loops of small tensor ops: more intra-op threads buy nothing and,
    beside other test workers, cost a great deal."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _j_gaussian(u):
    z = (u - jnp.asarray(MEAN)) / jnp.asarray(SD)
    return -0.5 * jnp.sum(z * z)


def _t_gaussian(u):
    z = (u - torch.as_tensor(MEAN, dtype=u.dtype)) / torch.as_tensor(SD, dtype=u.dtype)
    return -0.5 * (z * z).sum(-1)


def _reference_normals(key, n_steps, n_mc, dim):
    """The reference's per-step draws: normal(fold_in(key, i), (n_mc, dim))."""
    return torch.tensor(np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(key, i), (n_mc, dim),
                                     jnp.float64)) for i in range(n_steps)]))


def _assert_fits_agree(got, want, rtol):
    want = convert.advi_result_from_jax(want, dtype=torch.float64)
    assert got.full_rank == want.full_rank
    for name in ("mu", "log_sd", "chol_factor", "elbo_trace"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name).numpy(), rtol=rtol, atol=0.0,
                                   err_msg=name)


def test_adam_step_matches_optax():
    rng = np.random.default_rng(0)
    param = rng.standard_normal(5)
    grads = rng.standard_normal((30, 5)) * np.logspace(-3, 2, 5)
    opt = optax.adam(3e-2)
    j_param, j_state = jnp.asarray(param), opt.init(jnp.asarray(param))
    t_param = torch.tensor(param)
    mu, nu = torch.zeros_like(t_param), torch.zeros_like(t_param)
    for step, g in enumerate(grads, start=1):
        updates, j_state = opt.update(jnp.asarray(g), j_state)
        j_param = optax.apply_updates(j_param, updates)
        t_param, mu, nu = mapfit.adam_step(t_param, torch.tensor(g), mu, nu, step, 3e-2)
        np.testing.assert_allclose(t_param.numpy(), np.asarray(j_param), rtol=1e-10)
        np.testing.assert_allclose(mu.numpy(), np.asarray(j_state[0].mu), rtol=1e-10)
        np.testing.assert_allclose(nu.numpy(), np.asarray(j_state[0].nu), rtol=1e-10)


@pytest.mark.parametrize("full_rank", [False, True])
def test_advi_fit_matches_the_reference_on_the_gaussian_target(full_rank):
    key = jax.random.PRNGKey(0)
    n_steps, n_mc, dim = 50, 8, 4
    want = jvi.advi_fit(_j_gaussian, dim, key, n_steps=n_steps, n_mc=n_mc,
                        learning_rate=2e-2, full_rank=full_rank, dtype=jnp.float64)
    got = vi.advi_fit(_t_gaussian, dim, None, n_steps=n_steps, n_mc=n_mc,
                      learning_rate=2e-2, full_rank=full_rank, dtype=torch.float64,
                      eps=_reference_normals(key, n_steps, n_mc, dim))
    _assert_fits_agree(got, want, rtol=1e-8)


@pytest.fixture(scope="module")
def model_pair():
    coords, _, y = simulate_gp_field(np.random.default_rng(9), n=120,
                                     name="exponential", sigma2=1.0, phi=0.3, tau2=0.1)
    jm = JaxResponseNNGP(coords, y, kernel="exponential", m=5, backend="xla",
                         dtype=jnp.float64)
    tm = ResponseNNGP(coords, y, kernel="exponential", m=5, device="cpu",
                      dtype=torch.float64)
    return jm, tm


@pytest.mark.parametrize("full_rank", [False, True])
def test_advi_fit_matches_the_reference_on_a_model(model_pair, full_rank):
    """On ``full_logpost`` of a response NNGP: one differentiated evaluation
    of the step's eight points a step (kernel 2's plain version here), no
    kernel-1 call."""
    jm, tm = model_pair
    key = jax.random.PRNGKey(3)
    n_steps, n_mc, dim = 50, 8, tm.full_dim()
    u0 = np.array(jm._full_init_u(jax.random.PRNGKey(4), None))
    want = jax.jit(lambda: jvi.advi_fit(jm.full_logpost, dim, key, n_steps=n_steps,
                                        n_mc=n_mc, full_rank=full_rank, init_mu=u0,
                                        dtype=jnp.float64))()
    before = (fops.COUNT.plain, dops.COUNT.plain)
    got = vi.advi_fit(tm.full_logpost, dim, None, n_steps=n_steps, n_mc=n_mc,
                      full_rank=full_rank, init_mu=u0, dtype=torch.float64,
                      eps=_reference_normals(key, n_steps, n_mc, dim))
    assert (fops.COUNT.plain - before[0], dops.COUNT.plain - before[1]) == (0, n_steps)
    _assert_fits_agree(got, want, rtol=1e-8)


def test_advi_gaussian_target():
    """tests/test_smc_vi.py's ADVI test and bounds on the port, with that
    test's own draws (PRNGKey(0), 3000 steps of 16 points; the sampling
    draws from PRNGKey(1)).  Its bound on the final iterate is tight against
    the iterate's Monte-Carlo spread: over 60 other keys the reference's own
    fit missed it 13 times, so the port's generator is held to it on average
    over seeds in the next test."""
    key = jax.random.PRNGKey(0)
    res = vi.advi_fit(_t_gaussian, 4, None, n_steps=3000, n_mc=16, learning_rate=2e-2,
                      dtype=torch.float64, eps=_reference_normals(key, 3000, 16, 4))
    np.testing.assert_allclose(res.mu.numpy(), MEAN, atol=0.1)
    np.testing.assert_allclose(np.exp(res.log_sd.numpy()), SD, rtol=0.2)
    eps = torch.tensor(np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4000, 4),
                                                    jnp.float64)))
    draws = vi._q_sample((res.mu, res.log_sd, res.chol_factor), eps, False)
    np.testing.assert_allclose(draws.mean(0).numpy(), MEAN, atol=0.15)


def test_advi_gaussian_target_on_the_ports_generator():
    """The same fit from the port's own generator, four seeds: the mean over
    seeds of the final mean within 0.1 of the target's (the final iterate's
    spread over seeds is at most 0.06, so 0.03 for the mean of four), its
    scales within 20%, and the fitted q's draws within 0.15."""
    fits = [vi.advi_fit(_t_gaussian, 4, torch.Generator().manual_seed(s), n_steps=3000,
                        n_mc=16, learning_rate=2e-2, dtype=torch.float64)
            for s in range(4)]
    mu = np.mean([f.mu.numpy() for f in fits], 0)
    np.testing.assert_allclose(mu, MEAN, atol=0.1)
    sd = np.mean([np.exp(f.log_sd.numpy()) for f in fits], 0)
    np.testing.assert_allclose(sd, SD, rtol=0.2)
    draws = vi.advi_sample(fits[0], torch.Generator().manual_seed(1), 4000)
    np.testing.assert_allclose(draws.mean(0).numpy(), fits[0].mu.numpy(), atol=0.15)


def test_advi_sample_draws_from_the_full_rank_q():
    """A carried-across full-rank fit: draws with mean mu and covariance
    S S', S = tril(chol, -1) + diag(exp(log_sd)), within Monte-Carlo error."""
    rng = np.random.default_rng(2)
    res = jvi.ADVIResult(mu=jnp.asarray(rng.standard_normal(3)),
                         log_sd=jnp.asarray(rng.uniform(-1, 0.5, 3)),
                         chol_factor=jnp.asarray(rng.standard_normal((3, 3))),
                         elbo_trace=jnp.zeros(1), full_rank=True)
    got = convert.advi_result_from_jax(jax.tree.map(np.asarray, res), dtype=torch.float64)
    s = np.tril(np.asarray(res.chol_factor), -1) + np.diag(np.exp(np.asarray(res.log_sd)))
    n = 40_000
    draws = vi.advi_sample(got, torch.Generator().manual_seed(0), n).numpy()
    cov = s @ s.T
    np.testing.assert_allclose(draws.mean(0), np.asarray(res.mu),
                               atol=4 * np.sqrt(np.diag(cov).max() / n))
    np.testing.assert_allclose(np.cov(draws.T), cov, atol=0.05)


def test_fit_advi_on_nngp_reasonable():
    """tests/test_smc_vi.py:108-117 on the port."""
    coords, _, y = simulate_gp_field(np.random.default_rng(1234), n=150,
                                     name="exponential", sigma2=1.0, phi=0.3, tau2=0.1)
    model = ResponseNNGP(coords, y, kernel="exponential", m=6, device="cpu",
                         dtype=torch.float64)
    draws, res = model.fit_advi(n_steps=1500, seed=3)
    elbo = res.elbo_trace.numpy()
    assert elbo[-100:].mean() > elbo[:100].mean()
    assert 0.03 < draws["tau2"].mean() < 0.4
    assert draws["sigma2"].shape == (1000,) and np.isfinite(elbo).all()
