"""The port's tempered SMC (``pynngp_tpu_torch.samplers.smc`` and
``ResponseNNGP.sample_smc``) against the reference's
(``pynngp_tpu.samplers.smc``), float64 on the CPU.

A stage given the reference's own random numbers (regenerated from its keys)
must agree with the reference's stage: at rtol 1e-10 on the Gaussian target
of tests/test_smc_vi.py and at rtol 1e-8 on a small response NNGP (the plain
versions against the reference's XLA path).  Whole runs, whose streams
differ, are held to the reference tests' bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu.models.response import ResponseNNGP as JaxResponseNNGP
from pynngp_tpu.samplers import smc as jsmc
from pynngp_tpu_torch import convert, diagnostics
from pynngp_tpu_torch.models.response import ResponseNNGP
from pynngp_tpu_torch.ops import diff_suffstats as dops
from pynngp_tpu_torch.ops import suffstats as fops
from pynngp_tpu_torch.samplers import smc
from tests.conftest import simulate_gp_field

DIM = 3
MU_STAR = np.array([1.0, -2.0, 0.5])
PRIOR_VAR, LIK_VAR = 4.0, 0.25


@pytest.fixture(scope="module", autouse=True)
def _single_torch_thread():
    """Long loops of small tensor ops: more intra-op threads buy nothing and,
    beside other test workers, cost a great deal."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _j_logprior(u):
    return -0.5 * jnp.sum(u * u) / PRIOR_VAR - 0.5 * DIM * jnp.log(2 * jnp.pi * PRIOR_VAR)


def _j_loglik(u):
    d = u - jnp.asarray(MU_STAR)
    return -0.5 * jnp.sum(d * d) / LIK_VAR - 0.5 * DIM * jnp.log(2 * jnp.pi * LIK_VAR)


def _t_logprior(u):
    return -0.5 * (u * u).sum(-1) / PRIOR_VAR - 0.5 * DIM * np.log(2 * np.pi * PRIOR_VAR)


def _t_loglik(u):
    d = u - torch.as_tensor(MU_STAR, dtype=u.dtype)
    return -0.5 * (d * d).sum(-1) / LIK_VAR - 0.5 * DIM * np.log(2 * np.pi * LIK_VAR)


def _reference_draws(key, n, k, n_move):
    """The random numbers of one reference stage (smc.py:98, 117, 134-143):
    split(key, 3), uniform(k_res, ()), then per move fold_in(k_move, i) split
    into a normal (n, k) and a uniform (n,)."""
    _, k_res, k_move = jax.random.split(key, 3)
    uniform = jax.random.uniform(k_res, (), jnp.float64)
    normals, uniforms = [], []
    for i in range(n_move):
        k1, k2 = jax.random.split(jax.random.fold_in(k_move, i))
        normals.append(np.asarray(jax.random.normal(k1, (n, k), jnp.float64)))
        uniforms.append(np.asarray(jax.random.uniform(k2, (n,), jnp.float64)))
    return (torch.tensor(np.asarray(uniform)), torch.tensor(np.stack(normals)),
            torch.tensor(np.stack(uniforms)))


def _initial_states(u0, j_logprior, j_loglik, t_logprior, t_loglik):
    u0 = np.asarray(u0, np.float64)
    ju = jnp.asarray(u0)
    jstate = jsmc.SMCState(u=ju, loglik=jax.vmap(j_loglik)(ju),
                           logprior=jax.vmap(j_logprior)(ju),
                           logw=jnp.zeros(len(u0)), beta=jnp.zeros(()),
                           log_z=jnp.zeros(()), scale=jnp.ones(()))
    tu = torch.tensor(u0)
    with torch.no_grad():
        tstate = smc.SMCState(u=tu, loglik=t_loglik(tu), logprior=t_logprior(tu),
                              logw=torch.zeros(len(u0), dtype=torch.float64),
                              beta=torch.zeros((), dtype=torch.float64),
                              log_z=torch.zeros((), dtype=torch.float64),
                              scale=torch.ones((), dtype=torch.float64))
    return jstate, tstate


def _assert_stages_agree(jstate, tstate, j_stage, t_stage, key, n_stages, n_move, rtol):
    n, k = tstate.u.shape
    for s in range(n_stages):
        stage_key = jax.random.fold_in(key, s)
        draws = _reference_draws(stage_key, n, k, n_move)
        jstate, jinfo = j_stage(stage_key, jstate)
        with torch.no_grad():
            tstate, tinfo = t_stage(None, tstate, draws=draws)
        carried = convert.smc_state_from_jax(jax.tree.map(np.asarray, jstate),
                                             dtype=torch.float64)
        for name in smc.SMCState._fields:
            np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                       getattr(carried, name).numpy(), rtol=rtol,
                                       atol=0.0, err_msg=f"stage {s}: {name}")
        for name in ("beta", "ess", "accept"):
            np.testing.assert_allclose(float(tinfo[name]), float(jinfo[name]),
                                       rtol=rtol, err_msg=f"stage {s}: {name}")
        assert bool(tinfo["resampled"]) == bool(jinfo["resampled"])
    return tstate


def test_ess_matches():
    rng = np.random.default_rng(0)
    for scale in (0.1, 3.0, 40.0):
        logw = rng.standard_normal(300) * scale
        np.testing.assert_allclose(float(smc._ess(torch.tensor(logw))),
                                   float(jsmc._ess(jnp.asarray(logw))), rtol=1e-12)


@pytest.mark.parametrize("beta", [0.0, 0.3, 0.97])
@pytest.mark.parametrize("target", [0.5, 0.8])
def test_find_next_beta_matches(beta, target):
    rng = np.random.default_rng(1)
    loglik = -50.0 * rng.uniform(size=400) ** 2
    logw = 0.3 * rng.standard_normal(400)
    got = smc._find_next_beta(torch.tensor(loglik), torch.tensor(logw),
                              torch.tensor(beta, dtype=torch.float64), target)
    want = jsmc._find_next_beta(jnp.asarray(loglik), jnp.asarray(logw),
                                jnp.asarray(beta), target)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)


def test_stages_match_the_reference_on_the_gaussian_target():
    n, n_move = 256, 5
    u0 = np.sqrt(PRIOR_VAR) * np.random.default_rng(2).standard_normal((n, DIM))
    jstate, tstate = _initial_states(u0, _j_logprior, _j_loglik, _t_logprior, _t_loglik)
    j_stage = jax.jit(jsmc.make_smc_stage(_j_logprior, _j_loglik, n_move))
    t_stage = smc.make_smc_stage(_t_logprior, _t_loglik, n_move)
    final = _assert_stages_agree(jstate, tstate, j_stage, t_stage,
                                 jax.random.PRNGKey(1), 4, n_move, rtol=1e-10)
    assert float(final.beta) == 1.0  # the last stage reached the posterior


def test_stages_match_the_reference_on_an_nngp_model():
    coords, _, y = simulate_gp_field(np.random.default_rng(4), n=100,
                                     name="exponential", sigma2=1.0, phi=0.3, tau2=0.1)
    jm = JaxResponseNNGP(coords, y, kernel="exponential", m=5, backend="xla",
                         dtype=jnp.float64)
    tm = ResponseNNGP(coords, y, kernel="exponential", m=5, device="cpu",
                      dtype=torch.float64)
    n, n_move = 64, 3
    u0 = jm.sample_prior_u(jax.random.PRNGKey(5), n)
    jstate, tstate = _initial_states(u0, jm.full_logprior, jm.full_loglik,
                                     tm.full_logprior, tm.full_loglik)
    j_stage = jax.jit(jsmc.make_smc_stage(jm.full_logprior, jm.full_loglik, n_move))
    t_stage = smc.make_smc_stage(tm.full_logprior, tm.full_loglik, n_move)
    before = (fops.COUNT.plain, dops.COUNT.plain)
    _assert_stages_agree(jstate, tstate, j_stage, t_stage, jax.random.PRNGKey(6), 3,
                         n_move, rtol=1e-8)
    # each move is one undifferentiated evaluation of all particles (kernel
    # 1's plain version here), never kernel 2's
    assert (fops.COUNT.plain - before[0], dops.COUNT.plain - before[1]) == (3 * n_move, 0)


def test_systematic_resample_matches_the_reference():
    rng = np.random.default_rng(3)
    logw = 2.0 * rng.standard_normal(500)
    for s in range(5):
        key = jax.random.PRNGKey(s)
        uniform = torch.tensor(np.asarray(jax.random.uniform(key, (), jnp.float64)))
        got = smc.systematic_resample(uniform, torch.tensor(logw), 500)
        want = jsmc.systematic_resample(key, jnp.asarray(logw), 500)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_systematic_resample_clamps_an_index_past_the_last_weight():
    """float32 weights whose cumulative sum ends short of 1 (at 1 - 2.4e-7),
    and a uniform just below 1: the last points fall past the sum.  JAX's
    searchsorted returns n there and its gather clamps to n - 1
    (``state.u[idx]``, smc.py:119); the port clamps the index itself."""
    n = 100
    logw = torch.tensor(np.random.default_rng(0).standard_normal(n).astype(np.float32))
    uniform = torch.tensor(np.float32(1.0) - np.float32(2.0**-24))
    cum = torch.cumsum(torch.exp(logw - torch.logsumexp(logw, 0)), 0)
    pts = (uniform + torch.arange(n, dtype=torch.float32)) / n
    assert cum[-1] < 1.0 and cum[-1] < pts[-1]  # the case arises
    got = smc.systematic_resample(uniform, logw, n)
    want = np.asarray(jnp.searchsorted(jnp.asarray(cum.numpy()), jnp.asarray(pts.numpy())))
    assert want[-1] == n and got[-1] == n - 1
    assert np.array_equal(got.numpy(), np.minimum(want, n - 1))


def test_systematic_resample_unbiased():
    gen = torch.Generator().manual_seed(0)
    logw = torch.log(torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=torch.float64))
    counts = np.zeros(4)
    for _ in range(200):
        uniform = torch.rand((), generator=gen, dtype=torch.float64)
        counts += np.bincount(smc.systematic_resample(uniform, logw, 1000).numpy(),
                              minlength=4)
    np.testing.assert_allclose(counts / counts.sum(), [0.1, 0.2, 0.3, 0.4], atol=0.01)


def test_smc_gaussian_target():
    """tests/test_smc_vi.py's Gaussian target and bounds on the port: the
    known posterior and the analytic evidence."""
    prior_sample = lambda gen, n: np.sqrt(PRIOR_VAR) * torch.randn(
        (n, DIM), generator=gen, dtype=torch.float64)
    state, infos = smc.smc_sample(_t_logprior, _t_loglik, prior_sample,
                                  torch.Generator().manual_seed(1),
                                  n_particles=2048, n_move=5)
    assert float(state.beta) == pytest.approx(1.0) and len(infos) < 200
    w = torch.softmax(state.logw, 0).numpy()
    u = state.u.numpy()
    post_var = 1.0 / (1.0 / PRIOR_VAR + 1.0 / LIK_VAR)
    post_mean = post_var * MU_STAR / LIK_VAR
    got_mean = (w[:, None] * u).sum(0)
    np.testing.assert_allclose(got_mean, post_mean, atol=0.1)
    got_var = (w[:, None] * (u - got_mean) ** 2).sum(0)
    np.testing.assert_allclose(got_var, post_var, rtol=0.35)
    want_log_z = float(-0.5 * np.sum(MU_STAR**2) / (PRIOR_VAR + LIK_VAR)
                       - 0.5 * DIM * np.log(2 * np.pi * (PRIOR_VAR + LIK_VAR)))
    assert abs(float(state.log_z) - want_log_z) < 0.25


def test_smc_matches_mcmc_on_nngp():
    """tests/test_smc_vi.py:91-105 on the port: SMC's weighted means against
    the port's MWG on the same model, within the reference test's bound;
    every evaluation undifferentiated (kernel 1's plain version here)."""
    coords, _, y = simulate_gp_field(np.random.default_rng(1234), n=120,
                                     name="exponential", sigma2=1.0, phi=0.3,
                                     tau2=0.1)
    model = ResponseNNGP(coords, y, kernel="exponential", m=6, device="cpu",
                         dtype=torch.float64)
    mwg = model.sample(n_samples=1200, n_burn=400, seed=1)
    before = (fops.COUNT.plain, dops.COUNT.plain)
    draws, infos = model.sample_smc(n_particles=768, n_move=8, seed=2)
    assert (fops.COUNT.plain - before[0], dops.COUNT.plain - before[1]) == \
        (1 + 8 * len(infos), 0)
    w = np.exp(draws["logw"] - np.logaddexp.reduce(draws["logw"]))
    for name in ("sigma2", "tau2", "phi"):
        a = (w * draws[name]).sum()
        b = np.asarray(mwg[name]).mean()
        bsd = np.asarray(mwg[name]).std()
        se = bsd / np.sqrt(max(diagnostics.ess(mwg[name]), 4))
        assert abs(a - b) < 6 * se + 0.15 * bsd, (name, a, b, bsd)
    assert np.isfinite(draws["log_z"])
    assert draws["sigma2"].shape == (768,) and draws["logw"].shape == (768,)


@pytest.mark.parametrize("variant", ["sqexp", "sampled nu and fixed effects"])
def test_sample_prior_u_matches_the_reference_by_moments(variant):
    """Each column's mean and standard deviation within 4 combined
    Monte-Carlo standard errors of the reference's."""
    rng = np.random.default_rng(8)
    coords = rng.uniform(size=(60, 2))
    y = rng.standard_normal(60)
    kw = {}
    if variant != "sqexp":
        kw = dict(x=np.column_stack([np.ones(60), rng.standard_normal(60)]))
    jkernel = "sqexp" if variant == "sqexp" else "matern"
    jm = JaxResponseNNGP(coords, y, kernel=jkernel, m=4, backend="xla",
                         dtype=jnp.float64, **kw)
    tm = ResponseNNGP(coords, y, kernel=jkernel, m=4, device="cpu",
                      dtype=torch.float64, **kw)
    n = 20_000
    want = np.asarray(jm.sample_prior_u(jax.random.PRNGKey(0), n))
    got = tm.sample_prior_u(torch.Generator().manual_seed(0), n).numpy()
    assert got.shape == want.shape == (n, tm.full_dim())
    for j in range(got.shape[1]):
        a, b = got[:, j], want[:, j]
        se_mean = np.sqrt(a.var() / n + b.var() / n)
        assert abs(a.mean() - b.mean()) < 4 * se_mean, (j, a.mean(), b.mean())
        # the standard error of a variance estimate: sqrt((m4 - s^4) / n)
        se_var = np.sqrt((np.mean((a - a.mean()) ** 4) - a.var() ** 2) / n
                         + (np.mean((b - b.mean()) ** 4) - b.var() ** 2) / n)
        assert abs(a.var() - b.var()) < 4 * se_var, (j, a.var(), b.var())
