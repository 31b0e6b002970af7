"""The sampled-nu Matern response model, end to end on the CPU in float64:
the joint log-posterior's gradient with its logit-nu entry (and, with fixed
effects, its beta entries through the y cotangent) against the reference's
Pallas backend in interpret mode, and the port's MWG and NUTS posteriors
against the reference's MWG run.

The samplers are held to the reference's MWG and not to its NUTS: on the CPU
the reference's NUTS differentiates K_nu through XLA and needs minutes for a
few dozen transitions at n = 120.  Both packages' samplers are exact for the
one posterior, so means agree within Monte Carlo error whatever the sampler.
Sizes are small (n = 120, m = 5) because every evaluation runs the Bessel
series in eager PyTorch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu import kernels as jkernels
from pynngp_tpu import priors as jpriors
from pynngp_tpu.models.response import ResponseNNGP as JaxResponseNNGP
from pynngp_tpu_torch import diagnostics, kernels, priors
from pynngp_tpu_torch.models.response import ResponseNNGP
from pynngp_tpu_torch.ops import diff_suffstats as dops

INIT = {"phi": 0.3, "alpha": 0.1, "sigma2": 1.0, "nu": 0.9}
KEYS = ("sigma2", "phi", "tau2", "nu")


@pytest.fixture(scope="module", autouse=True)
def _single_torch_thread():
    """Long loops of small tensor ops: more intra-op threads buy nothing and,
    beside other test workers, cost a great deal."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _matern_draw(seed, n, nu=0.8, phi=0.2, tau2=0.1):
    """A dense draw from a unit-variance Matern(nu, phi) GP plus noise."""
    from scipy.special import gamma, kv

    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2))
    d = np.sqrt(((coords[:, None] - coords[None]) ** 2).sum(-1))
    t = np.sqrt(2.0 * nu) * d / phi
    c = np.ones_like(t)
    pos = t > 0
    c[pos] = 2.0 ** (1.0 - nu) / gamma(nu) * t[pos] ** nu * kv(nu, t[pos])
    w = np.linalg.cholesky(c + 1e-10 * np.eye(n)) @ rng.standard_normal(n)
    return coords, w + np.sqrt(tau2) * rng.standard_normal(n)


@pytest.mark.parametrize("with_x", [False, True], ids=["p0", "p2"])
def test_pallas_backend_gradient_with_nu_matches(with_x):
    """full_logpost and its whole gradient, the logit-nu entry and (p = 2) the
    beta entries included, against jax.value_and_grad of the reference on its
    Pallas backend (suff_nu: the with_nu branches of the value+grad kernel,
    with emit_y for p = 2, in interpret mode), float64: rtol 1e-8 of the value
    and of the gradient's largest entry (3e-8 of it for p = 2: the log sigma2
    and log tau2 entries are then differences of terms a few hundred times
    their size, and the two packages' K_nu agree to 1e-10, not to rounding).
    The reference's kernels take (phi,
    alpha, jitter, nu) through a float32 params row, so the point has all four
    exact in float32: phi = 0.3125, alpha = 1, jitter 2^-20, nu = 1.125."""
    rng = np.random.default_rng(12)
    n = 200
    coords = rng.uniform(size=(n, 2))
    x = rng.standard_normal((n, 2)) if with_x else None
    y = rng.standard_normal(n) + (x @ np.array([1.0, -0.5]) if with_x else 0.0)
    kwargs = dict(x=x, m=5, jitter=2.0**-20)
    jm = JaxResponseNNGP(coords, y, kernel=jkernels.Matern(), backend="pallas",
                         dtype=jnp.float64,
                         priors={"phi": jpriors.Uniform(0.0625, 0.5625),
                                 "nu": jpriors.Uniform(0.25, 2.0)}, **kwargs)
    tm = ResponseNNGP(coords, y, kernel=kernels.Matern(), device="cpu",
                      dtype=torch.float64,
                      priors={"phi": priors.Uniform(0.0625, 0.5625),
                              "nu": priors.Uniform(0.25, 2.0)}, **kwargs)
    u = np.array([0.0, 0.0, 0.0, 0.0] + ([0.7, -0.2] if with_x else []))
    assert tm.full_dim() == len(u)
    jv, jg = jax.value_and_grad(jm.full_logpost)(jnp.asarray(u))
    before = (dops.COUNT_NU.plain, dops.COUNT_Y_NU.plain)
    tv, tg = tm.full_value_and_grad(torch.tensor(u)[None])
    assert (dops.COUNT_NU.plain, dops.COUNT_Y_NU.plain) == (
        before[0] + (not with_x), before[1] + with_x)
    np.testing.assert_allclose(tv[0].item(), float(jv), rtol=1e-8)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg[0].numpy(), jg, rtol=1e-8,
                               atol=(3e-8 if with_x else 1e-8) * np.abs(jg).max())
    assert abs(jg[3]) > 1e-6 * np.abs(jg).max()  # the nu entry is really compared


@pytest.fixture(scope="module")
def models():
    coords, y = _matern_draw(43, 120)
    jm = JaxResponseNNGP(coords, y, kernel=jkernels.Matern(), m=5, backend="xla",
                         dtype=jnp.float64)
    tm = ResponseNNGP(coords, y, kernel=kernels.Matern(), m=5, device="cpu",
                      dtype=torch.float64)
    return jm, tm


@pytest.fixture(scope="module")
def reference_draws(models):
    jm, _ = models
    return jm.sample(450, n_burn=150, n_chains=4, seed=0, init=INIT)


def _agree(a, b):
    """|mean a - mean b| within 4 combined Monte Carlo standard errors + 2%."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    se2 = a.var() / max(diagnostics.ess(a), 4) + b.var() / max(diagnostics.ess(b), 4)
    return abs(a.mean() - b.mean()) <= 4.0 * np.sqrt(se2) + 0.02 * abs(b.mean())


def test_mwg_posterior_agrees_with_the_reference(models, reference_draws):
    """The theta block (phi, alpha, nu) of the port's MWG: 4 chains x 300
    draws after 100 burn-in against the reference's 4 x 450."""
    _, tm = models
    draws = tm.sample(300, n_burn=100, n_chains=4, seed=1, init=INIT)
    assert draws["nu"].shape == (4, 300)
    for key in KEYS:
        assert _agree(draws[key], reference_draws[key]), (
            key, draws[key].mean(), np.mean(reference_draws[key]))


def test_nuts_posterior_agrees_with_the_reference(models, reference_draws):
    """The port's sampled-nu NUTS over [log sigma2, logit phi, log tau2, logit
    nu], warm-started from its Laplace fit: 2 chains x 60 draws after 40
    burn-in at max_depth 3."""
    _, tm = models
    mp = tm.fit_map(n_steps=100)
    draws = tm.sample_nuts(60, n_burn=40, n_chains=2, seed=5, max_depth=3,
                           init_u=mp.u, init_inv_mass=mp.laplace_cov,
                           init_jitter=2.0)
    assert all(np.isfinite(v).all() for v in draws.values())
    for key in KEYS:
        assert _agree(draws[key], reference_draws[key]), (
            key, draws[key].mean(), np.mean(reference_draws[key]))
