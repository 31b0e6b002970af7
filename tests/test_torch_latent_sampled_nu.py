"""The latent model with a sampled-nu Matern, whole runs on the CPU in
float64: the port's posterior against the reference's (XLA backend).

The two packages draw different random streams, so the runs are compared by
posterior means within Monte Carlo error: 4 combined standard errors (from
each run's effective sample size) plus 2%, the bound that
tests/test_torch_sampled_nu.py puts on the response model.  It holds the
sampler as a whole to the reference's: a gross fault in the (phi, nu) block or
in the w sweep under ``Matern()`` moves the means or the surface.  It is a
coarse net: with 30 to 60 effective draws per parameter, and nu barely
identified by 120 sites, a step that read a stale w in its theta block
passed it.  Faults of that size are caught exactly, by the tests of
tests/test_torch_latent.py that hold the theta block's target to the
reference's to rtol 1e-8 and every step's cache to the state's own (phi, nu,
w).  The size is small (n = 120, m = 5) because every proposal runs the Bessel
series in eager PyTorch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu import kernels as jkernels
from pynngp_tpu.models.latent import LatentNNGP as JaxLatentNNGP
from pynngp_tpu_torch import diagnostics, kernels
from pynngp_tpu_torch.models.latent import LatentNNGP
from pynngp_tpu_torch.ops import bf as bf_ops

N, M = 120, 5
INIT = {"phi": 0.3, "sigma2": 1.0, "tau2": 0.1, "nu": 0.9}
KEYS = ("sigma2", "phi", "tau2", "nu")
CHAINS, DRAWS, BURN = 4, 800, 300


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
    return coords, w, w + np.sqrt(tau2) * rng.standard_normal(n)


@pytest.fixture(scope="module")
def runs():
    coords, w, y = _matern_draw(43, N)
    jm = JaxLatentNNGP(coords, y, kernel=jkernels.Matern(), m=M, backend="xla",
                       dtype=jnp.float64)
    tm = LatentNNGP(coords, y, kernel=kernels.Matern(), m=M, device="cpu",
                    dtype=torch.float64)
    ref = jm.sample(DRAWS, n_burn=BURN, n_chains=CHAINS, seed=0, init=INIT)
    before = bf_ops.COUNT_NU.plain
    got = tm.sample(DRAWS, n_burn=BURN, n_chains=CHAINS, seed=1, init=INIT)
    # one B/F build per proposal of phi and of nu
    assert bf_ops.COUNT_NU.plain >= before + 2 * (DRAWS + BURN)
    return w, ref, got


def _agree(a, b):
    """|mean a - mean b| within 4 combined Monte Carlo standard errors + 2%."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    se2 = a.var() / max(diagnostics.ess(a), 4) + b.var() / max(diagnostics.ess(b), 4)
    return abs(a.mean() - b.mean()) <= 4.0 * np.sqrt(se2) + 0.02 * abs(b.mean())


@pytest.mark.parametrize("key", KEYS)
def test_posterior_mean_agrees_with_the_reference(runs, key):
    """4 chains x 800 draws after 300 burn-in in each package."""
    _, ref, got = runs
    assert got[key].shape == (CHAINS, DRAWS) and np.isfinite(got[key]).all()
    assert _agree(got[key], ref[key]), (key, got[key].mean(), np.mean(ref[key]))


def test_latent_surface_agrees_with_the_reference_and_the_truth(runs):
    """Site-wise posterior means of w: correlation above 0.98 with the
    reference's (the bound of tests/test_torch_latent.py) and above 0.9 with
    the field the data were drawn from."""
    w, ref, got = runs
    mine = got["w"].mean(axis=(0, 1))
    theirs = np.asarray(ref["w"]).mean(axis=(0, 1))
    assert np.corrcoef(mine, theirs)[0, 1] > 0.98
    assert np.corrcoef(mine, w)[0, 1] > 0.9
