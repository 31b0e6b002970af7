"""NUTS and HMC over the joint posterior with fixed effects (p = 2), where
every leapfrog step goes through the y cotangent of the differentiable
suffstats: the port's draws against its own MWG sampler and the reference's
NUTS on the same data.  Float64 on the CPU; posterior means within 4 combined
Monte Carlo standard errors plus 2% (the RNG streams differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu.models.response import ResponseNNGP as JaxResponseNNGP
from pynngp_tpu_torch import diagnostics
from pynngp_tpu_torch.models.response import ResponseNNGP


@pytest.fixture(scope="module", autouse=True)
def _single_torch_thread():
    """These tests are long loops of small tensor ops: more intra-op threads
    buy nothing and, beside other test workers, cost a great deal."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(42)
    n = 250
    coords = rng.uniform(size=(n, 2))
    x = np.column_stack([np.ones(n), rng.standard_normal(n)])
    y = (np.sin(6.0 * coords[:, 0]) * np.cos(4.0 * coords[:, 1])
         + 0.3 * rng.standard_normal(n) + x @ np.array([1.0, -2.0]))
    tm = ResponseNNGP(coords, y, kernel="exponential", m=6, x=x, device="cpu",
                      dtype=torch.float64)
    jm = JaxResponseNNGP(coords, y, kernel="exponential", m=6, x=x,
                         backend="xla", dtype=jnp.float64)
    mwg = tm.sample(1000, n_burn=300, n_chains=4, seed=8,
                    init={"phi": 0.3, "alpha": 0.1, "sigma2": 0.9})
    return tm, jm, tm.fit_map(n_steps=150), mwg


def _agree(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    se2 = a.var() / max(diagnostics.ess(a), 4) + b.var() / max(diagnostics.ess(b), 4)
    return abs(a.mean() - b.mean()) <= 4.0 * np.sqrt(se2) + 0.02 * abs(b.mean())


def _check(got, other):
    for key in ("sigma2", "tau2"):
        assert _agree(got[key], other[key]), key
    for j in range(2):
        assert _agree(got["beta"][..., j], other["beta"][..., j]), ("beta", j)


def test_sample_nuts_with_fixed_effects(problem):
    tm, jm, mp, mwg = problem
    got = tm.sample_nuts(250, n_burn=150, n_chains=4, seed=7, max_depth=6,
                         init_u=mp.u, init_inv_mass=mp.laplace_cov, init_jitter=2.0)
    assert set(got) == {"sigma2", "phi", "tau2", "logpost", "diverging", "depth",
                        "n_leapfrog", "beta"}
    assert got["beta"].shape == (4, 250, 2) and got["phi"].shape == (4, 250)
    assert all(np.isfinite(v).all() for v in got.values())
    assert abs(got["beta"][..., 1].mean() + 2.0) < 0.1
    _check(got, mwg)
    ref = jm.sample_nuts(n_samples=300, n_burn=250, n_chains=2, seed=3, max_depth=6)
    _check(got, {k: np.asarray(v) for k, v in ref.items()})


def test_sample_hmc_with_fixed_effects(problem):
    tm, _, mp, mwg = problem
    got = tm.sample_hmc(300, n_burn=200, n_chains=4, seed=3, n_leapfrog=12,
                        init_u=mp.u, init_inv_mass=mp.laplace_cov)
    assert got["phi"].shape == (4, 300) and got["beta"].shape == (4, 300, 2)
    assert 0.0 < got["accept_prob"].mean() <= 1.0
    assert all(np.isfinite(v).all() for v in got.values())
    assert abs(got["beta"][..., 1].mean() + 2.0) < 0.1
    _check(got, mwg)
