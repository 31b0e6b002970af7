"""The port's Bessel K_nu (``pynngp_tpu_torch.bessel``) and general-nu Matern
against the reference's (``pynngp_tpu.bessel``, ``pynngp_tpu.kernels.Matern``
and the ``_drho_fn`` / ``_drho_nu_fn`` closures of ``pallas_bf.py``) and against
scipy, on the same numpy-seeded inputs.

Tolerances.  Float64 against the reference rtol 1e-10: the same series, the
same continued fraction, the same recurrence, differing only in log-gamma
(``torch.lgamma`` against the reference's Lanczos sum, absolute error below
1e-13) and the library's exp/sinh.  Against ``scipy.special.kve`` rtol 1e-9.
Float32 against float64 rtol 2e-4 (the series cancels to about 1e-5 at
worst).  The Matern functions rtol 1e-8: they add log, exp and log-gamma of
nu on top."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from pynngp_tpu import bessel as jbessel
from pynngp_tpu import kernels as jkernels
from pynngp_tpu.ops import pallas_bf as pb
from pynngp_tpu_torch import bessel, kernels

NUS = [0.0, 0.3, 0.5, 0.99, 0.9999, 1.0, 1.5, 2.7, 5.25, 10.6]


def _x(n=400):
    rng = np.random.default_rng(0)
    return np.exp(rng.uniform(np.log(1e-6), np.log(60.0), n))


@pytest.mark.parametrize("nu", NUS)
def test_kve_matches_jax_and_scipy(nu):
    x = _x()
    got = bessel.kve(torch.as_tensor(x), nu).numpy()
    np.testing.assert_allclose(got, np.asarray(jbessel.kve(jnp.asarray(x), nu)),
                               rtol=1e-10)
    np.testing.assert_allclose(got, scipy.special.kve(nu, x), rtol=1e-9)


@pytest.mark.parametrize("nu", [0.3, 0.9999, 2.7])
def test_kv_and_log_kve_match_jax(nu):
    x = _x()[:100]
    np.testing.assert_allclose(bessel.kv(torch.as_tensor(x), nu).numpy(),
                               np.asarray(jbessel.kv(jnp.asarray(x), nu)),
                               rtol=1e-10, atol=1e-300)
    np.testing.assert_allclose(bessel.log_kve(torch.as_tensor(x), nu).numpy(),
                               np.asarray(jbessel.log_kve(jnp.asarray(x), nu)),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("nu", [0.0, 0.3, 0.5, 0.99, 0.9999, 1.0, 1.5, 2.7])
def test_kve_float32_against_float64(nu):
    """Float32 over the range the Matern kernels reach (x >= 1e-4: far below,
    K_nu itself overflows float32 for the larger orders)."""
    x = _x()
    x = x[x >= 1e-4]
    got = bessel.kve(torch.as_tensor(x, dtype=torch.float32), nu)
    assert got.dtype == torch.float32
    want = bessel.kve(torch.as_tensor(x), nu).numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4)


def test_kve_broadcasts_nu_per_element():
    x = torch.as_tensor(_x()[:60]).reshape(3, 20)
    nu = torch.tensor([[0.3], [1.0001], [2.7]], dtype=torch.float64)
    got = bessel.kve(x, nu)
    assert got.shape == (3, 20)
    for row, v in enumerate((0.3, 1.0001, 2.7)):
        np.testing.assert_allclose(got[row].numpy(),
                                   scipy.special.kve(v, x[row].numpy()), rtol=1e-9)


@pytest.mark.parametrize("nu", [0.3, 1.0, 2.7])
def test_kve_derivatives_match_jax(nu):
    """d/dx exact through K_{nu+1}: rtol 1e-8.  d/dnu is the same central
    difference with h = 1e-4 in both packages; the difference of two
    neighbouring values loses digits, so it is held to rtol 1e-5."""
    x = _x()[:100]
    xt = torch.as_tensor(x).requires_grad_(True)
    nut = torch.full_like(xt, nu).requires_grad_(True)
    gx, gnu = torch.autograd.grad(bessel.kve(xt, nut).sum(), (xt, nut))
    jx = jax.vmap(jax.grad(jbessel.kve, argnums=(0, 1)))(
        jnp.asarray(x), jnp.full(x.shape, nu))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jx[0]), rtol=1e-8)
    np.testing.assert_allclose(gnu.numpy(), np.asarray(jx[1]), rtol=1e-5, atol=1e-12)


def _distances():
    rng = np.random.default_rng(1)
    d = rng.uniform(0.0, 1.5, 300)
    d[:3] = 0.0  # rho(0) = 1, drho(0) = 0 exactly
    d[3] = 1e-12
    return d


@pytest.mark.parametrize("nu", [0.15, 0.8, 1.0, 1.7, 2.9])
def test_matern_matches_jax(nu):
    d, phi = _distances(), 0.2
    dt = torch.as_tensor(d)
    kern, jkern = kernels.Matern(), jkernels.Matern()
    assert kern.param_names == jkern.param_names == ("phi", "nu")
    assert kern.samples_nu and kern.family == 6
    got = kern.correlation(dt, {"phi": torch.tensor(phi, dtype=torch.float64),
                                "nu": torch.tensor(nu, dtype=torch.float64)})
    want = jkern.correlation(jnp.asarray(d), {"phi": jnp.float64(phi),
                                              "nu": jnp.float64(nu)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8)
    assert (got[:3] == 1.0).all()
    # the fused kernels' rho and its two derivatives (pallas_bf.py closures)
    args = (jnp.asarray(d), jnp.float64(phi), jnp.float64(nu))
    phit = torch.tensor(phi, dtype=torch.float64)
    fused = kern.fused_correlation(dt, {"phi": phit, "nu": nu})
    np.testing.assert_allclose(fused.numpy(), np.asarray(pb._rho_fn(jkern)(*args)),
                               rtol=1e-8)
    dphi = kern.dcorrelation_dphi(dt, phit, nu)
    np.testing.assert_allclose(dphi.numpy(), np.asarray(pb._drho_fn(jkern)(*args)),
                               rtol=1e-8, atol=1e-300)
    assert (dphi[:4] == 0.0).all()
    dnu = kern.dcorrelation_dnu(dt, phit, nu)
    np.testing.assert_allclose(dnu.numpy(), np.asarray(pb._drho_nu_fn(jkern)(*args)),
                               rtol=1e-8, atol=1e-14)


def test_static_general_nu_matches_jax():
    d, phi = _distances(), 0.3
    kern, jkern = kernels.Matern(nu=0.8), jkernels.Matern(nu=0.8)
    assert kern.param_names == ("phi",) and not kern.samples_nu
    assert kern.family == 6 and repr(kern) == repr(jkern)
    got = kern.correlation(torch.as_tensor(d), {"phi": torch.tensor(phi, dtype=torch.float64)})
    want = jkern.correlation(jnp.asarray(d), {"phi": jnp.float64(phi)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_general_nu_equals_closed_forms(nu):
    """The Bessel path at a half-integer nu against the closed form: rtol
    1e-9 on rho and d rho / d phi.  The distance below the floor of t is left
    out: there the general form returns (1, 0) where the closed form has a
    derivative of order t."""
    d = _distances()
    d = torch.as_tensor(d[(d == 0.0) | (d > 1e-6)])
    phi = torch.tensor(0.2, dtype=torch.float64)
    closed, general = kernels.Matern(nu=nu), kernels.Matern()
    assert closed.family == 3 + (0.5, 1.5, 2.5).index(nu)
    np.testing.assert_allclose(
        general.correlation(d, {"phi": phi, "nu": nu}).numpy(),
        closed.correlation(d, {"phi": phi}).numpy(), rtol=1e-9)
    np.testing.assert_allclose(general.dcorrelation_dphi(d, phi, nu).numpy(),
                               closed.dcorrelation_dphi(d, phi).numpy(),
                               rtol=1e-9, atol=1e-300)


def test_series_terms_counts_converged_loops():
    """The loop counts the CUDA routine runs: a handful of Temme terms at
    small x, more towards x = 2, and CF2 steps that fall as x grows."""
    x = torch.tensor([1e-3, 0.1, 1.0, 2.0, 2.5, 10.0, 60.0], dtype=torch.float64)
    count, small = bessel.series_terms(x, 0.3)
    assert small.tolist() == [True, True, True, True, False, False, False]
    c = count.tolist()
    assert 1 <= c[0] <= c[1] <= c[2] <= c[3] <= 15
    assert 25 >= c[4] >= c[5] >= c[6] >= 1
