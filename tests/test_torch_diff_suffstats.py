"""The port's differentiable suffstats (kernel 2's plain version on CPU
tensors) against ``jax.grad`` of the reference's ``make_diff_suffstats``
(Pallas value+grad kernel in interpret mode), in float64, rtol 1e-8; and
``torch.autograd.gradcheck`` of the analytic derivatives."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu import kernels as jkernels
from pynngp_tpu import vecchia as jvecchia
from pynngp_tpu.ops import pallas_bf as pb
from pynngp_tpu_torch import kernels, vecchia
from pynngp_tpu_torch.ops import diff_suffstats as dops
from pynngp_tpu_torch.ops import suffstats as fops
from pynngp_tpu_torch.ops.site_tables import make_site_tables

JITTER = 2.0**-20
POINTS = ((0.25, 0.125), (0.5, 0.0625))  # (phi, alpha) of C = 2 chains
KERNELS = [
    (jkernels.SqExp(), kernels.SqExp()),
    (jkernels.Exponential(), kernels.Exponential()),
    (jkernels.Spherical(), kernels.Spherical()),
    (jkernels.Matern(nu=0.5), kernels.Matern(nu=0.5)),
    (jkernels.Matern(nu=1.5), kernels.Matern(nu=1.5)),
    (jkernels.Matern(nu=2.5), kernels.Matern(nu=2.5)),
]


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(3)
    n, m = 1500, 7
    coords = rng.uniform(size=(n, 2))
    y = rng.standard_normal(n)
    jdata, jtab = jvecchia.make_vecchia_data(coords, m)
    cache = pb.make_lane_cache(jdata, dtype=jnp.float64, layout="dist")
    y_ord = y[jtab.order]
    data, _ = vecchia.make_vecchia_data(coords, m, dtype=torch.float32)
    return {"cache": cache, "y_jax": jnp.asarray(y_ord, jnp.float64),
            "tables": make_site_tables(data, dtype=torch.float64),
            "y": torch.as_tensor(y_ord)}


@pytest.mark.parametrize("jkern,kern", KERNELS, ids=[repr(k[1]) for k in KERNELS])
def test_value_and_grad_match_jax(problem, jkern, kern):
    suff = pb.make_diff_suffstats(jkern, problem["cache"], jitter=JITTER)

    def scalar(phi, alpha):
        ld, q = suff(phi, alpha, problem["y_jax"])
        return 0.7 * ld + 1.3 * q, (ld, q)

    vg = jax.jit(jax.value_and_grad(scalar, argnums=(0, 1), has_aux=True))
    phi = torch.tensor([p for p, _ in POINTS], dtype=torch.float64,
                       requires_grad=True)
    alpha = torch.tensor([a for _, a in POINTS], dtype=torch.float64,
                         requires_grad=True)
    ld, q = dops.diff_suffstats(kern, problem["tables"], phi, alpha,
                                problem["y"], JITTER)
    dphi, dalpha = torch.autograd.grad((0.7 * ld + 1.3 * q).sum(), (phi, alpha))
    ld, q = ld.detach(), q.detach()
    for c, (p, a) in enumerate(POINTS):
        (_, (ld_j, q_j)), (gp_j, ga_j) = vg(jnp.float64(p), jnp.float64(a))
        np.testing.assert_allclose(float(ld[c]), float(ld_j), rtol=1e-8)
        np.testing.assert_allclose(float(q[c]), float(q_j), rtol=1e-8)
        np.testing.assert_allclose(float(dphi[c]), float(gp_j), rtol=1e-8)
        np.testing.assert_allclose(float(dalpha[c]), float(ga_j), rtol=1e-8)


@pytest.mark.parametrize("kern", [kernels.SqExp(), kernels.Spherical(),
                                  kernels.Matern(nu=2.5)],
                         ids=lambda k: repr(k))
def test_gradcheck_plain_version(kern):
    rng = np.random.default_rng(8)
    n, m = 150, 5
    coords = rng.uniform(size=(n, 2))
    data, tab = vecchia.make_vecchia_data(coords, m, dtype=torch.float64)
    tables = make_site_tables(data, dtype=torch.float64)
    y = torch.as_tensor(rng.standard_normal(n))
    phi = torch.tensor([0.2, 0.35], dtype=torch.float64, requires_grad=True)
    alpha = torch.tensor([0.1, 0.3], dtype=torch.float64, requires_grad=True)
    fn = lambda p, a: dops.DiffSuffstats.apply(p, a, y, kern, tables, JITTER)
    assert torch.autograd.gradcheck(fn, (phi, alpha))


def _tiny():
    rng = np.random.default_rng(9)
    data, _ = vecchia.make_vecchia_data(rng.uniform(size=(100, 2)), 4,
                                        dtype=torch.float64)
    y = torch.as_tensor(rng.standard_normal(100))
    return make_site_tables(data, dtype=torch.float64), y


def test_undifferentiated_call_runs_the_forward_kernel_only():
    tables, y = _tiny()
    phi = torch.tensor([0.3], dtype=torch.float64, requires_grad=True)
    before = (fops.COUNT.plain, dops.COUNT.plain)
    with torch.no_grad():
        ld, q = dops.diff_suffstats(kernels.SqExp(), tables, phi, 0.1, y)
    assert (fops.COUNT.plain, dops.COUNT.plain) == (before[0] + 1, before[1])
    ld2, q2 = dops.diff_suffstats(kernels.SqExp(), tables, phi, 0.1, y)
    assert (fops.COUNT.plain, dops.COUNT.plain) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(ld2.detach(), ld, rtol=1e-12, atol=0.0)
    torch.testing.assert_close(q2.detach(), q, rtol=1e-12, atol=0.0)


def test_y_cotangent_raises_until_ported():
    tables, y = _tiny()
    phi = torch.tensor([0.3], dtype=torch.float64, requires_grad=True)
    with pytest.raises(NotImplementedError):
        dops.diff_suffstats(kernels.SqExp(), tables, phi, 0.1,
                            y.clone().requires_grad_(True))
