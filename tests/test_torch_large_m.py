"""m = 25 and m = 32 (the rolled instances of the three kernels on the card)
and m = 40 (the large-m instances) in the plain versions on CPU tensors, and
m = 240 for kernels 1 and 3 (their cluster body on the card, above
geometry.M_SMEM),
against the reference's XLA Vecchia functions (``vecchia_bf``, ``vecchia_suffstats``) in float64: kernel 1's
sums and planes, kernel 2's value and gradient with respect to (phi, alpha,
y) (the EMIT_Y planes and the y cotangent), kernel 3's B/F.  The Pallas
kernels in interpret mode take minutes a call at these m, so the
reference's plain path stands in for them; it agrees with interpret mode to
~1e-10 at the m the other files test (tests/test_torch_bf.py).  rtol 1e-8.

Both sides factor the same float32 distances held in float64, with
parameters exact in float32 as the reference's ``_params_vec`` rounds them.
Both models at m = 40 on CPU tensors: the response model's log-posterior and
gradient and the latent model's theta-block value, B, F and log-likelihood
against the reference's models (XLA backend), rtol 1e-8."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu import kernels as jkernels
from pynngp_tpu import vecchia as jvecchia
from pynngp_tpu.models.latent import LatentNNGP as JaxLatentNNGP
from pynngp_tpu.models.response import ResponseNNGP as JaxResponseNNGP
from pynngp_tpu_torch import kernels, vecchia
from pynngp_tpu_torch.models.latent import LatentNNGP
from pynngp_tpu_torch.models.response import ResponseNNGP
from pynngp_tpu_torch.ops import bf as bops
from pynngp_tpu_torch.ops import diff_suffstats as dops
from pynngp_tpu_torch.ops import geometry
from pynngp_tpu_torch.ops import suffstats as fops
from pynngp_tpu_torch.ops.site_tables import make_site_tables, with_children

JITTER = 2.0**-20
PHIS = (0.25, 0.125, 0.5)  # C = 3 chains
ALPHAS = (0.125, 0.25, 0.0625)


@functools.lru_cache(maxsize=None)
def _problem(m):
    rng = np.random.default_rng(11)
    n = 300  # pads to 384
    coords = rng.uniform(size=(n, 2))
    y = rng.standard_normal(n)
    jdata, jtab = jvecchia.make_vecchia_data(coords, m)
    jdata64 = jdata._replace(nn_dist=jnp.asarray(jdata.nn_dist, jnp.float64),
                             nn_cross_dist=jnp.asarray(jdata.nn_cross_dist, jnp.float64))
    data, _ = vecchia.make_vecchia_data(coords, m, dtype=torch.float32, device="cpu")
    tables = with_children(make_site_tables(data, dtype=torch.float64, device="cpu"))
    # m = 25 and 32 run the rolled instance (M = 32), m = 40 and 240 the
    # large-m ones
    assert tables.m == m and fops.cuda_instance_m(m) == (32 if m <= 32 else m)
    y_ord = y[jtab.order]
    return {"n": n, "m": m, "jdata": jdata64, "tables": tables,
            "y": torch.as_tensor(y_ord), "y_jax": jnp.asarray(y_ord, jnp.float64)}


@pytest.fixture(scope="module", params=[25, 32, 40], ids=["m25", "m32", "m40"])
def problem(request):
    return _problem(request.param)


@pytest.fixture(scope="module", params=[25, 32, 40, 240], ids=["m25", "m32", "m40", "m240"])
def problem13(request):
    """The problems of kernels 1 and 3: also m = 240, where the card runs
    their cluster body."""
    if request.param == 240:
        assert geometry.large_body("vecchia_bf", 240) == "cluster"
    return _problem(request.param)


@jax.jit
def _reference_jit(phi, alpha, jdata, y):
    b, f = jvecchia.vecchia_bf(jkernels.SqExp(), {"phi": phi}, jdata, alpha=alpha,
                               jitter=JITTER)
    ld, q, r = jvecchia.vecchia_suffstats(b, f, y, jdata)
    return ld, q, r, b, f


def _reference(problem, phi, alpha):
    """(logdet, quad, resid, b, f) of the reference's XLA path."""
    return _reference_jit(phi, alpha, problem["jdata"], problem["y_jax"])


def _chains():
    return (torch.tensor(PHIS, dtype=torch.float64),
            torch.tensor(ALPHAS, dtype=torch.float64))


def test_suffstats_at_large_m_match_the_reference(problem13):
    problem = problem13
    n = problem["n"]
    phi, alpha = _chains()
    ld, q, f, r = fops.suffstats(kernels.SqExp(), problem["tables"], phi, alpha,
                                 problem["y"], JITTER)
    for c, (p, a) in enumerate(zip(PHIS, ALPHAS)):
        ld_j, q_j, r_j, _, f_j = _reference(problem, jnp.float64(p), jnp.float64(a))
        np.testing.assert_allclose(float(ld[c]), float(ld_j), rtol=1e-8)
        np.testing.assert_allclose(float(q[c]), float(q_j), rtol=1e-8)
        np.testing.assert_allclose(f[c, :n].numpy(), np.asarray(f_j), rtol=1e-8)
        np.testing.assert_allclose(r[c, :n].numpy(), np.asarray(r_j), rtol=1e-8,
                                   atol=1e-10)


def test_value_and_gradient_with_y_at_large_m_match_the_reference(problem):
    """(logdet, quad) and d(0.7 logdet + 1.3 quad)/d(phi, alpha, y) against
    jax.grad of the reference's plain path (dy also atol 1e-10 of its largest
    entry), and the EMIT_Y planes B and r/F against its B and r/F."""
    n, m = problem["n"], problem["m"]
    tables = problem["tables"]
    phi, alpha = (t.requires_grad_(True) for t in _chains())
    y = problem["y"].clone().requires_grad_(True)
    ld, q = dops.diff_suffstats(kernels.SqExp(), tables, phi, alpha, y, JITTER)
    grads = [torch.autograd.grad((0.7 * ld + 1.3 * q)[c], (phi, alpha, y),
                                 retain_graph=True) for c in range(len(PHIS))]
    ld, q = ld.detach(), q.detach()
    _, b, rof = dops.value_and_grad_sums(kernels.SqExp(), tables, phi.detach(),
                                         alpha.detach(), problem["y"], JITTER,
                                         emit_y=True)
    assert b.shape == (3, m, tables.n_pad)

    def scalar(p, a, yy):
        b_j, f_j = jvecchia.vecchia_bf(jkernels.SqExp(), {"phi": p}, problem["jdata"],
                                       alpha=a, jitter=JITTER)
        ld_j, q_j, _ = jvecchia.vecchia_suffstats(b_j, f_j, yy, problem["jdata"])
        return 0.7 * ld_j + 1.3 * q_j, (ld_j, q_j)

    vg = jax.jit(jax.value_and_grad(scalar, argnums=(0, 1, 2), has_aux=True))
    for c, (p, a) in enumerate(zip(PHIS, ALPHAS)):
        (_, (ld_j, q_j)), (gp, ga, gy) = vg(jnp.float64(p), jnp.float64(a), problem["y_jax"])
        np.testing.assert_allclose(float(ld[c]), float(ld_j), rtol=1e-8)
        np.testing.assert_allclose(float(q[c]), float(q_j), rtol=1e-8)
        np.testing.assert_allclose(float(grads[c][0][c]), float(gp), rtol=1e-8)
        np.testing.assert_allclose(float(grads[c][1][c]), float(ga), rtol=1e-8)
        gy = np.asarray(gy)
        np.testing.assert_allclose(grads[c][2].numpy(), gy, rtol=1e-8,
                                   atol=1e-10 * np.abs(gy).max())
        _, _, r_j, b_j, f_j = _reference(problem, jnp.float64(p), jnp.float64(a))
        np.testing.assert_allclose(b[c, :, :n].T.numpy(), np.asarray(b_j), rtol=1e-8,
                                   atol=1e-12)
        np.testing.assert_allclose(rof[c, :n].numpy(), np.asarray(r_j / f_j), rtol=1e-8,
                                   atol=1e-14)


def test_bf_at_large_m_matches_the_reference(problem13):
    problem = problem13
    n = problem["n"]
    phi, alpha = _chains()
    b, f = bops.bf(kernels.SqExp(), problem["tables"], phi, alpha, JITTER)
    for c, (p, a) in enumerate(zip(PHIS, ALPHAS)):
        _, _, _, b_j, f_j = _reference(problem, jnp.float64(p), jnp.float64(a))
        np.testing.assert_allclose(b[c].numpy(), np.asarray(b_j), rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(f[c].numpy(), np.asarray(f_j), rtol=1e-8)
    assert b.shape == (3, n, problem["m"])


def _model_data(n=200, seed=21):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2))
    y = np.sin(6.0 * coords[:, 0]) * np.cos(4.0 * coords[:, 1]) + 0.3 * rng.standard_normal(n)
    return coords, y, rng.standard_normal(n)


@pytest.mark.parametrize("u", [(0.1, -1.0, -2.0), (-0.3, 0.5, -1.2)])
def test_response_model_at_large_m_matches_the_reference(u):
    """ResponseNNGP with m = 40 (the large-m instances on the card, their
    plain versions here): the log-posterior and its gradient."""
    coords, y, _ = _model_data()
    jm = JaxResponseNNGP(coords, y, kernel="sqexp", m=40, backend="xla", dtype=jnp.float64)
    tm = ResponseNNGP(coords, y, kernel="sqexp", m=40, device="cpu", dtype=torch.float64)
    assert tm.tables.m == 40
    jv, jg = jax.value_and_grad(jm.full_logpost)(jnp.asarray(u, jnp.float64))
    ut = torch.tensor(u, dtype=torch.float64, requires_grad=True)
    tv = tm.full_logpost(ut)
    (tg,) = torch.autograd.grad(tv, ut)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-8)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-8)


def test_latent_model_at_large_m_matches_the_reference():
    """LatentNNGP with m = 40: the theta-block value with its B and F, and
    the log-likelihood of the same state."""
    coords, y, w0 = _model_data()
    n = coords.shape[0]
    init = {"phi": 0.3, "sigma2": 0.9, "tau2": 0.15, "w": w0}
    jm = JaxLatentNNGP(coords, y, kernel="exponential", m=40, backend="xla",
                       dtype=jnp.float64)
    tm = LatentNNGP(coords, y, kernel="exponential", m=40, device="cpu",
                    dtype=torch.float64)
    js = jm.init_state(jax.random.PRNGKey(0), init)
    ts = tm.init_state(2, init)
    theta = np.array([-0.7])
    v_j, aux_j = jm._theta_logpost(jnp.asarray(theta), js.w, js.sigma2)
    v_t, aux_t = tm._theta_logpost(torch.as_tensor(theta).expand(2, 1), ts.w, ts.sigma2)
    np.testing.assert_allclose(v_t.numpy(), np.full(2, float(v_j)), rtol=1e-8)
    np.testing.assert_allclose(aux_t["b"][0, :, :n].T.numpy(), np.asarray(aux_j["b"]),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(aux_t["f"][0, :n].numpy(), np.asarray(aux_j["f"]), rtol=1e-8)
    np.testing.assert_allclose(tm.loglik(ts).numpy(), np.full(2, float(jm.loglik(js))),
                               rtol=1e-8)
