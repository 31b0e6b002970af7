"""The port's differentiable suffstats (kernel 2's plain version on CPU
tensors) against ``jax.grad`` of the reference's ``make_diff_suffstats``
(Pallas value+grad kernel in interpret mode), in float64, rtol 1e-8; and
``torch.autograd.gradcheck`` of the analytic derivatives; the same for the
y cotangent (``y_grad=True``), with the planes B and r/F it is formed from.
The general-nu Matern cases (``suff_nu``: phi, alpha, nu and, with
``y_grad=True``, y) run at n = 300, m = 6, nu rounded to float32 like phi and
alpha: interpret mode with the Bessel series is slow."""

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
from pynngp_tpu_torch.ops.site_tables import make_site_tables, with_children

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


NU_A, NU_B = float(np.float32(0.8)), float(np.float32(1.7))


def _problem(n, m, seed):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2))
    y = rng.standard_normal(n)
    jdata, jtab = jvecchia.make_vecchia_data(coords, m)
    cache = pb.make_lane_cache(jdata, dtype=jnp.float64, layout="dist")
    y_ord = y[jtab.order]
    data, _ = vecchia.make_vecchia_data(coords, m, dtype=torch.float32, device="cpu")
    return {"cache": cache, "y_jax": jnp.asarray(y_ord, jnp.float64),
            "tables": make_site_tables(data, dtype=torch.float64, device="cpu"),
            "y": torch.as_tensor(y_ord)}


@pytest.fixture(scope="module")
def problem():
    return _problem(1500, 7, seed=3)


@pytest.fixture(scope="module")
def nu_problem():
    return _problem(300, 6, seed=5)


@pytest.mark.parametrize("y_grad", [False, True], ids=["y_data", "y_grad"])
def test_sampled_nu_value_and_grad_match_jax(nu_problem, y_grad):
    """(logdet, quad) and the gradient in (phi, alpha, nu) and, with y_grad,
    y, against jax.grad of make_diff_suffstats's suff_nu (the with_nu
    branches of _grad_kernel in interpret mode).  Float64, rtol 1e-8; dy also
    atol 1e-10 of its largest entry."""
    jkern, kern = jkernels.Matern(), kernels.Matern()
    p = nu_problem
    suff = pb.make_diff_suffstats(jkern, p["cache"], jitter=JITTER, y_grad=y_grad)

    def scalar(phi, alpha, y, nu):
        ld, q = suff(phi, alpha, y, nu)
        return 0.7 * ld + 1.3 * q, (ld, q)

    vg = jax.jit(jax.value_and_grad(scalar, argnums=(0, 1, 2, 3), has_aux=True))
    tables = with_children(p["tables"])
    leaf = lambda v: torch.tensor(v, dtype=torch.float64, requires_grad=True)
    phi, alpha = leaf([a for a, _ in POINTS]), leaf([a for _, a in POINTS])
    nu = leaf([NU_A, NU_B])
    y = p["y"].clone().requires_grad_(y_grad)
    before = (dops.COUNT_NU.plain, dops.COUNT_Y_NU.plain)
    ld, q = dops.diff_suffstats(kern, tables, phi, alpha, y, JITTER, nu)
    assert (dops.COUNT_NU.plain, dops.COUNT_Y_NU.plain) == (
        before[0] + (not y_grad), before[1] + y_grad)
    leaves = (phi, alpha, nu) + ((y,) if y_grad else ())
    grads = [torch.autograd.grad((0.7 * ld + 1.3 * q)[c], leaves, retain_graph=True)
             for c in range(len(POINTS))]
    ld, q = ld.detach(), q.detach()
    for c, ((ph, al), v) in enumerate(zip(POINTS, (NU_A, NU_B))):
        (_, (ld_j, q_j)), (gp_j, ga_j, gy_j, gn_j) = vg(
            jnp.float64(ph), jnp.float64(al), p["y_jax"], jnp.float64(v))
        np.testing.assert_allclose(float(ld[c]), float(ld_j), rtol=1e-8)
        np.testing.assert_allclose(float(q[c]), float(q_j), rtol=1e-8)
        np.testing.assert_allclose(float(grads[c][0][c]), float(gp_j), rtol=1e-8)
        np.testing.assert_allclose(float(grads[c][1][c]), float(ga_j), rtol=1e-8)
        np.testing.assert_allclose(float(grads[c][2][c]), float(gn_j), rtol=1e-8)
        if y_grad:
            gy_j = np.asarray(gy_j)
            np.testing.assert_allclose(grads[c][3].numpy(), gy_j, rtol=1e-8,
                                       atol=1e-10 * np.abs(gy_j).max())


def test_static_general_nu_value_and_grad_match_jax(nu_problem):
    """``Matern(nu=0.8)``: the general family with a static nu runs the same
    plain version without the nu sums (eight sums, the last two exactly 0).
    The oracle is the reference's sampled-nu function at the same nu: its
    three-argument function leaves the nu slot of the gradient kernel at 0
    for a static general nu."""
    kern = kernels.Matern(nu=NU_A)
    p = nu_problem
    suff = pb.make_diff_suffstats(jkernels.Matern(), p["cache"], jitter=JITTER)

    def scalar(phi, alpha):
        ld, q = suff(phi, alpha, p["y_jax"], jnp.float64(NU_A))
        return 0.7 * ld + 1.3 * q, (ld, q)

    vg = jax.jit(jax.value_and_grad(scalar, argnums=(0, 1), has_aux=True))
    leaf = lambda v: torch.tensor(v, dtype=torch.float64, requires_grad=True)
    phi, alpha = leaf([a for a, _ in POINTS]), leaf([a for _, a in POINTS])
    ld, q = dops.diff_suffstats(kern, p["tables"], phi, alpha, p["y"], JITTER)
    dphi, dalpha = torch.autograd.grad((0.7 * ld + 1.3 * q).sum(), (phi, alpha))
    for c, (ph, al) in enumerate(POINTS):
        (_, (ld_j, q_j)), (gp_j, ga_j) = vg(jnp.float64(ph), jnp.float64(al))
        np.testing.assert_allclose(float(ld[c].detach()), float(ld_j), rtol=1e-8)
        np.testing.assert_allclose(float(q[c].detach()), float(q_j), rtol=1e-8)
        np.testing.assert_allclose(float(dphi[c]), float(gp_j), rtol=1e-8)
        np.testing.assert_allclose(float(dalpha[c]), float(ga_j), rtol=1e-8)
    sums = dops.value_and_grad_sums(kern, p["tables"], phi.detach(), alpha.detach(),
                                    p["y"], JITTER)
    assert sums.shape == (8, 2) and (sums[6:] == 0).all()


def test_nu_derivative_is_the_kernels_central_difference():
    """The nu derivative of the plain version is the derivative of (logdet,
    quad) under the kernels' difference quotient of rho: it agrees with a
    central difference of the VALUE in nu to the O(h^2) of the two stencils
    (rtol 2e-3 at h = 1e-2), not to rounding."""
    rng = np.random.default_rng(8)
    data, _ = vecchia.make_vecchia_data(rng.uniform(size=(150, 2)), 5,
                                        dtype=torch.float64, device="cpu")
    tables = make_site_tables(data, dtype=torch.float64, device="cpu")
    y = torch.as_tensor(rng.standard_normal(150))
    kern = kernels.Matern()
    phi = torch.tensor([0.2, 0.35], dtype=torch.float64)
    alpha = torch.tensor([0.1, 0.3], dtype=torch.float64)
    nu = torch.tensor([0.7, 1.9], dtype=torch.float64, requires_grad=True)
    ld, q = dops.diff_suffstats(kern, tables, phi, alpha, y, JITTER, nu)
    g_ld, = torch.autograd.grad(ld.sum(), nu, retain_graph=True)
    g_q, = torch.autograd.grad(q.sum(), nu)
    with torch.no_grad():
        h = 1e-4
        up = dops.diff_suffstats(kern, tables, phi, alpha, y, JITTER, nu + h)
        dn = dops.diff_suffstats(kern, tables, phi, alpha, y, JITTER, nu - h)
    np.testing.assert_allclose(g_ld.numpy(), ((up[0] - dn[0]) / (2 * h)).numpy(),
                               rtol=2e-3)
    np.testing.assert_allclose(g_q.numpy(), ((up[1] - dn[1]) / (2 * h)).numpy(),
                               rtol=2e-3)


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
    data, tab = vecchia.make_vecchia_data(coords, m, dtype=torch.float64, device="cpu")
    tables = make_site_tables(data, dtype=torch.float64, device="cpu")
    y = torch.as_tensor(rng.standard_normal(n))
    phi = torch.tensor([0.2, 0.35], dtype=torch.float64, requires_grad=True)
    alpha = torch.tensor([0.1, 0.3], dtype=torch.float64, requires_grad=True)
    fn = lambda p, a: dops.DiffSuffstats.apply(p, a, y, kern, tables, JITTER, None)
    assert torch.autograd.gradcheck(fn, (phi, alpha))


def _tiny():
    rng = np.random.default_rng(9)
    data, _ = vecchia.make_vecchia_data(rng.uniform(size=(100, 2)), 4,
                                        dtype=torch.float64, device="cpu")
    y = torch.as_tensor(rng.standard_normal(100))
    return make_site_tables(data, dtype=torch.float64, device="cpu"), y


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
    """The y cotangent is ported: it raises only where the tables lack the
    reverse neighbor index it gathers through."""
    tables, y = _tiny()
    phi = torch.tensor([0.3], dtype=torch.float64, requires_grad=True)
    y = y.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="with_children"):
        _, q = dops.diff_suffstats(kernels.SqExp(), tables, phi, 0.1, y)
        q.sum().backward()
    _, q = dops.diff_suffstats(kernels.SqExp(), with_children(tables), phi, 0.1, y)
    q.sum().backward()
    assert y.grad.shape == y.shape and torch.isfinite(y.grad).all()


# ---- the y cotangent (y_grad=True, the EMIT_Y variant of kernel 2) ---------


@pytest.mark.parametrize("jkern,kern", KERNELS[:3], ids=[repr(k[1]) for k in KERNELS[:3]])
def test_y_gradient_matches_jax(problem, jkern, kern):
    """(logdet, quad) and the gradient with respect to (phi, alpha, y) against
    jax.grad of make_diff_suffstats(y_grad=True), the Pallas value+grad kernel
    with emit_y in interpret mode, as tests/test_pallas.py:185-209 runs it.
    Float64, rtol 1e-8 (dy also atol 1e-10 of its largest entry: single
    entries cancel to near zero)."""
    suff = pb.make_diff_suffstats(jkern, problem["cache"], jitter=JITTER,
                                  y_grad=True)

    def scalar(phi, alpha, y):
        ld, q = suff(phi, alpha, y)
        return 0.7 * ld + 1.3 * q, (ld, q)

    vg = jax.jit(jax.value_and_grad(scalar, argnums=(0, 1, 2), has_aux=True))
    tables = with_children(problem["tables"])
    phi = torch.tensor([p for p, _ in POINTS], dtype=torch.float64,
                       requires_grad=True)
    alpha = torch.tensor([a for _, a in POINTS], dtype=torch.float64,
                         requires_grad=True)
    y = problem["y"].clone().requires_grad_(True)
    ld, q = dops.diff_suffstats(kern, tables, phi, alpha, y, JITTER)
    # one scalar per chain, so that the shared y's gradient splits by chain
    dy = [torch.autograd.grad((0.7 * ld + 1.3 * q)[c], (phi, alpha, y),
                              retain_graph=True) for c in range(len(POINTS))]
    ld, q = ld.detach(), q.detach()
    for c, (p, a) in enumerate(POINTS):
        (_, (ld_j, q_j)), (gp_j, ga_j, gy_j) = vg(jnp.float64(p), jnp.float64(a),
                                                  problem["y_jax"])
        np.testing.assert_allclose(float(ld[c]), float(ld_j), rtol=1e-8)
        np.testing.assert_allclose(float(q[c]), float(q_j), rtol=1e-8)
        np.testing.assert_allclose(float(dy[c][0][c]), float(gp_j), rtol=1e-8)
        np.testing.assert_allclose(float(dy[c][1][c]), float(ga_j), rtol=1e-8)
        gy_j = np.asarray(gy_j)
        np.testing.assert_allclose(dy[c][2].numpy(), gy_j, rtol=1e-8,
                                   atol=1e-10 * np.abs(gy_j).max())


def test_emitted_planes_match_jax(problem):
    """B and r/F of the plain version (what the EMIT_Y kernel writes) against
    pallas_bf and pallas_suffstats in interpret mode: rtol 1e-8 (B also atol
    1e-12), and exactly 0 at padded sites and in invalid slots."""
    jkern, kern = KERNELS[0]
    tables = problem["tables"]
    n, m = tables.n, tables.m
    phi = torch.tensor([p for p, _ in POINTS], dtype=torch.float64)
    alpha = torch.tensor([a for _, a in POINTS], dtype=torch.float64)
    _, b, rof = dops.value_and_grad_sums(kern, tables, phi, alpha, problem["y"],
                                         JITTER, emit_y=True)
    assert b.shape == (2, m, tables.n_pad) and rof.shape == (2, tables.n_pad)
    assert tables.n_pad > n
    assert (b[:, :, n:] == 0).all() and (rof[:, n:] == 0).all()
    assert all((b[:, k, :k + 1] == 0).all() for k in range(m))
    for c, (p, a) in enumerate(POINTS):
        params = {"phi": jnp.float64(p)}
        b_j, _ = pb.pallas_bf(jkern, params, problem["cache"], alpha=a, jitter=JITTER)
        _, _, f4, r4 = pb.pallas_suffstats(jkern, params, problem["cache"],
                                           problem["y_jax"], alpha=a, jitter=JITTER)
        rof_j = (np.asarray(r4) / np.asarray(f4)).reshape(-1)[:n]
        np.testing.assert_allclose(b[c, :, :n].T.numpy(), np.asarray(b_j),
                                   rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(rof[c, :n].numpy(), rof_j, rtol=1e-8, atol=1e-14)


def test_per_chain_y_equals_separate_calls(problem):
    """A (C, n) y gives, chain by chain, what C calls with a shared y give:
    values, phi and alpha gradients and dy, differentiated and not."""
    kern = kernels.Exponential()
    tables = with_children(problem["tables"])
    rng = np.random.default_rng(4)
    ys = torch.as_tensor(rng.standard_normal((2, tables.n)))
    phi = torch.tensor([p for p, _ in POINTS], dtype=torch.float64)
    alpha = torch.tensor([a for _, a in POINTS], dtype=torch.float64)
    with torch.no_grad():
        ld0, q0 = dops.diff_suffstats(kern, tables, phi, alpha, ys, JITTER)
    leaves = [t.clone().requires_grad_(True) for t in (phi, alpha, ys)]
    ld, q = dops.diff_suffstats(kern, tables, *leaves, JITTER)
    grads = torch.autograd.grad((0.7 * ld + 1.3 * q).sum(), leaves)
    torch.testing.assert_close(ld.detach(), ld0, rtol=1e-12, atol=0.0)
    torch.testing.assert_close(q.detach(), q0, rtol=1e-12, atol=0.0)
    for c in range(2):
        one = [phi[c:c + 1].clone().requires_grad_(True),
               alpha[c:c + 1].clone().requires_grad_(True),
               ys[c].clone().requires_grad_(True)]
        ld1, q1 = dops.diff_suffstats(kern, tables, *one, JITTER)
        g1 = torch.autograd.grad((0.7 * ld1 + 1.3 * q1).sum(), one)
        torch.testing.assert_close(ld[c].detach(), ld1[0].detach(), rtol=1e-12, atol=0.0)
        torch.testing.assert_close(q[c].detach(), q1[0].detach(), rtol=1e-12, atol=0.0)
        torch.testing.assert_close(grads[0][c], g1[0][0], rtol=1e-11, atol=0.0)
        torch.testing.assert_close(grads[1][c], g1[1][0], rtol=1e-11, atol=0.0)
        torch.testing.assert_close(grads[2][c], g1[2], rtol=1e-11, atol=1e-14)


@pytest.mark.parametrize("per_chain", [False, True], ids=["shared", "per_chain"])
def test_gradcheck_y(per_chain):
    rng = np.random.default_rng(8)
    n, m = 60, 4
    data, _ = vecchia.make_vecchia_data(rng.uniform(size=(n, 2)), m,
                                        dtype=torch.float64, device="cpu")
    tables = with_children(make_site_tables(data, dtype=torch.float64, device="cpu"))
    y = torch.as_tensor(rng.standard_normal((2, n) if per_chain else n))
    y.requires_grad_(True)
    phi = torch.tensor([0.2, 0.35], dtype=torch.float64, requires_grad=True)
    alpha = torch.tensor([0.1, 0.3], dtype=torch.float64, requires_grad=True)
    kern = kernels.Matern(nu=1.5)
    fn = lambda p, a, yy: dops.DiffSuffstats.apply(p, a, yy, kern, tables, JITTER, None)
    assert torch.autograd.gradcheck(fn, (phi, alpha, y))


def test_dy_gather_equals_scatter():
    """The deterministic gather of dquad_dy against the reference's own
    formulation, a scatter-add of -2 B (r/F) onto the neighbors
    (pallas_bf.py:1082-1091), on random planes."""
    rng = np.random.default_rng(2)
    data, _ = vecchia.make_vecchia_data(rng.uniform(size=(300, 2)), 6,
                                        dtype=torch.float64, device="cpu")
    tables = with_children(make_site_tables(data, dtype=torch.float64, device="cpu"))
    n, m, n_pad = tables.n, tables.m, tables.n_pad
    site = torch.arange(n_pad)
    mask = (site[None, :] > torch.arange(m)[:, None]) & (site < n)[None, :]
    b = torch.as_tensor(rng.standard_normal((3, m, n_pad))) * mask
    rof = torch.as_tensor(rng.standard_normal((3, n_pad))) * (site < n)
    got = dops.dquad_dy(tables, b, rof)
    want = 2.0 * rof.clone()
    idx = tables.nn_idx.long().reshape(-1)
    for c in range(3):
        want[c].index_add_(0, idx, (-2.0 * b[c] * rof[c][None, :]).reshape(-1))
    torch.testing.assert_close(got, want[:, :n], rtol=1e-12, atol=1e-13)
