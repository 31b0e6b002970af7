"""The CUDA kernels against their plain versions on the card, at small size.
Marked ``cuda``: they skip where torch sees no CUDA device, and run on the
card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(``--noconftest``: tests/conftest.py imports JAX, which the port does not
need).  The first test in a process builds the kernels with nvcc (about two
minutes)."""

import numpy as np
import pytest
import torch

from pynngp_tpu_torch import kernels
from pynngp_tpu_torch.models.latent import LatentNNGP
from pynngp_tpu_torch.models.response import ResponseNNGP
from pynngp_tpu_torch.ops import bf as bops
from pynngp_tpu_torch.ops import diff_suffstats as dops
from pynngp_tpu_torch.ops import geometry
from pynngp_tpu_torch.ops import suffstats as fops
from pynngp_tpu_torch.ops.site_tables import make_site_tables, with_children
from pynngp_tpu_torch.vecchia import make_vecchia_data

pytestmark = pytest.mark.cuda

KERNELS = [kernels.SqExp(), kernels.Exponential(), kernels.Spherical(),
           kernels.Matern(nu=0.5), kernels.Matern(nu=1.5), kernels.Matern(nu=2.5)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (no interpret mode for CUDA kernels)")
    return torch.device("cuda", 0)


def _problem(dev, n=1500, m=7, seed=3, layout="dist", dim=2):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, dim))
    data, tab = make_vecchia_data(coords, m, precompute_distances=layout == "dist", device="cpu")
    tab32 = make_site_tables(data, dtype=torch.float32, device=dev, layout=layout,
                             coords_host=coords[tab.order])
    # the same float32 tables in float64: on the coords layout the plain
    # version recomputes the distances from the same coordinates
    tab64 = tab32.to(torch.float64)
    y = torch.as_tensor(rng.standard_normal(n)[tab.order], dtype=torch.float32,
                        device=dev)
    phi = torch.tensor([0.1, 0.3, 0.5], device=dev)
    alpha = torch.tensor([0.05, 0.15, 0.3], device=dev)
    return tab32, tab64, y, phi, alpha


@pytest.mark.parametrize("kern", KERNELS, ids=lambda k: repr(k))
@pytest.mark.parametrize("m", [7, 10, 15, 20])
def test_forward_kernel_matches_plain(card, kern, m):
    tab32, tab64, y, phi, alpha = _problem(card, m=m)
    launches = fops.COUNT.launches
    ld, q, f, r = fops.suffstats(kern, tab32, phi, alpha, y)
    torch.cuda.synchronize()
    assert fops.COUNT.launches == launches + 1
    params = fops.params_array(phi.double(), alpha.double(), np.float32(1e-6),
                               tab32.n, torch.float64, card)
    ld_p, q_p, f_p, r_p = fops.suffstats_reference(kern, tab64, params, y.double())
    n = tab32.n
    torch.testing.assert_close(ld.double(), ld_p, rtol=3e-4, atol=0.0)
    torch.testing.assert_close(q.double(), q_p, rtol=3e-4, atol=0.0)
    torch.testing.assert_close(f[:, :n].double(), f_p[:, :n], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(r[:, :n].double(), r_p[:, :n], rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("kern", KERNELS, ids=lambda k: repr(k))
def test_grad_kernel_matches_plain(card, kern):
    tab32, tab64, y, phi, alpha = _problem(card)
    got = dops.value_and_grad_sums(kern, tab32, phi, alpha, y).double()
    params = fops.params_array(phi.double(), alpha.double(), np.float32(1e-6),
                               tab32.n, torch.float64, card)
    want = dops.grad_reference(kern, tab64, params, y.double())
    torch.testing.assert_close(got[:2], want[:2], rtol=5e-4, atol=0.0)
    torch.testing.assert_close(got[2:], want[2:], rtol=2e-4, atol=0.0)


@pytest.mark.parametrize("kern", KERNELS, ids=lambda k: repr(k))
@pytest.mark.parametrize("m", [7, 10, 15, 20])
def test_bf_kernel_matches_plain(card, kern, m):
    """Kernel 3 in float32 against its float64 plain version, with the
    nugget the reference's own bf test uses: B atol 3e-5, F rtol 3e-5
    (tests/test_pallas.py:80-81); padded sites hold B = 0, F = 1."""
    tab32, tab64, _, phi, alpha = _problem(card, m=m)
    launches = bops.COUNT.launches
    b, f = bops.bf_planes(kern, tab32, phi, alpha)
    torch.cuda.synchronize()
    assert bops.COUNT.launches == launches + 1
    params = fops.params_array(phi.double(), alpha.double(), np.float32(1e-6),
                               tab32.n, torch.float64, card)
    b_p, f_p = bops.bf_reference(kern, tab64, params)
    n = tab32.n
    assert b.shape == (3, m, tab32.n_pad) and f.shape == (3, tab32.n_pad)
    torch.testing.assert_close(b[:, :, :n].double(), b_p[:, :, :n], rtol=0.0,
                               atol=3e-5)
    torch.testing.assert_close(f[:, :n].double(), f_p[:, :n], rtol=3e-5, atol=0.0)
    assert (b[:, :, n:] == 0).all() and (f[:, n:] == 1).all()
    rows_b, rows_f = bops.bf(kern, tab32, phi, alpha)
    assert rows_b.shape == (3, n, m) and rows_f.shape == (3, n)


@pytest.mark.parametrize("kern", [kernels.Exponential(), kernels.Matern(nu=0.5),
                                  kernels.Spherical()], ids=lambda k: repr(k))
def test_bf_kernel_without_nugget(card, kern):
    """alpha = 0 (the latent model) with the rough, well-conditioned
    families and no jitter: finite everywhere, padded sites included, and
    within B atol 1e-3, F rtol 1e-3 of the float64 plain version."""
    tab32, tab64, _, phi, _ = _problem(card)
    zero = torch.zeros_like(phi)
    b, f = bops.bf_planes(kern, tab32, phi, zero, jitter=0.0)
    torch.cuda.synchronize()
    assert torch.isfinite(b).all() and torch.isfinite(f).all()
    params = fops.params_array(phi.double(), zero.double(), 0.0, tab32.n,
                               torch.float64, card)
    b_p, f_p = bops.bf_reference(kern, tab64, params)
    torch.testing.assert_close(b.double(), b_p, rtol=0.0, atol=1e-3)
    torch.testing.assert_close(f.double(), f_p, rtol=1e-3, atol=0.0)


def test_latent_and_fixed_effects_models_go_through_kernel_3(card):
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(2000, 2))
    x = np.column_stack([np.ones(2000), rng.standard_normal(2000)])
    y = np.sin(5 * coords[:, 0]) + 0.3 * rng.standard_normal(2000)
    before = (bops.COUNT.launches, bops.COUNT.plain)
    latent = LatentNNGP(coords, y, m=7, device="cuda")
    draws = latent.sample(30, n_burn=20, n_chains=4, seed=0, w_every=8)
    again = latent.sample(30, n_burn=20, n_chains=4, seed=0, w_every=8)
    assert draws["w"].shape == (4, 4, 2000)
    assert bops.COUNT.launches >= before[0] + 102
    for key in draws:  # reproducible on one card from one seed
        np.testing.assert_array_equal(draws[key], again[key], err_msg=key)
    mid = bops.COUNT.launches
    model = ResponseNNGP(coords, y + x @ np.array([1.0, -2.0]), m=7, x=x,
                         device="cuda")
    fixed = model.sample(30, n_burn=20, n_chains=4, seed=0)
    assert bops.COUNT.launches > mid and bops.COUNT.plain == before[1]
    assert abs(fixed["beta"][..., 1].mean() + 2.0) < 0.1
    for out in (draws, fixed):
        assert all(np.isfinite(v).all() for v in out.values())


def test_model_on_card_goes_through_the_kernels(card):
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(2000, 2))
    y = np.sin(5 * coords[:, 0]) + 0.3 * rng.standard_normal(2000)
    model = ResponseNNGP(coords, y, m=7, device="cuda")
    before = (fops.COUNT.launches, dops.COUNT.launches, fops.COUNT.plain,
              dops.COUNT.plain)
    mp = model.fit_map(n_steps=20)
    draws = model.sample(50, n_burn=20, n_chains=4, seed=0,
                         proposal_cov=model.theta_proposal_cov(mp.laplace_cov))
    assert fops.COUNT.launches > before[0] and dops.COUNT.launches > before[1]
    assert (fops.COUNT.plain, dops.COUNT.plain) == before[2:]
    assert all(np.isfinite(v).all() for v in draws.values())


# ---- the EMIT_Y instances of kernel 2 and the gradient samplers -------------


def _y_problem(dev, m, per_chain, n=1500, seed=3):
    tab32, tab64, y, phi, alpha = _problem(dev, n=n, m=m, seed=seed)
    tab32, tab64 = with_children(tab32), with_children(tab64)
    if per_chain:
        rng = np.random.default_rng(seed + 1)
        y = y + 0.1 * torch.as_tensor(rng.standard_normal((3, n)),
                                      dtype=torch.float32, device=dev)
    params = fops.params_array(phi.double(), alpha.double(), np.float32(1e-6),
                               tab32.n, torch.float64, dev)
    return tab32, tab64, y, phi, alpha, params


@pytest.mark.parametrize("per_chain", [False, True], ids=["shared_y", "per_chain_y"])
@pytest.mark.parametrize("m", [7, 10, 15, 20])
def test_grad_y_kernel_matches_plain(card, m, per_chain):
    """The EMIT_Y instances in float32 against the float64 plain version: the
    six sums at kernel 2's tolerances, B atol 3e-5 (kernel 3's), r/F at kernel
    1's limit for r (rtol 2e-3, atol 1e-4); B and r/F exactly 0 at padded
    sites and B in invalid slots; one launch of the EMIT_Y count only."""
    kern = kernels.Exponential()
    tab32, tab64, y, phi, alpha, params = _y_problem(card, m, per_chain)
    before = (dops.COUNT_Y.launches, dops.COUNT.launches)
    sums, b, rof = dops.value_and_grad_sums(kern, tab32, phi, alpha, y, emit_y=True)
    torch.cuda.synchronize()
    assert (dops.COUNT_Y.launches, dops.COUNT.launches) == (before[0] + 1, before[1])
    want, b_p, rof_p = dops.grad_reference(kern, tab64, params, y.double(), emit_y=True)
    n = tab32.n
    assert b.shape == (3, m, tab32.n_pad) and rof.shape == (3, tab32.n_pad)
    torch.testing.assert_close(sums.double()[:2], want[:2], rtol=5e-4, atol=0.0)
    torch.testing.assert_close(sums.double()[2:], want[2:], rtol=2e-4, atol=0.0)
    torch.testing.assert_close(b.double(), b_p, rtol=0.0, atol=3e-5)
    torch.testing.assert_close(rof.double(), rof_p, rtol=2e-3, atol=1e-4)
    assert (b[:, :, n:] == 0).all() and (rof[:, n:] == 0).all()
    assert all((b[:, k, :k + 1] == 0).all() for k in range(m))
    # kernels 1 and 2 read the same per-chain y
    ld, q, _, _ = fops.suffstats(kern, tab32, phi, alpha, y)
    torch.testing.assert_close(ld.double(), want[0], rtol=3e-4, atol=0.0)
    torch.testing.assert_close(q.double(), want[1], rtol=3e-4, atol=0.0)
    plain = dops.value_and_grad_sums(kern, tab32, phi, alpha, y)
    torch.testing.assert_close(plain, sums, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("per_chain", [False, True], ids=["shared_y", "per_chain_y"])
@pytest.mark.parametrize("kern", KERNELS, ids=lambda k: repr(k))
def test_y_cotangent_on_the_card_matches_float64(card, kern, per_chain):
    """dquad/dy and the phi, alpha gradients through DiffSuffstats on the card
    (EMIT_Y kernel + gather) against autograd through the float64 plain
    factorization: dy rtol 2e-3, atol 2e-4 (tests/test_pallas.py:205-209,
    taken there at alpha = 0.12).  dy is a sum of terms r/F with F >= alpha,
    so its absolute error grows as 1/alpha: the chain at alpha = 0.05 is held
    to atol 2e-4 * 0.12 / 0.05.  The gather gives the same bits twice."""
    tab32, tab64, y, _, alpha, _ = _y_problem(card, 7, per_chain)
    _check_y_cotangent(card, kern, tab32, tab64, y, alpha, per_chain)


@pytest.mark.parametrize("per_chain", [False, True], ids=["shared_y", "per_chain_y"])
def test_y_cotangent_at_m_64_on_coords_matches_float64(card, per_chain):
    """The y cotangent where float32 state once missed its limit: m = 64 on
    the coords layout, kernel 2-EMIT_Y on its shared-memory body, at the
    same limits (dy rtol 2e-3, atol 2e-4 scaled by 0.12 / alpha)."""
    rng = np.random.default_rng(3)
    n = 1500
    coords = rng.uniform(size=(n, 2))
    data, tab = make_vecchia_data(coords, 64, precompute_distances=False, device="cpu")
    tab32 = with_children(make_site_tables(data, dtype=torch.float32, device=card,
                                           layout="coords", coords_host=coords[tab.order]))
    tab64 = tab32.to(torch.float64)
    y = torch.as_tensor(rng.standard_normal(n)[tab.order], dtype=torch.float32, device=card)
    if per_chain:
        y = y + 0.1 * torch.as_tensor(rng.standard_normal((3, n)), dtype=torch.float32,
                                      device=card)
    alpha = torch.tensor([0.05, 0.15, 0.3], device=card)
    assert geometry.large_body("vecchia_grad", 64) == "smem"
    _check_y_cotangent(card, kernels.SqExp(), tab32, tab64, y, alpha, per_chain)


def _check_y_cotangent(card, kern, tab32, tab64, y, alpha, per_chain):
    """dquad/dy and the phi, alpha gradients of chains phi = 0.1, 0.3, 0.5
    through DiffSuffstats on the card against autograd through the float64
    plain factorization, and the same bits twice."""
    phi = torch.tensor([0.1, 0.3, 0.5], device=card)
    leaves = [t.clone().requires_grad_(True) for t in (phi, alpha, y)]
    ld, q = dops.diff_suffstats(kern, tab32, *leaves)
    got = torch.autograd.grad((0.7 * ld + 1.3 * q).sum(), leaves)
    ld2, q2 = dops.diff_suffstats(kern, tab32, *leaves)
    again = torch.autograd.grad((0.7 * ld2 + 1.3 * q2).sum(), leaves)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = [t.double().clone().requires_grad_(True) for t in (phi, alpha, y)]
    pr = fops.params_array(ref[0], ref[1], np.float32(1e-6), tab64.n,
                           torch.float64, card)
    ld_p, q_p, _, _ = fops.suffstats_reference(kern, tab64, pr, ref[2])
    want = torch.autograd.grad((0.7 * ld_p + 1.3 * q_p).sum(), ref)
    torch.testing.assert_close(got[0].double(), want[0], rtol=2e-4, atol=0.0)
    torch.testing.assert_close(got[1].double(), want[1], rtol=2e-4, atol=0.0)
    dy, dy_ref = got[2].double(), want[2]
    if not per_chain:  # the chains' cotangents add up: the loosest limit holds
        dy, dy_ref = dy[None], dy_ref[None]
        atol = [2e-4 * max(1.0, 0.12 / float(alpha.min()))]
    else:
        atol = [2e-4 * max(1.0, 0.12 / float(a)) for a in alpha]
    for c, limit in enumerate(atol):
        torch.testing.assert_close(dy[c], dy_ref[c], rtol=2e-3, atol=limit)


def test_gradient_samplers_on_card_go_through_kernel_2(card):
    """fit_map, sample_nuts and sample_hmc on the card, with and without
    fixed effects: every value-and-gradient is one kernel-2 launch (the
    EMIT_Y instances with x=), no plain version is called, and two runs from
    one seed give identical draws."""
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(2000, 2))
    x = np.column_stack([np.ones(2000), rng.standard_normal(2000)])
    y = np.sin(5 * coords[:, 0]) + 0.3 * rng.standard_normal(2000)
    plain = (fops.COUNT.plain, dops.COUNT.plain, dops.COUNT_Y.plain)

    model = ResponseNNGP(coords, y, m=7, device="cuda")
    mp = model.fit_map(n_steps=60)
    kwargs = dict(n_burn=40, n_chains=4, seed=0, max_depth=5, init_u=mp.u,
                  init_inv_mass=mp.laplace_cov, init_jitter=2.0)
    before = (dops.COUNT.launches, dops.COUNT_Y.launches)
    draws = model.sample_nuts(40, **kwargs)
    assert dops.COUNT.launches >= before[0] + 80
    assert dops.COUNT_Y.launches == before[1]
    again = model.sample_nuts(40, **kwargs)
    for key in draws:
        np.testing.assert_array_equal(draws[key], again[key], err_msg=key)
    hmc_draws = model.sample_hmc(20, n_burn=20, n_chains=4, seed=1, n_leapfrog=8,
                                 init_u=mp.u, init_inv_mass=mp.laplace_cov)

    fixed = ResponseNNGP(coords, y + x @ np.array([1.0, -2.0]), m=7, x=x,
                         device="cuda")
    mpx = fixed.fit_map(n_steps=100)
    before = dops.COUNT_Y.launches
    kwargs.update(init_u=mpx.u, init_inv_mass=mpx.laplace_cov)
    fx = fixed.sample_nuts(60, **kwargs)
    assert dops.COUNT_Y.launches >= before + 100
    fx_again = fixed.sample_nuts(60, **kwargs)
    for key in fx:
        np.testing.assert_array_equal(fx[key], fx_again[key], err_msg=key)
    assert fx["beta"].shape == (4, 60, 2)
    assert abs(fx["beta"][..., 1].mean() + 2.0) < 0.1
    for out in (draws, hmc_draws, fx):
        assert all(np.isfinite(v).all() for v in out.values())
    assert (fops.COUNT.plain, dops.COUNT.plain, dops.COUNT_Y.plain) == plain


@pytest.mark.parametrize("per_chain", [False, True], ids=["shared_y", "per_chain_y"])
def test_host_parameters_with_device_tables(card, per_chain):
    """phi and alpha on the host, tables and y on the card: the values and
    the phi, alpha gradients come back on the host and equal, bit for bit,
    those of parameters that live on the card; dy stays on the card."""
    kern = kernels.SqExp()
    tab32, _, y, phi, alpha, _ = _y_problem(card, 7, per_chain)
    on_card = [t.clone().requires_grad_(True) for t in (phi, alpha, y)]
    on_host = [phi.cpu().requires_grad_(True), alpha.cpu().requires_grad_(True),
               y.clone().requires_grad_(True)]
    out = []
    for leaves in (on_card, on_host):
        ld, q = dops.diff_suffstats(kern, tab32, *leaves)
        assert ld.device == leaves[0].device and q.device == leaves[0].device
        out.append((ld, q) + torch.autograd.grad((0.7 * ld + 1.3 * q).sum(), leaves))
        with torch.no_grad():
            ld0, _ = dops.diff_suffstats(kern, tab32, *leaves)
        assert ld0.device == leaves[0].device
    for a, b in zip(*out):
        assert torch.equal(a.detach().cpu(), b.detach().cpu())
    assert out[1][2].device.type == "cpu" and out[1][4].is_cuda


# ---- the general-nu Matern instances (Bessel K_nu inside the kernels) -------

NU_CHAINS = (0.3, 1.0001, 2.4)  # below 1/2, next to an integer, two recurrence steps
NU_KERNELS = [(kernels.Matern(), True), (kernels.Matern(nu=0.8), False)]
_NU_IDS = ["sampled", "static"]


def _nu_args(card, kern, sampled, m):
    """(tables 32, tables 64, y, phi, alpha, nu or None, float64 params)."""
    tab32, tab64, y, phi, alpha = _problem(card, m=m)
    nu = torch.tensor(NU_CHAINS, device=card) if sampled else None
    params = fops.params_array(phi.double(), alpha.double(), np.float32(1e-6),
                               tab32.n, torch.float64, card,
                               fops.kernel_nu(kern, None if nu is None else nu.double()))
    return tab32, tab64, y, phi, alpha, nu, params


@pytest.mark.parametrize("kern,sampled", NU_KERNELS, ids=_NU_IDS)
@pytest.mark.parametrize("m", [7, 10, 15, 20])
def test_general_nu_forward_kernel_matches_plain(card, kern, sampled, m):
    """Kernel 1's general-nu instances against the float64 plain version:
    sums rtol 5e-5, F rtol 1e-3 / atol 1e-5, r rtol 2e-3 / atol 2e-4 (the
    float32 series for K_nu carries up to 1e-5 relative noise in rho)."""
    tab32, tab64, y, phi, alpha, nu, params = _nu_args(card, kern, sampled, m)
    before = (fops.COUNT.launches, fops.COUNT_NU.launches)
    ld, q, f, r = fops.suffstats(kern, tab32, phi, alpha, y, nu=nu)
    torch.cuda.synchronize()
    assert (fops.COUNT.launches, fops.COUNT_NU.launches) == (before[0], before[1] + 1)
    ld_p, q_p, f_p, r_p = fops.suffstats_reference(kern, tab64, params, y.double())
    n = tab32.n
    torch.testing.assert_close(ld.double(), ld_p, rtol=5e-5, atol=0.0)
    torch.testing.assert_close(q.double(), q_p, rtol=5e-5, atol=0.0)
    torch.testing.assert_close(f[:, :n].double(), f_p[:, :n], rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(r[:, :n].double(), r_p[:, :n], rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("kern,sampled", NU_KERNELS, ids=_NU_IDS)
@pytest.mark.parametrize("emit_y", [False, True], ids=["sums", "emit_y"])
@pytest.mark.parametrize("m", [7, 10, 15, 20])
def test_general_nu_grad_kernel_matches_plain(card, kern, sampled, emit_y, m):
    """Kernel 2's general-nu instances: eight sums against the float64 plain
    version, values rtol 5e-5, phi and alpha sums rtol 2e-4, nu sums rtol 5e-2
    (a difference of two float32 rho over a width of 2e-2) and exactly 0 for
    a static nu; with emit_y B atol 1e-4 and r/F rtol 2e-3 / atol 2e-4,
    exactly 0 at padded sites."""
    tab32, tab64, y, phi, alpha, nu, params = _nu_args(card, kern, sampled, m)
    count = dops.COUNT_Y_NU if emit_y else dops.COUNT_NU
    before = count.launches
    got = dops.value_and_grad_sums(kern, tab32, phi, alpha, y, emit_y=emit_y, nu=nu)
    torch.cuda.synchronize()
    assert count.launches == before + 1
    want = dops.grad_reference(kern, tab64, params, y.double(), emit_y=emit_y)
    sums, ref = (got[0], want[0]) if emit_y else (got, want)
    sums = sums.double()
    assert sums.shape == (8, 3)
    torch.testing.assert_close(sums[:2], ref[:2], rtol=5e-5, atol=0.0)
    torch.testing.assert_close(sums[2:6], ref[2:6], rtol=2e-4, atol=0.0)
    if sampled:
        torch.testing.assert_close(sums[6:], ref[6:], rtol=5e-2, atol=0.0)
    else:
        assert (sums[6:] == 0).all() and (ref[6:] == 0).all()
    if emit_y:
        n = tab32.n
        torch.testing.assert_close(got[1].double(), want[1], rtol=0.0, atol=1e-4)
        torch.testing.assert_close(got[2].double(), want[2], rtol=2e-3, atol=2e-4)
        assert (got[1][:, :, n:] == 0).all() and (got[2][:, n:] == 0).all()


@pytest.mark.parametrize("kern,sampled", NU_KERNELS, ids=_NU_IDS)
@pytest.mark.parametrize("m", [7, 10, 15, 20])
def test_general_nu_bf_kernel_matches_plain(card, kern, sampled, m):
    """Kernel 3's general-nu instances: B atol 1e-4, F rtol 1e-4; padded
    sites hold B = 0, F = 1."""
    tab32, tab64, _, phi, alpha, nu, params = _nu_args(card, kern, sampled, m)
    before = bops.COUNT_NU.launches
    b, f = bops.bf_planes(kern, tab32, phi, alpha, nu=nu)
    torch.cuda.synchronize()
    assert bops.COUNT_NU.launches == before + 1
    b_p, f_p = bops.bf_reference(kern, tab64, params)
    n = tab32.n
    torch.testing.assert_close(b[:, :, :n].double(), b_p[:, :, :n], rtol=0.0, atol=1e-4)
    torch.testing.assert_close(f[:, :n].double(), f_p[:, :n], rtol=1e-4, atol=0.0)
    assert (b[:, :, n:] == 0).all() and (f[:, n:] == 1).all()


def test_sampled_nu_models_on_card_go_through_the_general_instances(card):
    """ResponseNNGP and LatentNNGP with ``Matern()`` on the card: fit_map and
    NUTS launch kernel 2's general-nu instances, MWG kernel 1's, the latent
    sampler kernel 3's, and no plain version runs."""
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(1500, 2))
    y = np.sin(9.0 * coords[:, 0]) + 0.3 * rng.standard_normal(1500)
    counts = (fops.COUNT_NU, dops.COUNT_NU, bops.COUNT_NU)
    for c in counts:
        c.reset()
    model = ResponseNNGP(coords, y, kernel=kernels.Matern(), m=7, device=card)
    mp = model.fit_map(n_steps=20)
    draws = model.sample_nuts(5, n_burn=5, n_chains=2, max_depth=3, init_u=mp.u,
                              init_inv_mass=mp.laplace_cov)
    mwg = model.sample(5, n_burn=5, n_chains=2)
    latent = LatentNNGP(coords, y, kernel=kernels.Matern(), m=7, jitter=1e-4,
                        device=card).sample(5, n_burn=5, n_chains=2)
    assert all(c.launches > 0 and c.plain == 0 for c in counts)
    for out in (draws, mwg, latent):
        assert out["nu"].shape == (2, 5) and np.isfinite(out["nu"]).all()


# ---- the coords table layout (distances recomputed inside the kernels) -----
# The dist rows' own limits: the float32 distances the coords instances
# recompute differ from the dist tables' by a few ulps, far below them.

@pytest.mark.parametrize("kern", KERNELS, ids=lambda k: repr(k))
@pytest.mark.parametrize("m", [7, 10, 15, 20])
def test_coords_forward_and_bf_kernels_match_plain(card, kern, m):
    """Kernels 1 and 3 on the coords layout (their COORDS instances) against
    the float64 plain versions on the same coordinate planes, at the limits
    of test_forward_kernel_matches_plain and test_bf_kernel_matches_plain."""
    tab32, tab64, y, phi, alpha = _problem(card, m=m, layout="coords")
    before = (fops.COUNT.launches, fops.COUNT_COORDS.launches, bops.COUNT_COORDS.launches)
    ld, q, f, r = fops.suffstats(kern, tab32, phi, alpha, y)
    b, f3 = bops.bf_planes(kern, tab32, phi, alpha)
    torch.cuda.synchronize()
    assert (fops.COUNT.launches, fops.COUNT_COORDS.launches,
            bops.COUNT_COORDS.launches) == (before[0], before[1] + 1, before[2] + 1)
    params = fops.params_array(phi.double(), alpha.double(), np.float32(1e-6),
                               tab32.n, torch.float64, card)
    ld_p, q_p, f_p, r_p = fops.suffstats_reference(kern, tab64, params, y.double())
    b_p, f3_p = bops.bf_reference(kern, tab64, params)
    n = tab32.n
    torch.testing.assert_close(ld.double(), ld_p, rtol=3e-4, atol=0.0)
    torch.testing.assert_close(q.double(), q_p, rtol=3e-4, atol=0.0)
    torch.testing.assert_close(f[:, :n].double(), f_p[:, :n], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(r[:, :n].double(), r_p[:, :n], rtol=2e-3, atol=1e-4)
    torch.testing.assert_close(b[:, :, :n].double(), b_p[:, :, :n], rtol=0.0, atol=3e-5)
    torch.testing.assert_close(f3[:, :n].double(), f3_p[:, :n], rtol=3e-5, atol=0.0)
    assert (b[:, :, n:] == 0).all() and (f3[:, n:] == 1).all()


@pytest.mark.parametrize("kern", KERNELS, ids=lambda k: repr(k))
@pytest.mark.parametrize("m", [7, 10, 15, 20])
def test_coords_grad_kernel_matches_plain(card, kern, m):
    tab32, tab64, y, phi, alpha = _problem(card, m=m, layout="coords")
    before = dops.COUNT_COORDS.launches
    got = dops.value_and_grad_sums(kern, tab32, phi, alpha, y).double()
    assert dops.COUNT_COORDS.launches == before + 1
    params = fops.params_array(phi.double(), alpha.double(), np.float32(1e-6),
                               tab32.n, torch.float64, card)
    want = dops.grad_reference(kern, tab64, params, y.double())
    torch.testing.assert_close(got[:2], want[:2], rtol=5e-4, atol=0.0)
    torch.testing.assert_close(got[2:], want[2:], rtol=2e-4, atol=0.0)


@pytest.mark.parametrize("per_chain", [False, True], ids=["shared_y", "per_chain_y"])
@pytest.mark.parametrize("m", [7, 10, 15, 20])
def test_coords_grad_y_kernel_matches_plain(card, m, per_chain):
    """The EMIT_Y and COORDS instances at the limits of
    test_grad_y_kernel_matches_plain, and the y cotangent through the gather
    against autograd of the float64 plain version (rtol 2e-3, atol 2e-4)."""
    kern = kernels.Exponential()
    tab32, tab64, y, phi, alpha = _problem(card, m=m, layout="coords")
    tab32, tab64 = with_children(tab32), with_children(tab64)
    if per_chain:
        rng = np.random.default_rng(4)
        y = y + 0.1 * torch.as_tensor(rng.standard_normal((3, tab32.n)),
                                      dtype=torch.float32, device=card)
    params = fops.params_array(phi.double(), alpha.double(), np.float32(1e-6),
                               tab32.n, torch.float64, card)
    before = dops.COUNT_Y_COORDS.launches
    sums, b, rof = dops.value_and_grad_sums(kern, tab32, phi, alpha, y, emit_y=True)
    dy = dops.dquad_dy(tab32, b, rof)
    torch.cuda.synchronize()
    assert dops.COUNT_Y_COORDS.launches == before + 1
    want, b_p, rof_p = dops.grad_reference(kern, tab64, params, y.double(), emit_y=True)
    n = tab32.n
    torch.testing.assert_close(sums.double()[:2], want[:2], rtol=5e-4, atol=0.0)
    torch.testing.assert_close(sums.double()[2:], want[2:], rtol=2e-4, atol=0.0)
    torch.testing.assert_close(b.double(), b_p, rtol=0.0, atol=3e-5)
    torch.testing.assert_close(rof.double(), rof_p, rtol=2e-3, atol=1e-4)
    assert (b[:, :, n:] == 0).all() and (rof[:, n:] == 0).all()
    assert all((b[:, k, :k + 1] == 0).all() for k in range(m))
    y64 = (y.double() if per_chain else y.double().expand(3, n)).clone().requires_grad_(True)
    _, q, _, _ = fops.suffstats_reference(kern, tab64, params, y64)
    (dy_p,) = torch.autograd.grad(q.sum(), y64)
    torch.testing.assert_close(dy.double(), dy_p, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("kern,sampled", NU_KERNELS, ids=_NU_IDS)
@pytest.mark.parametrize("m", [7, 10, 15, 20])
def test_coords_general_nu_kernels_match_plain(card, kern, sampled, m):
    """The general-nu COORDS instances of kernels 1, 2, 2-EMIT_Y and 3 at the
    limits of the general-nu tests above."""
    tab32, tab64, y, phi, alpha = _problem(card, m=m, layout="coords")
    nu = torch.tensor(NU_CHAINS, device=card) if sampled else None
    params = fops.params_array(phi.double(), alpha.double(), np.float32(1e-6),
                               tab32.n, torch.float64, card,
                               fops.kernel_nu(kern, None if nu is None else nu.double()))
    counts = (fops.COUNT_NU_COORDS, dops.COUNT_NU_COORDS, dops.COUNT_Y_NU_COORDS,
              bops.COUNT_NU_COORDS)
    before = [c.launches for c in counts]
    ld, q, f, r = fops.suffstats(kern, tab32, phi, alpha, y, nu=nu)
    sums = dops.value_and_grad_sums(kern, tab32, phi, alpha, y, nu=nu).double()
    sums_y, b, rof = dops.value_and_grad_sums(kern, tab32, phi, alpha, y, emit_y=True,
                                              nu=nu)
    b3, f3 = bops.bf_planes(kern, tab32, phi, alpha, nu=nu)
    torch.cuda.synchronize()
    assert [c.launches for c in counts] == [v + 1 for v in before]
    ld_p, q_p, f_p, r_p = fops.suffstats_reference(kern, tab64, params, y.double())
    want, b_p, rof_p = dops.grad_reference(kern, tab64, params, y.double(), emit_y=True)
    b3_p, f3_p = bops.bf_reference(kern, tab64, params)
    n = tab32.n
    torch.testing.assert_close(ld.double(), ld_p, rtol=5e-5, atol=0.0)
    torch.testing.assert_close(q.double(), q_p, rtol=5e-5, atol=0.0)
    torch.testing.assert_close(f[:, :n].double(), f_p[:, :n], rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(r[:, :n].double(), r_p[:, :n], rtol=2e-3, atol=2e-4)
    for got in (sums, sums_y.double()):
        torch.testing.assert_close(got[:2], want[:2], rtol=5e-5, atol=0.0)
        torch.testing.assert_close(got[2:6], want[2:6], rtol=2e-4, atol=0.0)
        if sampled:
            torch.testing.assert_close(got[6:], want[6:], rtol=5e-2, atol=0.0)
        else:
            assert (got[6:] == 0).all()
    torch.testing.assert_close(b.double(), b_p, rtol=0.0, atol=1e-4)
    torch.testing.assert_close(rof.double(), rof_p, rtol=2e-3, atol=2e-4)
    torch.testing.assert_close(b3[:, :, :n].double(), b3_p[:, :, :n], rtol=0.0, atol=1e-4)
    torch.testing.assert_close(f3[:, :n].double(), f3_p[:, :n], rtol=1e-4, atol=0.0)
    assert (b3[:, :, n:] == 0).all() and (f3[:, n:] == 1).all()


def test_coords_launch_refuses_tables_without_m_d_neighbor_planes(card):
    tab32, _, y, phi, alpha = _problem(card, layout="coords")
    short = tab32._replace(tab_b=tab32.tab_b[:-1].contiguous())
    with pytest.raises(ValueError, match="coords tables"):
        fops.suffstats(kernels.SqExp(), short, phi, alpha, y)


def test_models_on_the_coords_layout_go_through_its_instances(card):
    """ResponseNNGP(lane_layout="coords") and, with the threshold moved below
    n, LatentNNGP on the card: fit_map, NUTS and MWG launch the COORDS
    instances of kernels 2 and 1, the latent sampler kernel 3's, with fixed
    effects kernel 2's EMIT_Y ones, and no plain version runs."""
    from pynngp_tpu_torch.ops import site_tables

    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(2000, 2))
    x = np.column_stack([np.ones(2000), rng.standard_normal(2000)])
    y = np.sin(5 * coords[:, 0]) + 0.3 * rng.standard_normal(2000)
    counts = (fops.COUNT_COORDS, dops.COUNT_COORDS, bops.COUNT_COORDS,
              dops.COUNT_Y_COORDS)
    for c in counts:
        c.reset()
    model = ResponseNNGP(coords, y, m=7, lane_layout="coords", device=card)
    mp = model.fit_map(n_steps=20)
    model.sample_nuts(5, n_burn=5, n_chains=2, max_depth=3, init_u=mp.u,
                      init_inv_mass=mp.laplace_cov)
    model.sample(5, n_burn=5, n_chains=2)
    fixed = ResponseNNGP(coords, y + x @ np.array([1.0, -2.0]), m=7, x=x,
                         lane_layout="coords", device=card)
    fixed.fit_map(n_steps=5)
    old = site_tables.COORDS_LAYOUT_MIN_SITES
    site_tables.COORDS_LAYOUT_MIN_SITES = 1000
    try:
        latent = LatentNNGP(coords, y, m=7, device=card)
    finally:
        site_tables.COORDS_LAYOUT_MIN_SITES = old
    assert latent.lane_layout == "coords"
    draws = latent.sample(5, n_burn=5, n_chains=2)
    assert all(c.launches > 0 and c.plain == 0 for c in counts)
    assert np.isfinite(draws["phi"]).all()


# ---- heterogeneous noise, any m <= 20, coords with any d ---------------------
# Every instance against its plain version on the same float32 tables, at the
# limits its homogeneous rows hold.

CLOSED_LIMITS = {"value": 5e-4, "deriv": 2e-4, "nu": None, "f": (1e-4, 1e-6),
                 "r": (2e-3, 1e-4), "b": 3e-5, "f3": 3e-5, "rof": (2e-3, 1e-4)}
GENERAL_LIMITS = {"value": 5e-5, "deriv": 2e-4, "nu": 5e-2, "f": (1e-3, 1e-5),
                  "r": (2e-3, 2e-4), "b": 1e-4, "f3": 1e-4, "rof": (2e-3, 2e-4)}


def _weights(n):
    """Per-site noise weights in ordered site space, v ~ U(0.25, 4)."""
    return np.random.default_rng(7).uniform(0.25, 4.0, n)


def _check_instances(card, kern, nu, tab32, tab64, y, phi, alpha, noise_v=None):
    """Kernels 1, 2, 2-EMIT_Y and 3 at the tables' m (any m <= 32: the
    instance M >= m runs, the rolled one above 20) against their float64
    plain versions; one launch of each instance's count (``_hetero`` with
    weights) and no other."""
    limits = GENERAL_LIMITS if nu is not None else CLOSED_LIMITS
    hetero = noise_v is not None
    v32 = None if noise_v is None else torch.as_tensor(noise_v, dtype=torch.float32,
                                                       device=card)
    v64 = None if noise_v is None else torch.as_tensor(noise_v, device=card)
    params = fops.params_array(phi.double(), alpha.double(), np.float32(1e-6), tab32.n,
                               torch.float64, card,
                               fops.kernel_nu(kern, None if nu is None else nu.double()))
    names = [fops.instance("vecchia_suffstats", kern, tab32, hetero=hetero),
             fops.instance("vecchia_grad", kern, tab32, hetero=hetero),
             fops.instance("vecchia_grad", kern, tab32, True, hetero),
             fops.instance("vecchia_bf", kern, tab32, hetero=hetero)]
    counts = [fops.COUNTS[names[0]], dops.COUNTS[names[1]], dops.COUNTS[names[2]],
              bops.COUNTS[names[3]]]
    before = [c.launches for c in counts]
    n, m = tab32.n, tab32.m
    ld, q, f, r = fops.suffstats(kern, tab32, phi, alpha, y, nu=nu, noise_v=v32)
    sums = dops.value_and_grad_sums(kern, tab32, phi, alpha, y, nu=nu, noise_v=v32)
    sums_y, b, rof = dops.value_and_grad_sums(kern, tab32, phi, alpha, y, emit_y=True,
                                              nu=nu, noise_v=v32)
    b3, f3 = bops.bf_planes(kern, tab32, phi, alpha, nu=nu, noise_v=v32)
    torch.cuda.synchronize()
    assert [c.launches for c in counts] == [x + 1 for x in before], names
    y64 = y.double()
    ld_p, q_p, f_p, r_p = fops.suffstats_reference(kern, tab64, params, y64, v64)
    want, b_p, rof_p = dops.grad_reference(kern, tab64, params, y64, True, v64)
    b3_p, f3_p = bops.bf_reference(kern, tab64, params, v64)
    value_rtol = limits["value"] if nu is not None else 3e-4
    torch.testing.assert_close(ld.double(), ld_p, rtol=value_rtol, atol=0.0)
    torch.testing.assert_close(q.double(), q_p, rtol=value_rtol, atol=0.0)
    torch.testing.assert_close(f[:, :n].double(), f_p[:, :n], rtol=limits["f"][0],
                               atol=limits["f"][1])
    torch.testing.assert_close(r[:, :n].double(), r_p[:, :n], rtol=limits["r"][0],
                               atol=limits["r"][1])
    for got in (sums.double(), sums_y.double()):
        torch.testing.assert_close(got[:2], want[:2], rtol=limits["value"], atol=0.0)
        torch.testing.assert_close(got[2:6], want[2:6], rtol=limits["deriv"], atol=0.0)
        if limits["nu"] is not None and kern.samples_nu:
            torch.testing.assert_close(got[6:], want[6:], rtol=limits["nu"], atol=0.0)
    assert b.shape == b3.shape == (phi.shape[0], m, tab32.n_pad)
    torch.testing.assert_close(b.double(), b_p, rtol=0.0, atol=limits["b"])
    torch.testing.assert_close(rof.double(), rof_p, rtol=limits["rof"][0],
                               atol=limits["rof"][1])
    assert (b[:, :, n:] == 0).all() and (rof[:, n:] == 0).all()
    assert all((b[:, k, :k + 1] == 0).all() for k in range(m))
    torch.testing.assert_close(b3[:, :, :n].double(), b3_p[:, :, :n], rtol=0.0,
                               atol=limits["b"])
    torch.testing.assert_close(f3[:, :n].double(), f3_p[:, :n], rtol=limits["f3"],
                               atol=0.0)
    assert (b3[:, :, n:] == 0).all() and (f3[:, n:] == 1).all()


HETERO_FAMILIES = [(kernels.Exponential(), False), (kernels.Matern(), True)]


@pytest.mark.parametrize("layout", ["dist", "coords"])
@pytest.mark.parametrize("kern,sampled", HETERO_FAMILIES, ids=["closed", "sampled_nu"])
@pytest.mark.parametrize("m", [7, 20])
def test_hetero_instances_match_plain(card, layout, kern, sampled, m):
    """All sixteen instances launched with per-site weights (v ~ U(0.25, 4)
    at the neighbors on the diagonal, at the site in F, diag(v) in the alpha
    sums) against their plain versions."""
    tab32, tab64, y, phi, alpha = _problem(card, m=m, layout=layout)
    tab32, tab64 = with_children(tab32), with_children(tab64)
    nu = torch.tensor(NU_CHAINS, device=card) if sampled else None
    _check_instances(card, kern, nu, tab32, tab64, y, phi, alpha, _weights(tab32.n))


@pytest.mark.parametrize("layout", ["dist", "coords"])
@pytest.mark.parametrize("hetero", [False, True], ids=["homogeneous", "hetero"])
@pytest.mark.parametrize("m", [12, 17])
def test_m_between_built_instances_runs_on_the_larger_one(card, layout, hetero, m):
    """m = 12 on the M = 15 instances and m = 17 on M = 20: slots k >= m are
    identity rows that read nothing (the tables have m planes), and B has m
    planes."""
    assert fops.cuda_instance_m(m) == {12: 15, 17: 20}[m]
    tab32, tab64, y, phi, alpha = _problem(card, m=m, layout=layout)
    tab32, tab64 = with_children(tab32), with_children(tab64)
    _check_instances(card, kernels.SqExp(), None, tab32, tab64, y, phi, alpha,
                     _weights(tab32.n) if hetero else None)


@pytest.mark.parametrize("kern,sampled", HETERO_FAMILIES, ids=["closed", "sampled_nu"])
def test_coords_in_four_dimensions_match_plain(card, kern, sampled):
    """d = 4 on the coords instances: the fourth coordinate is read where it
    is used, the first three are held as before."""
    tab32, tab64, y, phi, alpha = _problem(card, layout="coords", dim=4)
    assert tab32.dim == 4
    tab32, tab64 = with_children(tab32), with_children(tab64)
    nu = torch.tensor(NU_CHAINS, device=card) if sampled else None
    _check_instances(card, kern, nu, tab32, tab64, y, phi, alpha)


def test_m_above_twenty_raises_on_the_card(card):
    """m = 21 runs on the rolled instances and m = 33 on the large-m ones
    against the plain versions, and a model takes m = 33.  At m = 33 kernels
    1 and 2 take as many chains as the scratch body's budget would refuse
    (one block a chain over LARGE_SCRATCH_BYTES): their shared-memory bodies
    need no scratch.  What still raises is a launch of kernel 2 above
    M_CLUSTER_GRAD (its scratch body) whose one block a chain needs more
    scratch than LARGE_SCRATCH_BYTES, and it names the bytes."""
    tab32, tab64, y, phi, alpha = _problem(card, m=21)
    _check_instances(card, kernels.SqExp(), None, with_children(tab32),
                     with_children(tab64), y, phi, alpha)
    tab33, tab33_64, y33, _, _ = _problem(card, m=33)
    _check_instances(card, kernels.SqExp(), None, with_children(tab33),
                     with_children(tab33_64), y33, phi, alpha)
    chains = geometry.LARGE_SCRATCH_BYTES // (128 * geometry.large_state_doubles(33) * 8) + 1
    many_phi, many_alpha = (t.repeat(chains // 3 + 1)[:chains] for t in (phi, alpha))
    sums = dops.value_and_grad_sums(kernels.SqExp(), tab33, many_phi, many_alpha, y33)
    ld, _, f, _ = fops.suffstats(kernels.SqExp(), tab33, many_phi, many_alpha, y33)
    torch.cuda.synchronize()
    assert sums.shape == (6, chains) and torch.isfinite(sums).all()
    assert f.shape == (chains, tab33.n_pad) and torch.isfinite(ld).all()
    # every third chain is the first one, in another warp or block
    torch.testing.assert_close(sums[:, ::3], sums[:, :1].expand(-1, sums[:, ::3].shape[1]),
                               rtol=1e-6, atol=0.0)
    big = geometry.M_CLUSTER_GRAD + 1
    tab_big, _, y_big, _, _ = _problem(card, n=big + 28, m=big, layout="coords")
    chains = geometry.LARGE_SCRATCH_BYTES // (128 * geometry.large_state_doubles(big) * 8) + 1
    many_phi, many_alpha = (t.repeat(chains // 3 + 1)[:chains] for t in (phi, alpha))
    with pytest.raises(ValueError, match="LARGE_SCRATCH_BYTES"):
        dops.value_and_grad_sums(kernels.SqExp(), tab_big, many_phi, many_alpha, y_big)
    model = ResponseNNGP(np.random.default_rng(0).uniform(size=(500, 2)), np.ones(500),
                         m=33, device=card)
    assert model.tables.m == 33


def test_hetero_models_on_card_go_through_the_hetero_instances(card):
    """ResponseNNGP(noise=HeterogeneousNoise(v)) on the card: MWG launches
    kernel 1 with weights, fit_map and NUTS kernel 2, with fixed effects MWG
    kernel 3 and fit_map kernel 2's EMIT_Y instances; LatentNNGP with the
    weights launches kernel 3 without them (alpha = 0); no plain version
    runs."""
    from pynngp_tpu_torch.noise import HeterogeneousNoise

    rng = np.random.default_rng(0)
    n = 2000
    coords = rng.uniform(size=(n, 2))
    v = rng.uniform(0.25, 4.0, n)
    x = np.column_stack([np.ones(n), rng.standard_normal(n)])
    y = np.sin(5 * coords[:, 0]) + np.sqrt(0.09 * v) * rng.standard_normal(n)
    hetero = [fops.COUNTS["vecchia_suffstats_hetero"], dops.COUNTS["vecchia_grad_hetero"],
              bops.COUNTS["vecchia_bf_hetero"], dops.COUNTS["vecchia_grad_y_hetero"]]
    for c in hetero + [bops.COUNT]:
        c.reset()
    noise = HeterogeneousNoise(v)
    model = ResponseNNGP(coords, y, m=7, noise=noise, device=card)
    mp = model.fit_map(n_steps=20)
    model.sample_nuts(5, n_burn=5, n_chains=2, max_depth=3, init_u=mp.u,
                      init_inv_mass=mp.laplace_cov)
    draws = model.sample(5, n_burn=5, n_chains=2)
    fixed = ResponseNNGP(coords, y + x @ np.array([1.0, -2.0]), m=7, x=x, noise=noise,
                         device=card)
    fixed.fit_map(n_steps=5)
    fixed.sample(5, n_burn=5, n_chains=2)
    latent = LatentNNGP(coords, y, m=7, noise=noise, device=card)
    latent.sample(5, n_burn=5, n_chains=2, collect_w=False)
    assert all(c.launches > 0 and c.plain == 0 for c in hetero), \
        [(c.name, c.launches, c.plain) for c in hetero]
    assert bops.COUNT.launches > 0 and np.isfinite(draws["tau2"]).all()



# ---- the tile kernels (chains side by side over a staged site tile) --------
# Kernels 1 and 2 run a block of up to four chains, one warp each, over a
# 32-site tile in shared memory: ragged chain groups, any m <= 32 (the rolled
# instances above 20), d = 4 coords, noise weights and one y row a chain, at
# the limits of the rows above.


def _chain_params(card, chains):
    phi = torch.linspace(0.08, 0.5, chains, device=card)
    alpha = torch.linspace(0.05, 0.3, chains, device=card)
    return phi, alpha


@pytest.mark.parametrize("m", [1, 7, 12, 20, 25, 32])
@pytest.mark.parametrize("chains", [1, 2, 3, 5, 17])
def test_tile_kernels_take_any_chain_count_and_m(card, chains, m):
    tab32, tab64, y, _, _ = _problem(card, m=m)
    phi, alpha = _chain_params(card, chains)
    _check_instances(card, kernels.Exponential(), None, with_children(tab32),
                     with_children(tab64), y, phi, alpha)


def _check_per_chain_y(card, kern, tab32, tab64, y, phi, alpha, noise_v=None, grad=True):
    """Kernels 1, 2 and 2-EMIT_Y (kernel 1 alone without ``grad``) with one
    y row a chain, (C, n), against their plain versions at the closed-form
    rows' limits."""
    limits = CLOSED_LIMITS
    n = tab32.n
    ys = y[None, :] + 0.1 * torch.arange(phi.shape[0], device=card)[:, None]
    v32 = None if noise_v is None else torch.as_tensor(noise_v, dtype=torch.float32,
                                                       device=card)
    v64 = None if noise_v is None else v32.double()
    params = fops.params_array(phi.double(), alpha.double(), np.float32(1e-6), n,
                               torch.float64, card)
    ld, q, f, r = fops.suffstats(kern, tab32, phi, alpha, ys, noise_v=v32)
    ld_p, q_p, f_p, r_p = fops.suffstats_reference(kern, tab64, params, ys.double(), v64)
    torch.testing.assert_close(ld.double(), ld_p, rtol=3e-4, atol=0.0)
    torch.testing.assert_close(q.double(), q_p, rtol=3e-4, atol=0.0)
    torch.testing.assert_close(f[:, :n].double(), f_p[:, :n], rtol=limits["f"][0],
                               atol=limits["f"][1])
    torch.testing.assert_close(r[:, :n].double(), r_p[:, :n], rtol=limits["r"][0],
                               atol=limits["r"][1])
    if not grad:
        return
    sums, b, rof = dops.value_and_grad_sums(kern, tab32, phi, alpha, ys, emit_y=True,
                                            noise_v=v32)
    want, b_p, rof_p = dops.grad_reference(kern, tab64, params, ys.double(), True, v64)
    torch.testing.assert_close(sums.double()[:2], want[:2], rtol=limits["value"], atol=0.0)
    torch.testing.assert_close(sums.double()[2:6], want[2:6], rtol=limits["deriv"], atol=0.0)
    torch.testing.assert_close(b.double(), b_p, rtol=0.0, atol=limits["b"])
    torch.testing.assert_close(rof.double(), rof_p, rtol=limits["rof"][0],
                               atol=limits["rof"][1])


@pytest.mark.parametrize("hetero", [False, True], ids=["homogeneous", "hetero"])
@pytest.mark.parametrize("layout,dim", [("dist", 2), ("coords", 2), ("coords", 4)],
                         ids=["dist", "coords", "coords_d4"])
@pytest.mark.parametrize("m", [7, 25, 32])
def test_tile_kernels_with_per_chain_y(card, m, layout, dim, hetero):
    """One y row a chain (the ring holds a y plane set a warp), on both
    layouts and in four dimensions, with and without noise weights, with a
    ragged group of five chains."""
    tab32, tab64, y, _, _ = _problem(card, m=m, layout=layout, dim=dim)
    phi, alpha = _chain_params(card, 5)
    _check_per_chain_y(card, kernels.SqExp(), tab32, tab64, y, phi, alpha,
                       _weights(tab32.n) if hetero else None)


@pytest.mark.parametrize("hetero", [False, True], ids=["homogeneous", "hetero"])
@pytest.mark.parametrize("layout", ["dist", "coords"])
@pytest.mark.parametrize("kern,sampled", HETERO_FAMILIES, ids=["closed", "sampled_nu"])
@pytest.mark.parametrize("m", [25, 32])
def test_large_m_runs_every_kernel_on_both_layouts(card, m, kern, sampled, layout, hetero):
    """m = 25 and 32 in all three kernels (kernel 3's rolled instance with
    arrays for 32 too), closed form and sampled nu."""
    tab32, tab64, y, phi, alpha = _problem(card, m=m, layout=layout)
    nu = torch.tensor(NU_CHAINS, device=card) if sampled else None
    _check_instances(card, kern, nu, with_children(tab32), with_children(tab64), y,
                     phi, alpha, _weights(tab32.n) if hetero else None)


@pytest.mark.parametrize("layout", ["dist", "coords"])
def test_tile_kernels_are_bitwise_deterministic(card, layout):
    """Two launches on the same inputs give the same bits: each block sums
    its tiles in a fixed order and no atomic enters a sum."""
    tab32, _, y, _, _ = _problem(card, n=20_000, m=15, layout=layout)
    phi, alpha = _chain_params(card, 6)
    kern = kernels.SqExp()
    ys = y[None, :] + 0.1 * torch.arange(6, device=card)[:, None]
    runs = [(fops.suffstats(kern, tab32, phi, alpha, y),
             dops.value_and_grad_sums(kern, tab32, phi, alpha, y),
             dops.value_and_grad_sums(kern, tab32, phi, alpha, ys, emit_y=True))
            for _ in range(2)]
    flat = [[t for part in run for t in (part if isinstance(part, tuple) else (part,))]
            for run in runs]
    assert all(torch.equal(a, b) for a, b in zip(*flat))


# ---- kernel 3 on the tile ring, and every kernel at m > 32 -------------------
# Kernel 3 runs the ring of kernels 1 and 2 (no y planes; nn_idx and v only
# with noise weights): ragged chain groups, any m <= 32, d = 4, noise
# weights, alpha = 0, at the limits of its rows above.  m = 40 and 64 run the
# large-m instances of all three kernels (one thread a (site, chain), state in
# a scratch buffer) at the rows' limits.


def _check_bf(card, kern, tab32, tab64, phi, alpha, noise_v=None, jitter=1e-6,
              b_atol=3e-5, f_rtol=3e-5):
    """Kernel 3 against its float64 plain version: B atol, F rtol over the
    sites < n, padded sites B = 0 and F = 1 exactly; one launch counted."""
    v32 = None if noise_v is None else torch.as_tensor(noise_v, dtype=torch.float32,
                                                       device=card)
    count = bops.COUNTS[fops.instance("vecchia_bf", kern, tab32, hetero=v32 is not None)]
    before = count.launches
    b, f = bops.bf_planes(kern, tab32, phi, alpha, jitter=jitter, noise_v=v32)
    torch.cuda.synchronize()
    assert count.launches == before + 1
    params = fops.params_array(phi.double(), alpha.double(), np.float32(jitter), tab32.n,
                               torch.float64, card)
    b_p, f_p = bops.bf_reference(kern, tab64, params,
                                 None if v32 is None else v32.double())
    n, m = tab32.n, tab32.m
    assert b.shape == (phi.shape[0], m, tab32.n_pad) and torch.isfinite(b).all()
    torch.testing.assert_close(b[:, :, :n].double(), b_p[:, :, :n], rtol=0.0, atol=b_atol)
    torch.testing.assert_close(f[:, :n].double(), f_p[:, :n], rtol=f_rtol, atol=0.0)
    assert (b[:, :, n:] == 0).all() and (f[:, n:] == 1).all()
    assert all((b[:, k, :k + 1] == 0).all() for k in range(m))


@pytest.mark.parametrize("hetero", [False, True], ids=["homogeneous", "hetero"])
@pytest.mark.parametrize("m", [1, 7, 12, 20, 25, 32])
@pytest.mark.parametrize("chains", [1, 3, 5, 16])
def test_kernel_3_tile_takes_any_chain_count_and_m(card, chains, m, hetero):
    tab32, tab64, _, _, _ = _problem(card, m=m)
    phi, alpha = _chain_params(card, chains)
    _check_bf(card, kernels.Exponential(), tab32, tab64, phi, alpha,
              _weights(tab32.n) if hetero else None)


@pytest.mark.parametrize("kern", [kernels.Exponential(), kernels.Matern(nu=0.5),
                                  kernels.Spherical()], ids=lambda k: repr(k))
@pytest.mark.parametrize("m", [7, 15, 25])
def test_kernel_3_tile_without_nugget(card, kern, m):
    """alpha = 0, no jitter (the latent model's systems), ragged five chains:
    B atol 1e-3, F rtol 1e-3, as test_bf_kernel_without_nugget."""
    tab32, tab64, _, _, _ = _problem(card, m=m)
    phi, _ = _chain_params(card, 5)
    _check_bf(card, kern, tab32, tab64, phi, torch.zeros_like(phi), jitter=0.0,
              b_atol=1e-3, f_rtol=1e-3)


@pytest.mark.parametrize("hetero", [False, True], ids=["homogeneous", "hetero"])
@pytest.mark.parametrize("m", [7, 15, 20])
def test_kernel_3_tile_on_coords_in_four_dimensions(card, m, hetero):
    """d = 4 (the rolled coords instance) and d = 2 at the same m."""
    for dim in (2, 4):
        tab32, tab64, _, _, _ = _problem(card, m=m, layout="coords", dim=dim)
        phi, alpha = _chain_params(card, 5)
        _check_bf(card, kernels.SqExp(), tab32, tab64, phi, alpha,
                  _weights(tab32.n) if hetero else None)


@pytest.mark.parametrize("layout", ["dist", "coords"])
@pytest.mark.parametrize("m", [15, 20, 40])
def test_kernel_3_launches_are_bitwise_equal(card, layout, m):
    """Two launches of kernel 3 (the tile ring at m = 15, its team body at
    m = 20, the large-m instance at m = 40) on the same inputs give the same
    bits, with and without noise weights."""
    tab32, _, _, _, _ = _problem(card, n=20_000 if m <= 32 else 3_000, m=m, layout=layout)
    phi, alpha = _chain_params(card, 6)
    v = torch.as_tensor(_weights(tab32.n), dtype=torch.float32, device=card)
    for noise in (None, v):
        runs = [bops.bf_planes(kernels.SqExp(), tab32, phi, alpha, noise_v=noise)
                for _ in range(2)]
        assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("hetero", [False, True], ids=["homogeneous", "hetero"])
@pytest.mark.parametrize("layout", ["dist", "coords"])
@pytest.mark.parametrize("kern,sampled", HETERO_FAMILIES, ids=["closed", "sampled_nu"])
@pytest.mark.parametrize("m", [40, 64])
def test_large_m_instances_match_plain(card, m, kern, sampled, layout, hetero):
    """m = 40 and 64 on the large-m instances of all three kernels (kernel 2
    with EMIT_Y too), closed form and sampled nu, both layouts, with and
    without noise weights; their launches count under ``..._large``."""
    tab32, tab64, y, phi, alpha = _problem(card, m=m, layout=layout)
    nu = torch.tensor(NU_CHAINS, device=card) if sampled else None
    assert fops.instance("vecchia_bf", kern, tab32).endswith("_large")
    _check_instances(card, kern, nu, with_children(tab32), with_children(tab64), y,
                     phi, alpha, _weights(tab32.n) if hetero else None)


@pytest.mark.parametrize("layout,dim", [("dist", 2), ("coords", 2), ("coords", 4)],
                         ids=["dist", "coords", "coords_d4"])
@pytest.mark.parametrize("m", [40, 64])
def test_large_m_with_per_chain_y_and_ragged_chains(card, m, layout, dim):
    """m = 40 and 64: one y row a chain, five chains (kernel 1's shared-memory
    body: a group of four and a ragged one), with noise weights."""
    tab32, tab64, y, _, _ = _problem(card, m=m, layout=layout, dim=dim)
    phi, alpha = _chain_params(card, 5)
    _check_per_chain_y(card, kernels.SqExp(), tab32, tab64, y, phi, alpha,
                       _weights(tab32.n))


def _check_kernels_1_and_3(card, kern, nu, tab32, tab64, y, phi, alpha, noise_v=None):
    """Kernels 1 and 3 at the tables' m against their float64 plain versions
    at the rows' limits (closed form or general nu); one launch of each
    instance's count (``_large`` on the shared-memory body,
    ``_large_cluster`` above M_SMEM, ``_large_scratch`` above M_CLUSTER;
    ``_hetero`` with weights)."""
    limits = GENERAL_LIMITS if nu is not None else CLOSED_LIMITS
    v32 = None if noise_v is None else torch.as_tensor(noise_v, dtype=torch.float32,
                                                       device=card)
    v64 = None if v32 is None else v32.double()
    params = fops.params_array(phi.double(), alpha.double(), np.float32(1e-6), tab32.n,
                               torch.float64, card,
                               fops.kernel_nu(kern, None if nu is None else nu.double()))
    names = [fops.instance("vecchia_suffstats", kern, tab32, hetero=v32 is not None),
             fops.instance("vecchia_bf", kern, tab32, hetero=v32 is not None)]
    counts = [fops.COUNTS[names[0]], bops.COUNTS[names[1]]]
    before = [c.launches for c in counts]
    ld, q, f, r = fops.suffstats(kern, tab32, phi, alpha, y, nu=nu, noise_v=v32)
    b3, f3 = bops.bf_planes(kern, tab32, phi, alpha, nu=nu, noise_v=v32)
    torch.cuda.synchronize()
    assert [c.launches for c in counts] == [x + 1 for x in before], names
    ld_p, q_p, f_p, r_p = fops.suffstats_reference(kern, tab64, params, y.double(), v64)
    b3_p, f3_p = bops.bf_reference(kern, tab64, params, v64)
    n, m = tab32.n, tab32.m
    value_rtol = limits["value"] if nu is not None else 3e-4
    torch.testing.assert_close(ld.double(), ld_p, rtol=value_rtol, atol=0.0)
    torch.testing.assert_close(q.double(), q_p, rtol=value_rtol, atol=0.0)
    torch.testing.assert_close(f[:, :n].double(), f_p[:, :n], rtol=limits["f"][0],
                               atol=limits["f"][1])
    torch.testing.assert_close(r[:, :n].double(), r_p[:, :n], rtol=limits["r"][0],
                               atol=limits["r"][1])
    assert b3.shape == (phi.shape[0], m, tab32.n_pad)
    torch.testing.assert_close(b3[:, :, :n].double(), b3_p[:, :, :n], rtol=0.0,
                               atol=limits["b"])
    torch.testing.assert_close(f3[:, :n].double(), f3_p[:, :n], rtol=limits["f3"],
                               atol=0.0)
    assert (b3[:, :, n:] == 0).all() and (f3[:, n:] == 1).all()
    assert all((b3[:, k, :k + 1] == 0).all() for k in range(m))


@pytest.mark.parametrize("hetero", [False, True], ids=["homogeneous", "hetero"])
@pytest.mark.parametrize("layout", ["dist", "coords"])
@pytest.mark.parametrize("kern,sampled", HETERO_FAMILIES, ids=["closed", "sampled_nu"])
@pytest.mark.parametrize("m", [33, geometry.M_SMEM, geometry.M_SMEM + 1])
def test_kernels_1_and_3_on_either_large_m_body(card, m, kern, sampled, layout, hetero):
    """Kernels 1 and 3 at m = 33 and M_SMEM (the shared-memory body's
    smallest system and its largest, one system a block) and M_SMEM + 1
    (the cluster body's first m, two blocks a system), closed form and
    sampled nu, both layouts, with and without noise weights, against their
    float64 plain versions."""
    n = 1500 if m == 33 else 400
    tab32, tab64, y, phi, alpha = _problem(card, n=n, m=m, layout=layout)
    body = geometry.large_body("vecchia_bf", m)
    assert body == ("smem" if m <= geometry.M_SMEM else "cluster")
    assert fops.instance("vecchia_suffstats", kern, tab32).endswith(
        "_large" if body == "smem" else "_large_cluster")
    nu = torch.tensor(NU_CHAINS, device=card) if sampled else None
    _check_kernels_1_and_3(card, kern, nu, tab32, tab64, y, phi, alpha,
                           _weights(tab32.n) if hetero else None)


# the cluster body's boundaries: the last m of two blocks a system, the first
# of four, the last of four, the first of eight, and M_CLUSTER; the sampled-nu
# cases at each size's first m
CLUSTER_CASES = [(312, 0), (313, 0), (313, 1), (440, 0), (441, 0), (441, 1),
                 (geometry.M_CLUSTER, 0)]


@pytest.mark.parametrize("hetero", [False, True], ids=["homogeneous", "hetero"])
@pytest.mark.parametrize("layout", ["dist", "coords"])
@pytest.mark.parametrize("m,family", CLUSTER_CASES,
                         ids=[f"m{m}_{'sampled_nu' if f else 'closed'}" for m, f in CLUSTER_CASES])
def test_kernels_1_and_3_at_each_cluster_size(card, m, family, layout, hetero):
    """Kernels 1 and 3 on the cluster body on either side of each cluster
    size (2, 4 and 8 blocks a system) and at M_CLUSTER, closed form and
    sampled nu, both layouts, with and without noise weights, against their
    float64 plain versions (n = m + 28; the sampled-nu chains one a call,
    whose float64 Bessel series would hold tens of GB for three)."""
    kern, sampled = HETERO_FAMILIES[family]
    tab32, tab64, y, phi, alpha = _problem(card, n=m + 28, m=m, layout=layout)
    assert geometry.large_body("vecchia_suffstats", m) == "cluster"
    assert geometry.large_body("vecchia_bf", m) == "cluster"
    assert geometry.cluster_blocks(m) == (2 if m <= 312 else 4 if m <= 440 else 8)
    v = _weights(tab32.n) if hetero else None
    if not sampled:
        _check_kernels_1_and_3(card, kern, None, tab32, tab64, y, phi, alpha, v)
        return
    nu = torch.tensor(NU_CHAINS, device=card)
    for c in range(len(NU_CHAINS)):
        _check_kernels_1_and_3(card, kern, nu[c:c + 1], tab32, tab64, y, phi[c:c + 1],
                               alpha[c:c + 1], v)


def test_kernels_1_and_3_above_m_cluster_run_the_scratch_body(card):
    """m = M_CLUSTER + 1: kernels 1 and 3 on the scratch body (counted under
    ``_large_scratch``) against their float64 plain versions."""
    m = geometry.M_CLUSTER + 1
    tab32, tab64, y, phi, alpha = _problem(card, n=m + 20, m=m)
    assert geometry.large_body("vecchia_bf", m) == "scratch"
    assert fops.instance("vecchia_suffstats", kernels.Exponential(), tab32).endswith(
        "_large_scratch")
    _check_kernels_1_and_3(card, kernels.Exponential(), None, tab32, tab64, y, phi[:1],
                           alpha[:1])


@pytest.mark.parametrize("layout,dim", [("dist", 2), ("coords", 2), ("coords", 4)],
                         ids=["dist", "coords", "coords_d4"])
@pytest.mark.parametrize("m", [geometry.M_SMEM + 1, 441])
def test_cluster_body_with_per_chain_y_and_ragged_chains(card, m, layout, dim):
    """Kernels 1, 2 and 2-EMIT_Y on the cluster body with one y row a chain,
    five chains, noise weights, on both layouts and in four dimensions."""
    tab32, tab64, y, _, _ = _problem(card, n=m + 28, m=m, layout=layout, dim=dim)
    phi, alpha = _chain_params(card, 5)
    assert geometry.large_body("vecchia_grad", m) == "cluster"
    count = dops.COUNTS[fops.instance("vecchia_grad", kernels.SqExp(), tab32, True, True)]
    before = count.launches
    _check_per_chain_y(card, kernels.SqExp(), tab32, tab64, y, phi, alpha,
                       _weights(tab32.n))
    assert count.launches == before + 1 and count.name.endswith("_large_cluster_hetero")


@pytest.mark.parametrize("layout", ["dist", "coords"])
@pytest.mark.parametrize("m", [geometry.M_SMEM + 1, 441])
def test_cluster_body_on_meshes_of_one_card(card, m, layout):
    """The shard offset on the cluster body: kernels 1, 2-EMIT_Y and 3 on
    tables of 4 site shards, on meshes (1, 2), (1, 4) and (2, 2) of this
    card, every per-site output bit for bit as the unsharded launch, with
    and without noise weights; the last shard holds padded sites."""
    sfx = ("_coords" if layout == "coords" else "") + "_large_cluster_sharded"
    counts = [fops.COUNTS["vecchia_suffstats" + sfx], dops.COUNTS["vecchia_grad_y" + sfx]]
    before = [c.launches for c in counts]
    _check_meshes(card, m, layout)
    assert all(c.launches > b for c, b in zip(counts, before))


def _check_kernel_2(card, kern, nu, tab32, tab64, y, phi, alpha, noise_v=None,
                    shared_y=True):
    """Kernel 2 and its EMIT_Y instance at the tables' m, with a shared y
    (unless ``shared_y`` is false) and with one y row a chain, against their
    float64 plain versions at the rows' limits (closed form or general nu);
    one launch of each instance's count a call (``_large`` on the
    shared-memory body, ``_large_cluster`` above M_SMEM_GRAD,
    ``_large_scratch`` above M_CLUSTER_GRAD; ``_hetero`` with weights)."""
    limits = GENERAL_LIMITS if nu is not None else CLOSED_LIMITS
    v32 = None if noise_v is None else torch.as_tensor(noise_v, dtype=torch.float32,
                                                       device=card)
    v64 = None if v32 is None else v32.double()
    params = fops.params_array(phi.double(), alpha.double(), np.float32(1e-6), tab32.n,
                               torch.float64, card,
                               fops.kernel_nu(kern, None if nu is None else nu.double()))
    names = [fops.instance("vecchia_grad", kern, tab32, hetero=v32 is not None),
             fops.instance("vecchia_grad", kern, tab32, True, v32 is not None)]
    counts = [dops.COUNTS[name] for name in names]
    n, m = tab32.n, tab32.m
    ys = y[None, :] + 0.1 * torch.arange(phi.shape[0], device=card)[:, None]
    for yy in (y, ys) if shared_y else (ys,):
        before = [c.launches for c in counts]
        sums = dops.value_and_grad_sums(kern, tab32, phi, alpha, yy, nu=nu, noise_v=v32)
        sums_y, b, rof = dops.value_and_grad_sums(kern, tab32, phi, alpha, yy, emit_y=True,
                                                  nu=nu, noise_v=v32)
        torch.cuda.synchronize()
        assert [c.launches for c in counts] == [x + 1 for x in before], names
        want, b_p, rof_p = dops.grad_reference(kern, tab64, params, yy.double(), True, v64)
        for got in (sums.double(), sums_y.double()):
            torch.testing.assert_close(got[:2], want[:2], rtol=limits["value"], atol=0.0)
            torch.testing.assert_close(got[2:6], want[2:6], rtol=limits["deriv"], atol=0.0)
            if limits["nu"] is not None and kern.samples_nu:
                torch.testing.assert_close(got[6:], want[6:], rtol=limits["nu"], atol=0.0)
        assert b.shape == (phi.shape[0], m, tab32.n_pad)
        torch.testing.assert_close(b.double(), b_p, rtol=0.0, atol=limits["b"])
        torch.testing.assert_close(rof.double(), rof_p, rtol=limits["rof"][0],
                                   atol=limits["rof"][1])
        assert (b[:, :, n:] == 0).all() and (rof[:, n:] == 0).all()
        assert all((b[:, k, :k + 1] == 0).all() for k in range(m))


# kernel 2's large-m bodies: the shared-memory body's smallest system and
# its largest (one system a block), the cluster body's first m and the first
# m of four and of eight blocks a system and M_CLUSTER_GRAD, each with both
# families, layouts and noise settings; the scratch body's first m once (a
# launch there takes one system's time in one thread, ~20 s)
KERNEL_2_CASES = [(m, f, layout, hetero)
                  for m in (33, geometry.M_SMEM_GRAD, geometry.M_SMEM_GRAD + 1, 313, 441,
                            geometry.M_CLUSTER_GRAD)
                  for f in (0, 1) for layout in ("dist", "coords") for hetero in (False, True)]
KERNEL_2_CASES.append((geometry.M_CLUSTER_GRAD + 1, 0, "coords", False))


@pytest.mark.parametrize(
    "m,family,layout,hetero", KERNEL_2_CASES,
    ids=[f"m{m}-{'sampled_nu' if f else 'closed'}-{layout}-{'hetero' if h else 'homogeneous'}"
         for m, f, layout, h in KERNEL_2_CASES])
def test_kernel_2_on_either_large_m_body(card, m, family, layout, hetero):
    """Kernel 2 with and without EMIT_Y at m = 33 and M_SMEM_GRAD (its
    shared-memory body's smallest system and its largest, one system a
    block), M_SMEM_GRAD + 1, 313, 441 and M_CLUSTER_GRAD (the cluster body
    at two, four and eight blocks a system) and M_CLUSTER_GRAD + 1 (the
    scratch body), closed form and sampled nu, both layouts, with and
    without noise weights, a shared and a per-chain y, phi = 0.1, 0.3, 0.5,
    against its float64 plain versions (the sampled-nu chains one a call
    from m = 313 on, whose float64 Bessel series would hold tens of GB for
    three; the scratch case with the per-chain y alone)."""
    kern, sampled = HETERO_FAMILIES[family]
    n = 1500 if m == 33 else 400 if m <= geometry.M_SMEM_GRAD + 1 else m + 28
    tab32, tab64, y, phi, alpha = _problem(card, n=n, m=m, layout=layout)
    body = geometry.large_body("vecchia_grad", m)
    assert body == ("smem" if m <= geometry.M_SMEM_GRAD else
                    "cluster" if m <= geometry.M_CLUSTER_GRAD else "scratch")
    for emit_y in (False, True):
        assert fops.instance("vecchia_grad", kern, tab32, emit_y).endswith(
            {"smem": "_large", "cluster": "_large_cluster", "scratch": "_large_scratch"}[body])
    v = _weights(tab32.n) if hetero else None
    if not sampled:
        _check_kernel_2(card, kern, None, tab32, tab64, y, phi, alpha, v,
                        shared_y=body != "scratch")
        return
    nu = torch.tensor(NU_CHAINS, device=card)
    if m < 313:
        _check_kernel_2(card, kern, nu, tab32, tab64, y, phi, alpha, v)
        return
    for c in range(len(NU_CHAINS)):
        _check_kernel_2(card, kern, nu[c:c + 1], tab32, tab64, y, phi[c:c + 1],
                        alpha[c:c + 1], v)


@pytest.mark.parametrize("layout", ["dist", "coords"])
@pytest.mark.parametrize("m", [40, 64])
def test_large_m_bodies_on_meshes_of_one_card(card, m, layout):
    """The shard offset at m = 40 and 64: tables built for 4 site shards, on
    meshes (1, 2), (1, 4) and (2, 2) of this card, give every per-site output
    of kernels 1, 2-EMIT_Y and 3 (the shared-memory bodies and kernel 2's
    scratch body) bit for bit as the unsharded launch, with and without
    noise weights; the last shard holds padded sites."""
    _check_meshes(card, m, layout)


def _check_meshes(card, m, layout, grad=True):
    """Kernels 1, 2-EMIT_Y and 3 (kernels 1 and 3 alone without ``grad``) on
    tables of 4 site shards: every per-site output on meshes (1, 2), (1, 4)
    and (2, 2) of the card bit for bit as the unsharded launch, with and
    without noise weights."""
    from pynngp_tpu_torch.ops.site_tables import shard_site_tables
    from pynngp_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(3)
    n = 1500
    coords = rng.uniform(size=(n, 2))
    data, tab = make_vecchia_data(coords, m, precompute_distances=layout == "dist", device="cpu")
    tab32 = with_children(make_site_tables(data, dtype=torch.float32, device=card,
                                           layout=layout, coords_host=coords[tab.order],
                                           shards=4))
    y = torch.as_tensor(rng.standard_normal(n)[tab.order], dtype=torch.float32, device=card)
    phi, alpha = _chain_params(card, 5)
    ys = y[None, :] + 0.1 * torch.arange(5, device=card)[:, None]
    kern = kernels.SqExp()

    def outputs(tables, v):
        _, _, f, r = fops.suffstats(kern, tables, phi, alpha, ys, noise_v=v)
        b3, f3 = bops.bf_planes(kern, tables, phi, alpha, noise_v=v)
        if grad:
            _, b, rof = dops.value_and_grad_sums(kern, tables, phi, alpha, ys, emit_y=True,
                                                 noise_v=v)
        torch.cuda.synchronize()
        return [f, r, b3, f3] + ([b, rof] if grad else [])

    for v in (None, torch.as_tensor(_weights(n), dtype=torch.float32, device=card)):
        want = outputs(tab32, v)
        for shape in ((1, 2), (1, 4), (2, 2)):
            mesh = make_mesh(*shape, devices=[card] * (shape[0] * shape[1]))
            sharded = shard_site_tables(tab32, mesh)
            last = sharded.cells[0][-1]
            assert last.off + last.n_pad > n >= last.off
            got = outputs(sharded, v)
            assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(got, want)), shape


def test_models_at_large_m_go_through_the_large_instances(card):
    """ResponseNNGP and LatentNNGP with m = 40 on the card: MWG launches
    kernel 1's large-m instance, fit_map kernel 2's (with fixed effects its
    EMIT_Y one), the latent sweep and the fixed-effects MWG kernel 3's; no
    plain version runs."""
    rng = np.random.default_rng(0)
    n = 2000
    coords = rng.uniform(size=(n, 2))
    x = np.column_stack([np.ones(n), rng.standard_normal(n)])
    y = np.sin(5 * coords[:, 0]) + 0.3 * rng.standard_normal(n)
    large = [fops.COUNTS["vecchia_suffstats_large"], dops.COUNTS["vecchia_grad_large"],
             dops.COUNTS["vecchia_grad_y_large"], bops.COUNTS["vecchia_bf_large"]]
    for c in large:
        c.reset()
    model = ResponseNNGP(coords, y, m=40, device=card)
    model.fit_map(n_steps=5)
    draws = model.sample(5, n_burn=5, n_chains=2)
    fixed = ResponseNNGP(coords, y + x @ np.array([1.0, -2.0]), m=40, x=x, device=card)
    fixed.fit_map(n_steps=5)
    fixed.sample(5, n_burn=5, n_chains=2)
    LatentNNGP(coords, y, m=40, device=card).sample(5, n_burn=5, n_chains=2,
                                                    collect_w=False)
    assert all(c.launches > 0 and c.plain == 0 for c in large), \
        [(c.name, c.launches, c.plain) for c in large]
    assert np.isfinite(draws["tau2"]).all()


# ---- the launches of tempered SMC and ADVI, checkpoints on the card -------


@pytest.mark.parametrize("chains", [512, 1000, 1001])
def test_kernel_1_at_the_smc_particle_counts(card, chains):
    """Kernel 1 as bench.py's config 4 launches it, one chain a particle:
    n=50,000, m=10, at 512 chains (128 groups of four), 1,000 (250 groups)
    and 1,001 (a ragged last group of one), against its plain version at the
    closed-form limits; the plain version takes 25 chains a call."""
    n, m = 50_000, 10
    tab32, tab64, y, _, _ = _problem(card, n=n, m=m, seed=4)
    phi = torch.linspace(0.02, 0.4, chains, device=card)
    alpha = torch.linspace(0.01, 0.5, chains, device=card)
    launches = fops.COUNT.launches
    ld, q, f, r = fops.suffstats(kernels.SqExp(), tab32, phi, alpha, y)
    torch.cuda.synchronize()
    assert fops.COUNT.launches == launches + 1
    for lo in range(0, chains, 25):
        sl = slice(lo, min(lo + 25, chains))
        params = fops.params_array(phi[sl].double(), alpha[sl].double(),
                                   np.float32(1e-6), n, torch.float64, card)
        ld_p, q_p, f_p, r_p = fops.suffstats_reference(kernels.SqExp(), tab64, params,
                                                       y.double())
        torch.testing.assert_close(ld[sl].double(), ld_p, rtol=3e-4, atol=0.0)
        torch.testing.assert_close(q[sl].double(), q_p, rtol=3e-4, atol=0.0)
        torch.testing.assert_close(f[sl, :n].double(), f_p[:, :n], rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(r[sl, :n].double(), r_p[:, :n], rtol=2e-3, atol=1e-4)


def test_kernel_2_at_advi_points_with_the_gradient(card):
    """One ADVI step's launch: eight points through ``diff_suffstats`` with
    autograd (kernel 2 once), against autograd through the float64 plain
    version: values rtol 5e-4, phi and alpha gradients 2e-4."""
    tab32, tab64, y, _, _ = _problem(card)
    phi = torch.linspace(0.05, 0.5, 8, device=card).requires_grad_(True)
    alpha = torch.linspace(0.02, 0.4, 8, device=card).requires_grad_(True)
    launches = (fops.COUNT.launches, dops.COUNT.launches)
    ld, q = dops.diff_suffstats(kernels.SqExp(), tab32, phi, alpha, y)
    dphi, dalpha = torch.autograd.grad((ld + 0.5 * q).sum(), (phi, alpha))
    torch.cuda.synchronize()
    assert (fops.COUNT.launches, dops.COUNT.launches) == (launches[0], launches[1] + 1)
    phi64 = phi.detach().double().requires_grad_(True)
    alpha64 = alpha.detach().double().requires_grad_(True)
    params = fops.params_array(phi64, alpha64, np.float32(1e-6), tab32.n, torch.float64,
                               card)
    ld_p, q_p, _, _ = fops.suffstats_reference(kernels.SqExp(), tab64, params, y.double())
    dphi_p, dalpha_p = torch.autograd.grad((ld_p + 0.5 * q_p).sum(), (phi64, alpha64))
    torch.testing.assert_close(ld.detach().double(), ld_p.detach(), rtol=5e-4, atol=0.0)
    torch.testing.assert_close(q.detach().double(), q_p.detach(), rtol=5e-4, atol=0.0)
    torch.testing.assert_close(dphi.double(), dphi_p, rtol=2e-4, atol=0.0)
    torch.testing.assert_close(dalpha.double(), dalpha_p, rtol=2e-4, atol=0.0)


def test_load_state_onto_a_card_template(card, tmp_path):
    """A card model's MWG state saved and loaded onto a card template comes
    back on the card, bit for bit."""
    from pynngp_tpu_torch.utils.checkpoint import load_state, save_state

    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(1500, 2))
    y = np.sin(5 * coords[:, 0]) + 0.3 * rng.standard_normal(1500)
    model = ResponseNNGP(coords, y, m=7, device=card)
    gen = torch.Generator(device=card).manual_seed(1)
    state = model.step(gen, model.init_state(4))
    save_state(str(tmp_path / "ckpt"), state)
    restored = load_state(str(tmp_path / "ckpt"), model.init_state(4))
    for a, b in zip(state, restored):
        assert b.is_cuda and b.dtype == a.dtype and torch.equal(a, b)


def test_a_card_generator_state_round_trip(card, tmp_path):
    from pynngp_tpu_torch.utils.checkpoint import load_state, save_state

    gen = torch.Generator(device=card).manual_seed(5)
    torch.randn(1000, generator=gen, device=card)
    save_state(str(tmp_path / "g"), (gen.get_state(),))
    want = torch.randn(1000, generator=gen, device=card)
    other = torch.Generator(device=card).manual_seed(0)
    (state,) = load_state(str(tmp_path / "g"), (other.get_state(),))
    other.set_state(state)
    assert torch.equal(torch.randn(1000, generator=other, device=card), want)


# ---- the dot-product distance, prediction and the facade on the card ------


def _sphere(n, seed):
    """n unit vectors in R^3 (sites on a globe) and a smooth field of them
    plus N(0, 0.09)."""
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((n, 3))
    xyz /= np.linalg.norm(xyz, axis=1, keepdims=True)
    y = np.sin(3.0 * xyz[:, 0]) * np.cos(2.0 * xyz[:, 2]) + 0.3 * rng.standard_normal(n)
    return xyz, y


@pytest.mark.parametrize("kern", [kernels.Exponential(), kernels.Matern(nu=0.5)],
                         ids=lambda k: repr(k))
@pytest.mark.parametrize("m", [7, 15])
def test_kernels_on_dotproduct_tables_match_plain(card, kern, m):
    """Kernels 1-3 on dist tables of the cosine dissimilarity (values in
    [0, 2], neighbors at ~1e-3 on 1,500 sites of the sphere), phi scaled to
    them, at the limits of the Euclidean tests above.  On unit vectors the
    dissimilarity is half the squared chord, so the exponential kernel of it
    is the Gaussian kernel of the chord, positive definite; the smoother
    families of it are not (their float32 factors fail here)."""
    coords, y_host = _sphere(1500, seed=3)
    data, tab = make_vecchia_data(coords, m, distance="dotproduct", device="cpu")
    tab32 = make_site_tables(data, dtype=torch.float32, device=card, layout="dist")
    tab64 = tab32.to(torch.float64)
    assert float(tab64.tab_a.max()) <= 2.0
    y = torch.as_tensor(y_host[tab.order], dtype=torch.float32, device=card)
    phi = torch.tensor([0.01, 0.03, 0.05], device=card)
    alpha = torch.tensor([0.05, 0.15, 0.3], device=card)
    params = fops.params_array(phi.double(), alpha.double(), np.float32(1e-6),
                               tab32.n, torch.float64, card)
    n = tab32.n
    ld, q, f, r = fops.suffstats(kern, tab32, phi, alpha, y)
    ld_p, q_p, f_p, r_p = fops.suffstats_reference(kern, tab64, params, y.double())
    torch.testing.assert_close(ld.double(), ld_p, rtol=3e-4, atol=0.0)
    torch.testing.assert_close(q.double(), q_p, rtol=3e-4, atol=0.0)
    torch.testing.assert_close(f[:, :n].double(), f_p[:, :n], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(r[:, :n].double(), r_p[:, :n], rtol=2e-3, atol=1e-4)
    got = dops.value_and_grad_sums(kern, tab32, phi, alpha, y).double()
    want = dops.grad_reference(kern, tab64, params, y.double())
    torch.testing.assert_close(got[:2], want[:2], rtol=5e-4, atol=0.0)
    torch.testing.assert_close(got[2:], want[2:], rtol=2e-4, atol=0.0)
    b, f3 = bops.bf_planes(kern, tab32, phi, alpha)
    b_p, f3_p = bops.bf_reference(kern, tab64, params)
    torch.testing.assert_close(b[:, :, :n].double(), b_p[:, :, :n], rtol=0.0, atol=3e-5)
    torch.testing.assert_close(f3[:, :n].double(), f3_p[:, :n], rtol=3e-5, atol=0.0)


def test_prediction_on_the_card_matches_the_cpu(card):
    """predict_draws on a float32 table on the card against the float64 run
    on the CPU, with the samples drawn on the card.  Response model (sqexp,
    relative nugget >= 0.04, so C_N's condition number is below ~(m +
    alpha) / alpha = 400): mean within 2e-3, var within rtol 1e-3 (400 x
    float32's 6e-8 x m, times a margin).  Latent model (exponential, no
    nugget, 1e-6 jitter): mean within 1e-2 and var within rtol 1e-2, the
    conditioning of the bare correlation at neighbor distances ~phi / 10."""
    from pynngp_tpu_torch.predict import build_prediction_table, predict_draws

    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(2000, 2))
    y = np.sin(5 * coords[:, 0]) + 0.3 * rng.standard_normal(2000)
    new = rng.uniform(size=(300, 2))
    draws = {"sigma2": rng.uniform(0.8, 1.2, 20), "tau2": rng.uniform(0.05, 0.15, 20),
             "phi": rng.uniform(0.1, 0.3, 20)}
    t32 = build_prediction_table(coords, new, 15, device=card)
    t64 = build_prediction_table(coords, new, 15, dtype=torch.float64, device="cpu")
    assert t32.nn_cross.is_cuda and torch.equal(t32.nn_idx.cpu(), t64.nn_idx)
    w = rng.standard_normal((20, 2000))
    for kern, kw, tol in ((kernels.SqExp(), {"values": y}, (2e-3, 1e-3)),
                          (kernels.Exponential(), {"values": None, "values_draws": w},
                           (1e-2, 1e-2))):
        got = predict_draws(kern, t32, draws=draws,
                            generator=torch.Generator(device=card).manual_seed(0), **kw)
        want = predict_draws(kern, t64, draws=draws, **kw)
        assert all(t.is_cuda and t.dtype == torch.float32 for t in got.values())
        assert torch.isfinite(got["samples"]).all()
        torch.testing.assert_close(got["mean"].cpu().double(), want["mean"],
                                   rtol=0.0, atol=tol[0])
        torch.testing.assert_close(got["var"].cpu().double(), want["var"],
                                   rtol=tol[1], atol=0.0)


def test_facade_and_the_new_options_on_the_card(card):
    """SeqNNGP's default latent model (kernel 3) and the response model on
    the max-min order (kernel 1) and on the dot-product distance (kernel 1
    on its dist tables): sample, summarize and predict on the card, no
    plain version."""
    from pynngp_tpu_torch import SeqNNGP

    counts = [fops.COUNT, bops.COUNT]
    before = [(c.launches, c.plain) for c in counts]
    rng = np.random.default_rng(1)
    coords = rng.uniform(size=(2200, 2))
    y = np.sin(5 * coords[:, 0]) + 0.3 * rng.standard_normal(2200)
    xyz, y_sphere = _sphere(2200, seed=2)
    for gp, new in (
            (SeqNNGP(y[:2000], coords[:2000], device=card), coords[2000:]),
            (SeqNNGP(y[:2000], coords[:2000], model="response", cov_model="sqexp",
                     ordering="maxmin", device=card), coords[2000:]),
            (SeqNNGP(y_sphere[:2000], xyz[:2000], model="response",
                     distance="dotproduct", device=card), xyz[2000:])):
        gp.sample(20, n_burn=20, n_chains=2, seed=0)
        assert np.isfinite(gp.summary()["tau2"]["mean"])
        out = gp.predict(new, generator=torch.Generator(device=card).manual_seed(0))
        assert out["mean"].shape == (40, 200) and out["samples"].is_cuda
        assert torch.isfinite(out["samples"]).all()
    for c, (launches, plain) in zip(counts, before):
        assert c.launches > launches and c.plain == plain, c.name


# ---- M = 20 on the team bodies ------------------------------------------------
# 15 < m <= 20: the closed-form instances of kernel 2 (with and without
# EMIT_Y) on both layouts and of kernels 1 and 3 on coords run
# csrc/vecchia_team.cuh (a few lanes a (site, chain) system); kernels 1 and
# 3 on dist keep a lane a system.  The same limits as every closed-form row,
# and a launch of the instance's count and of its M = 20 team count.

def _team_counts(tables, kern, hetero):
    """The instance counts of kernels 1, 2, 2-EMIT_Y and 3 for a launch on
    ``tables``, and the M = 20 team counts of those that run a team body
    there."""
    names = [fops.instance("vecchia_suffstats", kern, tables, hetero=hetero),
             fops.instance("vecchia_grad", kern, tables, hetero=hetero),
             fops.instance("vecchia_grad", kern, tables, True, hetero),
             fops.instance("vecchia_bf", kern, tables, hetero=hetero)]
    counts = [fops.COUNTS[names[0]], dops.COUNTS[names[1]], dops.COUNTS[names[2]],
              bops.COUNTS[names[3]]]
    dim = tables.dim if tables.layout == "coords" else 0
    team = [fops.COUNTS_M20[fops.entry_name(b, kern, tables, e) + "_m20"]
            for b, e in (("vecchia_suffstats", False), ("vecchia_grad", False),
                         ("vecchia_grad", True), ("vecchia_bf", False))
            if geometry.team_body(b, tables.m, tables.layout, dim)]
    assert len(team) == (4 if tables.layout == "coords" else 2)
    return counts + team


@pytest.mark.parametrize("hetero", [False, True], ids=["homogeneous", "hetero"])
@pytest.mark.parametrize("layout,dim", [("dist", 2), ("coords", 1), ("coords", 2),
                                        ("coords", 3)],
                         ids=["dist", "coords_d1", "coords_d2", "coords_d3"])
@pytest.mark.parametrize("m", [16, 17, 18, 19, 20])
def test_m20_team_bodies_match_plain(card, m, layout, dim, hetero):
    """Every m in 16-20 on the M = 20 team bodies, both layouts, d = 1-3,
    with and without noise weights, five chains (a ragged group), against
    the float64 plain versions (kernels 1, 2, 2-EMIT_Y and 3; kernel 3's
    padded sites B = 0 and F = 1)."""
    assert fops.cuda_instance_m(m) == 20
    assert geometry.team_body("vecchia_grad", m, layout, dim if layout == "coords" else 0)
    tab32, tab64, y, _, _ = _problem(card, m=m, layout=layout, dim=dim)
    tab32, tab64 = with_children(tab32), with_children(tab64)
    phi, alpha = _chain_params(card, 5)
    kern = kernels.SqExp()
    counts = _team_counts(tab32, kern, hetero)
    before = [c.launches for c in counts]
    _check_instances(card, kern, None, tab32, tab64, y, phi, alpha,
                     _weights(tab32.n) if hetero else None)
    assert all(c.launches > b for c, b in zip(counts, before)), [c.name for c in counts]


@pytest.mark.parametrize("hetero", [False, True], ids=["homogeneous", "hetero"])
@pytest.mark.parametrize("layout,dim", [("dist", 2), ("coords", 1), ("coords", 3)],
                         ids=["dist", "coords_d1", "coords_d3"])
@pytest.mark.parametrize("m", [16, 20])
def test_m20_team_bodies_with_per_chain_y(card, m, layout, dim, hetero):
    """One y row a chain on the team bodies (the ring holds a y plane set a
    warp), a ragged group of five chains."""
    tab32, tab64, y, _, _ = _problem(card, m=m, layout=layout, dim=dim)
    phi, alpha = _chain_params(card, 5)
    _check_per_chain_y(card, kernels.SqExp(), tab32, tab64, y, phi, alpha,
                       _weights(tab32.n) if hetero else None)


@pytest.mark.parametrize("layout", ["dist", "coords"])
@pytest.mark.parametrize("chains", [1, 2, 3, 4, 5, 16, 17])
def test_m20_team_bodies_take_any_chain_count(card, chains, layout):
    tab32, tab64, y, _, _ = _problem(card, m=20, layout=layout)
    phi, alpha = _chain_params(card, chains)
    _check_instances(card, kernels.Exponential(), None, with_children(tab32),
                     with_children(tab64), y, phi, alpha)


@pytest.mark.parametrize("layout", ["dist", "coords"])
def test_m20_team_bodies_are_bitwise_deterministic(card, layout):
    """Two launches of the team bodies on the same inputs give the same
    bits (a lane's part, then the team's butterfly, in a fixed order)."""
    tab32, _, y, _, _ = _problem(card, n=20_000, m=20, layout=layout)
    phi, alpha = _chain_params(card, 6)
    kern = kernels.SqExp()
    ys = y[None, :] + 0.1 * torch.arange(6, device=card)[:, None]
    runs = [(fops.suffstats(kern, tab32, phi, alpha, y),
             dops.value_and_grad_sums(kern, tab32, phi, alpha, y),
             dops.value_and_grad_sums(kern, tab32, phi, alpha, ys, emit_y=True))
            for _ in range(2)]
    flat = [[t for part in run for t in (part if isinstance(part, tuple) else (part,))]
            for run in runs]
    assert all(torch.equal(a, b) for a, b in zip(*flat))


@pytest.mark.parametrize("hetero", [False, True], ids=["homogeneous", "hetero"])
@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("m", [16, 20])
def test_m20_kernel_3_team_without_nugget(card, m, dim, hetero):
    """alpha = 0, no jitter (the latent model's systems) on kernel 3's team
    body (coords), ragged five chains: B atol 1e-3, F rtol 1e-3 in two and
    three dimensions, as test_kernel_3_tile_without_nugget; padded sites
    B = 0 and F = 1.  On a line (d = 1) these exponential systems are
    near-singular in float32: on these inputs the thread-a-system body
    reached B 0.051 and F 0.034 from the float64 plain version, the team
    body 0.049 and 0.034 (NVIDIA H100 80GB HBM3), so d = 1 is held at 0.1."""
    limit = 1e-3 if dim > 1 else 0.1
    tab32, tab64, _, _, _ = _problem(card, m=m, layout="coords", dim=dim)
    phi, _ = _chain_params(card, 5)
    kern = kernels.Exponential()
    team = fops.COUNTS_M20[fops.entry_name("vecchia_bf", kern, tab32) + "_m20"]
    before = team.launches
    _check_bf(card, kern, tab32, tab64, phi, torch.zeros_like(phi),
              _weights(tab32.n) if hetero else None, jitter=0.0, b_atol=limit, f_rtol=limit)
    assert team.launches == before + 1


@pytest.mark.parametrize("layout", ["dist", "coords"])
def test_m20_team_bodies_on_meshes_of_one_card(card, layout):
    """The shard offset at m = 20: meshes (1, 2), (1, 4) and (2, 2) of this
    card give every per-site output of kernels 1, 2-EMIT_Y and 3 bit for bit
    as the unsharded launch, with and without noise weights, on the team
    bodies (kernel 2 on dist, all three on coords); the last shard holds
    padded sites."""
    row = "vecchia_bf_coords" if layout == "coords" else "vecchia_grad_y"
    count = fops.COUNTS_M20[row + "_m20_sharded"]
    before = count.launches
    _check_meshes(card, 20, layout)
    assert count.launches > before


@pytest.mark.parametrize("per_chain", [False, True], ids=["shared_y", "per_chain_y"])
def test_y_cotangent_at_m_20_on_coords_matches_float64(card, per_chain):
    """The y cotangent through kernel 2-EMIT_Y's M = 20 team body on the
    coords layout (dy rtol 2e-3, atol 2e-4 scaled by 0.12 / alpha)."""
    rng = np.random.default_rng(3)
    n = 1500
    coords = rng.uniform(size=(n, 2))
    data, tab = make_vecchia_data(coords, 20, precompute_distances=False, device="cpu")
    tab32 = with_children(make_site_tables(data, dtype=torch.float32, device=card,
                                           layout="coords", coords_host=coords[tab.order]))
    tab64 = tab32.to(torch.float64)
    y = torch.as_tensor(rng.standard_normal(n)[tab.order], dtype=torch.float32, device=card)
    if per_chain:
        y = y + 0.1 * torch.as_tensor(rng.standard_normal((3, n)), dtype=torch.float32,
                                      device=card)
    alpha = torch.tensor([0.05, 0.15, 0.3], device=card)
    assert geometry.team_body("vecchia_grad", 20, "coords", 2)
    count = fops.COUNTS_M20["vecchia_grad_y_coords_m20"]
    before = count.launches
    _check_y_cotangent(card, kernels.SqExp(), tab32, tab64, y, alpha, per_chain)
    assert count.launches > before
