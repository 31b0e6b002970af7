"""Heterogeneous (per-site) noise in the three kernels' plain versions
against the reference's Pallas bodies in interpret mode, in float64: both
table layouts, closed-form and sampled nu, ``noise_v`` in ordered site space
as ``pallas_suffstats``, ``pallas_bf`` and ``make_diff_suffstats(...,
y_grad=True, noise_v=)`` take it.

v varies from site to site.  Parameters are exact in float32 (phi, alpha,
jitter = 2^-20, nu), because the reference's ``_params_vec`` rounds them
through float32; the tables hold the same float32 distances (dist) or centred
coordinates (coords) in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu import kernels as jkernels
from pynngp_tpu import vecchia as jvecchia
from pynngp_tpu.ops import pallas_bf as pb
from pynngp_tpu_torch import kernels, vecchia
from pynngp_tpu_torch.ops import bf as bops
from pynngp_tpu_torch.ops import diff_suffstats as dops
from pynngp_tpu_torch.ops import suffstats as fops
from pynngp_tpu_torch.ops.site_tables import make_site_tables, with_children

JITTER = 2.0**-20
PHIS = (0.25, 0.125)  # C = 2 chains
ALPHAS = (0.125, 0.0625)
NUS = (float(np.float32(0.8)), float(np.float32(1.7)))
# (reference kernel, port kernel, nu per chain or None)
FAMILIES = {
    "exponential": (jkernels.Exponential(), kernels.Exponential(), None),
    "sampled_nu": (jkernels.Matern(), kernels.Matern(), NUS),
}


def _weights(n, seed=7):
    return np.random.default_rng(seed).uniform(0.25, 4.0, n)


# ---- the kernels' plain versions against the Pallas bodies ------------------

def _problem(layout, n, m, seed):
    """Both packages' tables (dist or coords) over the same sites, y and v
    in ordered site space, in float64."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2))
    y = rng.standard_normal(n)
    v = _weights(n, seed + 1)
    # the same float32 distance tables (dist), or the same float32 centred
    # coordinates (coords), held in float64 by both packages
    on_coords = layout == "coords"
    jdata, jtab = jvecchia.make_vecchia_data(coords, m,
                                             precompute_distances=not on_coords)
    cache = pb.make_lane_cache(jdata, dtype=jnp.float64, layout=layout,
                               coords_host=coords[jtab.order] if on_coords else None)
    data, tab = vecchia.make_vecchia_data(coords, m, dtype=torch.float32,
                                          precompute_distances=not on_coords, device="cpu")
    tables = make_site_tables(data, dtype=torch.float64, layout=layout,
                              coords_host=coords[tab.order], device="cpu")
    order = tab.order
    return {"n": n, "cache": cache, "tables": with_children(tables),
            "y_jax": jnp.asarray(y[order]), "y": torch.as_tensor(y[order]),
            "v_jax": jnp.asarray(v[order]), "v": torch.as_tensor(v[order])}


# interpret mode compiles the unrolled bodies, and with the Bessel series
# that takes seconds per neighbor pair: the sampled-nu cases run at m = 2
SIZES = {"exponential": (200, 5), "sampled_nu": (120, 2)}
CASES = [(layout, family) for family in FAMILIES for layout in ("dist", "coords")]


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def case(request):
    layout, family = request.param
    n, m = SIZES[family]
    return _problem(layout, n, m, seed=3), FAMILIES[family]


def _params(c, nus):
    params = {"phi": jnp.float64(PHIS[c])}
    if nus is not None:
        params["nu"] = jnp.float64(nus[c])
    return params


def test_hetero_suffstats_and_bf_match_pallas(case):
    """Kernels 1 and 3 with per-site weights: (logdet, quad, F, r) against
    pallas_suffstats and (B, F) against pallas_bf with the same noise_v,
    rtol 1e-8 (B also atol 1e-12); the calls count as hetero ones."""
    p, (jkern, kern, nus) = case
    n, t = p["n"], p["tables"]
    phi = torch.tensor(PHIS, dtype=torch.float64)
    alpha = torch.tensor(ALPHAS, dtype=torch.float64)
    nu = None if nus is None else torch.tensor(nus, dtype=torch.float64)
    name = lambda base: fops.instance(base, kern, t, hetero=True)
    before = (fops.COUNTS[name("vecchia_suffstats")].plain,
              bops.COUNTS[name("vecchia_bf")].plain)
    logdet, quad, f, r = fops.suffstats(kern, t, phi, alpha, p["y"], JITTER, nu,
                                        noise_v=p["v"])
    b, f3 = bops.bf(kern, t, phi, alpha, JITTER, nu, noise_v=p["v"])
    assert (fops.COUNTS[name("vecchia_suffstats")].plain,
            bops.COUNTS[name("vecchia_bf")].plain) == (before[0] + 1, before[1] + 1)
    for c in range(len(PHIS)):
        ld_j, q_j, f_j, r_j = pb.pallas_suffstats(
            jkern, _params(c, nus), p["cache"], p["y_jax"], jnp.float64(ALPHAS[c]),
            jitter=JITTER, noise_v=p["v_jax"])
        np.testing.assert_allclose(float(logdet[c]), float(ld_j), rtol=1e-8)
        np.testing.assert_allclose(float(quad[c]), float(q_j), rtol=1e-8)
        np.testing.assert_allclose(f[c, :n].numpy(), np.asarray(f_j).reshape(-1)[:n],
                                   rtol=1e-8)
        np.testing.assert_allclose(r[c, :n].numpy(), np.asarray(r_j).reshape(-1)[:n],
                                   rtol=1e-8, atol=1e-10)
        b_j, fb_j = pb.pallas_bf(jkern, _params(c, nus), p["cache"],
                                 jnp.float64(ALPHAS[c]), jitter=JITTER,
                                 noise_v=p["v_jax"])
        np.testing.assert_allclose(b[c].numpy(), np.asarray(b_j), rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(f3[c].numpy(), np.asarray(fb_j), rtol=1e-8)


def test_hetero_value_and_grad_match_jax(case):
    """Kernel 2's EMIT_Y instances with per-site weights through the dy
    gather: (logdet, quad) and the gradient in phi, alpha (dC/dalpha =
    diag(v)), nu where it is sampled, and y against jax.grad of
    make_diff_suffstats(..., y_grad=True, noise_v=v), rtol 1e-8; dy also atol
    1e-10 of its largest entry."""
    p, (jkern, kern, nus) = case
    suff = pb.make_diff_suffstats(jkern, p["cache"], jitter=JITTER, y_grad=True,
                                  noise_v=p["v_jax"])

    def scalar(phi, alpha, y, *nu):
        ld, q = suff(phi, alpha, y, *nu)
        return 0.7 * ld + 1.3 * q, (ld, q)

    args = (0, 1, 2, 3) if nus else (0, 1, 2)
    vg = jax.jit(jax.value_and_grad(scalar, argnums=args, has_aux=True))
    leaf = lambda v: torch.tensor(v, dtype=torch.float64, requires_grad=True)
    phi, alpha = leaf(PHIS), leaf(ALPHAS)
    nu = leaf(nus) if nus else None
    y = p["y"].clone().requires_grad_(True)
    count = dops.COUNTS[fops.instance("vecchia_grad", kern, p["tables"], True, True)]
    before = count.plain
    ld, q = dops.diff_suffstats(kern, p["tables"], phi, alpha, y, JITTER, nu,
                                noise_v=p["v"])
    assert count.plain == before + 1
    leaves = (phi, alpha) + ((nu,) if nus else ()) + (y,)
    for c in range(len(PHIS)):
        grads = torch.autograd.grad((0.7 * ld + 1.3 * q)[c], leaves, retain_graph=True)
        extra = (jnp.float64(nus[c]),) if nus else ()
        (_, (ld_j, q_j)), g_j = vg(jnp.float64(PHIS[c]), jnp.float64(ALPHAS[c]),
                                   p["y_jax"], *extra)
        np.testing.assert_allclose(float(ld[c].detach()), float(ld_j), rtol=1e-8)
        np.testing.assert_allclose(float(q[c].detach()), float(q_j), rtol=1e-8)
        np.testing.assert_allclose(float(grads[0][c]), float(g_j[0]), rtol=1e-8)
        np.testing.assert_allclose(float(grads[1][c]), float(g_j[1]), rtol=1e-8)
        if nus:
            np.testing.assert_allclose(float(grads[2][c]), float(g_j[3]), rtol=1e-8)
        gy_j = np.asarray(g_j[2])
        np.testing.assert_allclose(grads[-1].numpy(), gy_j, rtol=1e-8,
                                   atol=1e-10 * np.abs(gy_j).max())


def test_hetero_emit_y_planes_match_the_plain_sums(case):
    """The EMIT_Y planes (B, r/F) with per-site weights are kernel 3's B and
    kernel 1's r/F at the same weights, and the six sums' values are kernel
    1's: the three plain versions agree among themselves to rounding."""
    p, (_, kern, nus) = case
    t, n = p["tables"], p["n"]
    params = fops.params_array(torch.tensor(PHIS, dtype=torch.float64),
                               torch.tensor(ALPHAS, dtype=torch.float64), JITTER,
                               n, torch.float64,
                               nu=0.0 if nus is None else torch.tensor(nus))
    sums, b, rof = dops.grad_reference(kern, t, params, p["y"], emit_y=True,
                                       noise_v=p["v"])
    ld, q, f, r = fops.suffstats_reference(kern, t, params, p["y"], noise_v=p["v"])
    b3, _ = bops.bf_reference(kern, t, params, noise_v=p["v"])
    torch.testing.assert_close(sums[0], ld, rtol=1e-12, atol=0.0)
    torch.testing.assert_close(sums[1], q, rtol=1e-12, atol=0.0)
    torch.testing.assert_close(b[:, :, :n], b3[:, :, :n], rtol=1e-10, atol=1e-13)
    torch.testing.assert_close(rof[:, :n], (r / f)[:, :n], rtol=1e-10, atol=1e-13)
    assert (b[:, :, n:] == 0).all() and (rof[:, n:] == 0).all()


def test_noise_plane_pads_with_one_and_takes_a_padded_plane(case):
    p = case[0]
    t = p["tables"]
    v = fops.noise_plane(t, p["v"].numpy())
    assert v.shape == (t.n_pad,) and v.dtype == t.dtype
    assert torch.equal(v[:t.n], p["v"]) and (v[t.n:] == 1).all()
    assert torch.equal(fops.noise_plane(t, v), v)
    assert fops.noise_plane(t, None) is None
    with pytest.raises(ValueError, match="noise_v"):
        fops.noise_plane(t, torch.ones(t.n + 1, dtype=torch.float64))
