"""Differentiable Vecchia sufficient statistics — the counterpart of
``make_diff_suffstats`` (``pynngp_tpu/ops/pallas_bf.py:1051-1158``).

:class:`DiffSuffstats` is a ``torch.autograd.Function`` of (phi, alpha, y)
per chain and, for a kernel that samples it (``Matern()``), nu.  A
differentiated call runs kernel 2 once: the value and the six partial sums
(logdet, quad and their phi and alpha derivatives; eight with the two nu
derivatives, the reference's ``suff_nu``, ``pallas_bf.py:1095-1126``) come out
of one pass over the tables, and ``backward`` contracts the saved derivatives
with the cotangents exactly as the reference's ``bwd`` does
(``pallas_bf.py:1112-1124, 1144-1155``).  An undifferentiated call runs
kernel 1.  The nu derivative is the kernels' central difference of rho
(``kernels.Matern.dcorrelation_dnu``), not an exact one: a sampler that uses
it stays exact because its acceptance rests on energies.

The general-nu Matern (family 6, sampled or static nu) runs the GENERAL
instances (``csrc/vecchia_grad_nu.cu``, ``csrc/vecchia_grad_y_nu.cu``), which
always return eight sums, the last two zero for a static nu; their launches
are counted in ``COUNT_NU`` and ``COUNT_Y_NU``.  Tables in the coords layout
launch the COORDS instances of all four sets (``csrc/vecchia_grad_coords.cu``,
``..._y_coords.cu``, ``..._nu_coords.cu``, ``..._y_nu_coords.cu``), counted
in the ``_COORDS`` counts of the same names.

When y requires grad (the reference's ``y_grad=True``: with fixed effects y
is the residual y - X beta) the forward runs the ``EMIT_Y`` instances of
kernel 2 (``csrc/vecchia_grad_y.cu``), which also write the kriging weights
B (C, m, n_pad) and r/F (C, n_pad), and ``backward`` forms
  dquad/dy_j = 2 (r/F)_j - 2 sum_{(i,k): N(i)[k] = j} B_{k,i} (r/F)_i
(:func:`dquad_dy`).  The reference adds the second term with a scatter; here
it is a gather through the reverse index ``tables.child_flat`` and a dense
sum over the child axis, so that the result does not depend on the order of
floating-point atomics and a run repeats bit for bit.  logdet does not
depend on y.

y is (n,), shared by all chains, or (C, n), one row per chain.

Heterogeneous noise (``noise_v``, the reference's ``make_diff_suffstats(...,
noise_v=)``, ``pallas_bf.py:1051``): the relative nugget is alpha v, so
dC/dalpha is diag(v) at the neighbors and dF/dalpha gains v at the site
(``_grad_kernel`` l.804-806, 835).  The same instances run with a pointer to
v; their launches count under ``<instance>_hetero``.  The y cotangent's
gather does not change (``_dy`` l.1082).

phi, alpha and nu may live on the host while the tables and y live on the card:
the (C, 6) parameter rows go to the card, and the (C,) sums and derivatives
come back to phi's device.  A sampler whose state is a few numbers per chain
can then keep it, and the prior and transform arithmetic around this call,
off the card, where each of those tiny operations would be a kernel launch.

Shards (the reference's ``make_sharded_diff_suffstats``,
``pallas_bf.py:1195``): on :class:`~.site_tables.ShardedTables` a call makes
one launch a mesh cell (``ops.suffstats.map_cells``) and adds the float64
partial sums over the site shards on the mesh's first device.  With y
requiring grad every shard's EMIT_Y B and r/F planes are gathered there, in
the global layout, and the y cotangent runs the same gather over the global
reverse index; the reference's sharded path drops that cotangent
(``pallas_bf.py:1204-1206``).

Per site (u = L^-1 c, v = L^-1 y_N, p = C^-1 c, q = C^-1 y_N):
  F = (1+alpha) - u.u,          r = y_0 - u.v
  dF/dphi = -2 p.(dc/dphi) + p'(dC/dphi)p,   dr/dphi = -(dc/dphi).q + p'(dC/dphi)q
  dF/dalpha = 1 + p.p,          dr/dalpha = p.q
  (with v: F = (1 + alpha v_0) - u.u, dF/dalpha = v_0 + p' diag(v_N) p,
  dr/dalpha = p' diag(v_N) q)
and d/dt sum log F = sum dF/F,  d/dt sum r^2/F = sum (2 r dr F - r^2 dF)/F^2.
"""

from __future__ import annotations

import torch

from pynngp_tpu_torch.ops import _build
from pynngp_tpu_torch.ops.site_tables import ShardedTables, SiteTables
from pynngp_tpu_torch.ops.suffstats import (
    GENERAL_FAMILY,
    _factor,
    count_team,
    cuda_args,
    entry_name,
    instance,
    kernel_nu,
    launch_geometry,
    map_cells,
    noise_plane,
    own_plane,
    params_array,
    pointer,
    shape_args,
    suffstats,
    y_stride,
)

__all__ = ["COUNT", "COUNT_Y", "COUNT_NU", "COUNT_Y_NU", "COUNT_COORDS",
           "COUNT_Y_COORDS", "COUNT_NU_COORDS", "COUNT_Y_NU_COORDS",
           "DiffSuffstats", "diff_suffstats", "dquad_dy", "grad_reference",
           "value_and_grad_sums"]

COUNT = _build.LaunchCount("vecchia_grad")
COUNT_Y = _build.LaunchCount("vecchia_grad_y")  # the EMIT_Y instances
COUNT_NU = _build.LaunchCount("vecchia_grad_nu")  # GENERAL
COUNT_Y_NU = _build.LaunchCount("vecchia_grad_y_nu")  # GENERAL and EMIT_Y
# the same four sets on the coords layout (COORDS)
COUNT_COORDS = _build.LaunchCount("vecchia_grad_coords")
COUNT_Y_COORDS = _build.LaunchCount("vecchia_grad_y_coords")
COUNT_NU_COORDS = _build.LaunchCount("vecchia_grad_nu_coords")
COUNT_Y_NU_COORDS = _build.LaunchCount("vecchia_grad_y_nu_coords")
COUNTS = _build.with_variant_counts(COUNT, COUNT_Y, COUNT_NU, COUNT_Y_NU, COUNT_COORDS,
                                   COUNT_Y_COORDS, COUNT_NU_COORDS, COUNT_Y_NU_COORDS)


def grad_reference(kernel, tables: SiteTables, params, y, emit_y: bool = False,
                   noise_v=None):
    """Plain PyTorch version of kernel 2: (6, C) sums of logdet, quad,
    dlogdet/dphi, dquad/dphi, dlogdet/dalpha, dquad/dalpha, accumulated in
    float64 and cast to the tables' dtype; (8, C) for the general-nu Matern,
    with dlogdet/dnu and dquad/dnu (zeros for a static nu), as its kernel
    instances write them.  With ``emit_y`` it returns
    (sums, B (C, m, n_pad), r/F (C, n_pad)) as the EMIT_Y kernel writes them:
    B and r/F exactly 0 at padded sites, B also in invalid slots.
    ``noise_v``: per-site noise weights, (n,) or padded, or None."""
    out = _reference64(kernel, tables, params, y, emit_y, noise_v)
    if not emit_y:
        return out.to(tables.dtype)
    return (out[0].to(tables.dtype),) + out[1:]


def _reference64(kernel, tables: SiteTables, params, y, emit_y=False, noise_v=None):
    """:func:`grad_reference` with its sums left in float64."""
    terms, b, rof = grad_terms(kernel, tables, params, y, noise_v)
    sums = terms.sum(-1, dtype=torch.float64)
    return (sums, b, rof) if emit_y else sums


def grad_terms(kernel, tables: SiteTables, params, y, noise_v=None):
    """The per-site terms of kernel 2's sums, (6 or 8, C, n_pad) (0 at
    padded sites), and B (C, m, n_pad) and r/F (C, n_pad) as the EMIT_Y
    instances write them: the plain version before its sums."""
    v = noise_plane(tables, noise_v)
    fac = _factor(kernel, tables, params, y, v)
    low, u, w, f, valid = fac["low"], fac["u"], fac["w"], fac["f"], fac["valid"]
    mask_f = fac["mask"].to(f.dtype)
    r = fac["y_own"] - (u * w).sum(-1)
    # back-substitution p = L^-T u, q = L^-T w
    p = torch.linalg.solve_triangular(low.mT, u[..., None], upper=True)[..., 0]
    q = torch.linalg.solve_triangular(low.mT, w[..., None], upper=True)[..., 0]
    phi = params[:, 0:1]
    general = kernel.family == GENERAL_FAMILY
    nu = params[:, 4:5] if general else None
    vec = lambda t: None if t is None else t[..., None]
    mask2 = mask_f[..., :, None] * mask_f[..., None, :]

    def contract(drho):
        """(dF, dr) for the derivative ``drho(d, phi, nu)`` of rho: dc on the
        cross-correlations, and dC, which has no diagonal (drho/dphi is 0 and
        rho is 1 at d = 0 for every kernel and nu)."""
        dc = drho(fac["d_in"], vec(phi), vec(nu)) * mask_f
        p_dc = (p[..., :, None]
                * drho(fac["d_nn"], vec(vec(phi)), vec(vec(nu))) * mask2).sum(-2)
        return (-2.0 * (p * dc).sum(-1) + (p_dc * p).sum(-1),
                -(dc * q).sum(-1) + (p_dc * q).sum(-1))

    df_phi, dr_phi = contract(kernel.dcorrelation_dphi)
    if v is None:
        df_a = 1.0 + (p * p).sum(-1)
        dr_a = (p * q).sum(-1)
    else:  # dC/dalpha = diag(v) at the neighbors, dF/dalpha gains v_0
        wgt = v[tables.nn_idx.T.long()] * mask_f  # (C, n_pad, m)
        df_a = own_plane(tables, v) + (wgt * p * p).sum(-1)
        dr_a = (wgt * p * q).sum(-1)
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    inv_f = torch.where(valid, 1.0 / f, zero)
    r_over_f = r * inv_f
    ratio2 = r_over_f * r_over_f
    terms = [
        torch.where(valid, torch.log(f), zero),
        r * r_over_f,
        df_phi * inv_f,
        2.0 * r_over_f * dr_phi - ratio2 * df_phi,
        df_a * inv_f,
        2.0 * r_over_f * dr_a - ratio2 * df_a,
    ]
    if kernel.samples_nu:
        df_nu, dr_nu = contract(kernel.dcorrelation_dnu)
        terms += [df_nu * inv_f, 2.0 * r_over_f * dr_nu - ratio2 * df_nu]
    elif general:
        terms += [torch.zeros_like(f), torch.zeros_like(f)]
    b = torch.where((fac["mask"] & valid[:, None]), p, zero)  # (C, n_pad, m)
    return (torch.stack(terms), b.transpose(1, 2).contiguous(),
            torch.where(valid, r_over_f, zero))


def _launch(kernel, tables: SiteTables, params, y, emit_y: bool, noise_v,
            sharded=False):
    """One launch of kernel 2; its sums in float64."""
    params, y, v = cuda_args(tables, params, y, noise_v)
    chains = params.shape[0]
    dev = tables.device
    general = kernel.family == GENERAL_FAMILY
    grid_x, geo_args, scratch = launch_geometry("vecchia_grad", kernel, tables, chains, y, v)
    part = torch.empty((8 if general else 6, chains, grid_x),
                       dtype=torch.float32, device=dev)
    # the GENERAL entries take with_nu where the closed-form ones take family
    selector = int(kernel.samples_nu) if general else kernel.family
    args = (params.data_ptr(), tables.tab_a.data_ptr(), tables.tab_b.data_ptr(),
            tables.nn_idx.data_ptr(), y.data_ptr(), y_stride(y), pointer(v),
            *shape_args(tables), chains, selector, *geo_args, part.data_ptr())
    name = entry_name("vecchia_grad", kernel, tables, emit_y)
    entry = getattr(_build.library(), name + "_f32")
    with torch.cuda.device(dev):
        if emit_y:
            b = torch.empty((chains, tables.m, tables.n_pad), dtype=torch.float32,
                            device=dev)
            rof = torch.empty((chains, tables.n_pad), dtype=torch.float32, device=dev)
            code = entry(*args, b.data_ptr(), rof.data_ptr(), _build.stream_handle(dev))
        else:
            code = entry(*args, _build.stream_handle(dev))
    _build.check(code, name)
    del scratch  # the launch is enqueued: the allocator orders any reuse after it
    COUNTS[instance("vecchia_grad", kernel, tables, emit_y, v is not None,
                    sharded)].launches += 1
    count_team("vecchia_grad", kernel, tables, chains, emit_y, sharded)
    sums = part.sum(-1, dtype=torch.float64)
    return (sums, b, rof) if emit_y else sums


def _one(kernel, tables: SiteTables, params, y, emit_y, noise_v, sharded=False):
    """Kernel 2 on CUDA tables, its plain version on CPU tables; sums in
    float64."""
    if tables.device.type == "cuda":
        return _launch(kernel, tables, params, y, emit_y, noise_v, sharded)
    if tables.device.type != "cpu":
        raise ValueError(f"no kernel for device {tables.device}")
    COUNTS[instance("vecchia_grad", kernel, tables, emit_y,
                    noise_v is not None, sharded)].plain += 1
    return _reference64(kernel, tables, params.detach(), y.detach(), emit_y,
                        noise_v)


def value_and_grad_sums(kernel, tables: SiteTables, phi, alpha, y, jitter=1e-6,
                        emit_y: bool = False, nu=None, noise_v=None):
    """(6, C) value and derivative sums ((8, C) for the general-nu Matern),
    and with ``emit_y`` also B (C, m, n_pad) and r/F (C, n_pad): kernel 2 for
    CUDA tensors, :func:`grad_reference` for CPU tensors; one launch a mesh
    cell on :class:`ShardedTables`, the results on the first device.
    ``noise_v``: the per-site noise weights (``ops.suffstats.noise_plane``)
    or None."""
    device = phi.device if isinstance(phi, torch.Tensor) else tables.device
    params = params_array(phi, alpha, jitter, tables.n, tables.dtype, device,
                          kernel_nu(kernel, nu), tables.off)
    if isinstance(tables, ShardedTables):
        out = map_cells(
            tables, params, y, noise_v,
            lambda t, p, y_c, v_c, several: _one(kernel, t, p, y_c, emit_y, v_c, several),
            (None, 2, 1) if emit_y else (None,))
        out = tuple(out) if emit_y else out[0]
    else:
        out = _one(kernel, tables, params, y, emit_y, noise_v)
    if not emit_y:
        return out.to(tables.dtype)
    return (out[0].to(tables.dtype),) + tuple(out[1:])


def dquad_dy(tables: SiteTables, b, rof):
    """dquad/dy (C, n) from the EMIT_Y outputs B (C, m, n_pad) and r/F
    (C, n_pad): site j's own term 2 (r/F)_j minus, for every child i that
    has j as its slot-k neighbor, 2 B_{k,i} (r/F)_i.

    The children are gathered through ``tables.child_flat`` and summed
    densely in a fixed order: no atomics, so the gradient is reproducible.
    The temporary is (C, n, max_children)."""
    if tables.child_flat is None:
        raise ValueError("the y cotangent needs the reverse index: build the "
                         "tables with site_tables.with_children")
    weighted = (b * rof[:, None, :]).reshape(b.shape[0], -1)  # B_{k,i} (r/F)_i
    from_children = weighted[:, tables.child_flat].sum(-1)  # (C, n)
    return 2.0 * (rof[:, :tables.n] - from_children)


class DiffSuffstats(torch.autograd.Function):
    """(logdet, quad) per chain as a differentiable function of (phi, alpha,
    y) and, for a kernel that samples it, nu.

    ``apply(phi, alpha, y, kernel, tables, jitter, nu[, noise_v])`` with
    phi, alpha and nu of shape (C,) (nu is None for a kernel that samples
    none), y of shape (n,) or (C, n), and ``noise_v`` the per-site noise
    weights, None or left out for homogeneous noise."""

    @staticmethod
    def forward(ctx, phi, alpha, y, kernel, tables, jitter, nu, noise_v=None):
        ctx.y_shared = y.dim() == 1
        ctx.with_nu = nu is not None
        needs = ctx.needs_input_grad
        if needs[2]:
            sums, b, rof = value_and_grad_sums(kernel, tables, phi, alpha, y,
                                               jitter, emit_y=True, nu=nu,
                                               noise_v=noise_v)
            sums = sums.to(phi)  # phi's device and dtype
            ctx.tables = tables
            ctx.save_for_backward(sums[2:], b, rof)
        elif needs[0] or needs[1] or needs[6]:
            sums = value_and_grad_sums(kernel, tables, phi, alpha, y, jitter,
                                       nu=nu, noise_v=noise_v).to(phi)
            ctx.save_for_backward(sums[2:])
        else:
            logdet, quad, _, _ = suffstats(kernel, tables, phi, alpha, y, jitter, nu,
                                           noise_v)
            return logdet.to(phi), quad.to(phi)
        return sums[0], sums[1]

    @staticmethod
    def backward(ctx, g_ld, g_q):
        derivs, *emitted = ctx.saved_tensors
        dld_dphi, dq_dphi, dld_da, dq_da = derivs[:4]
        dphi = g_ld * dld_dphi + g_q * dq_dphi
        dalpha = g_ld * dld_da + g_q * dq_da
        dnu = g_ld * derivs[4] + g_q * derivs[5] if ctx.with_nu else None
        dy = None
        if emitted:
            dy = g_q[:, None].to(emitted[1]) * dquad_dy(ctx.tables, *emitted)
            if ctx.y_shared:  # one y for all chains: their cotangents add up
                dy = dy.sum(0)
        return dphi, dalpha, dy, None, None, None, dnu, None


def diff_suffstats(kernel, tables: SiteTables, phi, alpha, y, jitter=1e-6, nu=None,
                   noise_v=None):
    """(logdet, quad) per chain; differentiable in phi, alpha, y and, for a
    kernel that samples it, the per-chain ``nu``; ``noise_v`` the per-site
    noise weights (``ops.suffstats.noise_plane``) or None.

    A differentiated call (grad enabled and phi, alpha, nu or y requiring
    grad) runs kernel 2 once, its EMIT_Y instances when y requires grad (the
    tables then need ``child_flat``); any other call runs kernel 1 only."""
    phi = torch.atleast_1d(phi)
    alpha = torch.as_tensor(alpha, dtype=phi.dtype, device=phi.device)
    alpha = torch.atleast_1d(alpha).expand_as(phi)
    nu = kernel_nu(kernel, nu) if kernel.samples_nu else None
    if nu is not None:
        nu = torch.as_tensor(nu, dtype=phi.dtype, device=phi.device)
        nu = torch.atleast_1d(nu).expand_as(phi)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (phi, alpha, y, nu)):
        return DiffSuffstats.apply(phi, alpha, y, kernel, tables, jitter, nu, noise_v)
    logdet, quad, _, _ = suffstats(kernel, tables, phi, alpha, y, jitter, nu, noise_v)
    return logdet.to(phi), quad.to(phi)
