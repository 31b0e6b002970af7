"""Differentiable Vecchia sufficient statistics — the counterpart of
``make_diff_suffstats`` (``pynngp_tpu/ops/pallas_bf.py:1051-1158``).

:class:`DiffSuffstats` is a ``torch.autograd.Function`` of (phi, alpha) per
chain.  When phi or alpha requires grad, its forward runs kernel 2
(``csrc/vecchia_grad.cu``) once: the value and the six partial sums (logdet,
quad and their phi and alpha derivatives) come out of one pass over the
tables, and ``backward`` contracts the saved derivatives with the cotangents
exactly as the reference's ``bwd`` does (``pallas_bf.py:1144-1155``).
Otherwise it runs kernel 1.  The y cotangent is zero, as at the reference's
``y_grad=False`` (y is data in the response model without fixed effects);
a y that requires grad raises until the ``emit_y`` variant is ported.

Per site (u = L^-1 c, v = L^-1 y_N, p = C^-1 c, q = C^-1 y_N):
  F = (1+alpha) - u.u,          r = y_0 - u.v
  dF/dphi = -2 p.(dc/dphi) + p'(dC/dphi)p,   dr/dphi = -(dc/dphi).q + p'(dC/dphi)q
  dF/dalpha = 1 + p.p,          dr/dalpha = p.q
and d/dt sum log F = sum dF/F,  d/dt sum r^2/F = sum (2 r dr F - r^2 dF)/F^2.
"""

from __future__ import annotations

import torch

from pynngp_tpu_torch.ops import _build
from pynngp_tpu_torch.ops.site_tables import BLOCK, SiteTables
from pynngp_tpu_torch.ops.suffstats import _factor, cuda_args, params_array, suffstats

__all__ = ["COUNT", "DiffSuffstats", "diff_suffstats", "grad_reference",
           "value_and_grad_sums"]

COUNT = _build.LaunchCount("vecchia_grad")


def grad_reference(kernel, tables: SiteTables, params, y):
    """Plain PyTorch version of kernel 2: (6, C) sums of logdet, quad,
    dlogdet/dphi, dquad/dphi, dlogdet/dalpha, dquad/dalpha, accumulated in
    float64 and cast to the tables' dtype."""
    fac = _factor(kernel, tables, params, y)
    low, u, v, f, valid = fac["low"], fac["u"], fac["v"], fac["f"], fac["valid"]
    mask_f = fac["mask"].to(f.dtype)
    r = fac["y_own"] - (u * v).sum(-1)
    # back-substitution p = L^-T u, q = L^-T v
    p = torch.linalg.solve_triangular(low.mT, u[..., None], upper=True)[..., 0]
    q = torch.linalg.solve_triangular(low.mT, v[..., None], upper=True)[..., 0]
    phi = params[:, 0:1]
    dc = kernel.dcorrelation_dphi(fac["d_in"], phi[..., None]) * mask_f
    # drho(0) = 0 for every kernel, so dC/dphi has no diagonal
    d_cmat = (kernel.dcorrelation_dphi(fac["d_nn"], phi[..., None, None])
              * mask_f[..., :, None] * mask_f[..., None, :])
    p_dc = (p[..., :, None] * d_cmat).sum(-2)  # p' dC/dphi
    df_phi = -2.0 * (p * dc).sum(-1) + (p_dc * p).sum(-1)
    dr_phi = -(dc * q).sum(-1) + (p_dc * q).sum(-1)
    df_a = 1.0 + (p * p).sum(-1)
    dr_a = (p * q).sum(-1)
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    inv_f = torch.where(valid, 1.0 / f, zero)
    r_over_f = r * inv_f
    ratio2 = r_over_f * r_over_f
    terms = torch.stack([
        torch.where(valid, torch.log(f), zero),
        r * r_over_f,
        df_phi * inv_f,
        2.0 * r_over_f * dr_phi - ratio2 * df_phi,
        df_a * inv_f,
        2.0 * r_over_f * dr_a - ratio2 * df_a,
    ])  # (6, C, n_pad)
    return terms.sum(-1, dtype=torch.float64).to(f.dtype)


def _launch(kernel, tables: SiteTables, params, y):
    params, y = cuda_args(tables, params, y)
    chains = params.shape[0]
    dev = tables.d_in.device
    part = torch.empty((6, chains, tables.n_pad // BLOCK), dtype=torch.float32,
                       device=dev)
    code = _build.library().vecchia_grad_f32(
        params.data_ptr(), tables.d_in.data_ptr(), tables.d_tri.data_ptr(),
        tables.nn_idx.data_ptr(), y.data_ptr(), tables.n_pad, tables.m, chains,
        kernel.family, part.data_ptr(), _build.stream_handle(dev),
    )
    _build.check(code, "vecchia_grad_f32")
    COUNT.launches += 1
    return part.sum(-1, dtype=torch.float64).to(torch.float32)


def value_and_grad_sums(kernel, tables: SiteTables, phi, alpha, y, jitter=1e-6):
    """(6, C) value and derivative sums: kernel 2 for CUDA tensors,
    :func:`grad_reference` for CPU tensors."""
    params = params_array(phi, alpha, jitter, tables.n, tables.d_in.dtype,
                          tables.d_in.device)
    if tables.d_in.is_cuda:
        return _launch(kernel, tables, params, y)
    if tables.d_in.device.type != "cpu":
        raise ValueError(f"no kernel for device {tables.d_in.device}")
    COUNT.plain += 1
    return grad_reference(kernel, tables, params.detach(), y)


class DiffSuffstats(torch.autograd.Function):
    """(logdet, quad) per chain as a differentiable function of (phi, alpha).

    ``apply(phi, alpha, y, kernel, tables, jitter)`` with phi, alpha of
    shape (C,)."""

    @staticmethod
    def forward(ctx, phi, alpha, y, kernel, tables, jitter):
        if ctx.needs_input_grad[2]:
            raise NotImplementedError(
                "the y cotangent (y_grad=True, the emit_y kernel variant) is "
                "not ported yet"
            )
        if not (ctx.needs_input_grad[0] or ctx.needs_input_grad[1]):
            logdet, quad, _, _ = suffstats(kernel, tables, phi, alpha, y, jitter)
            return logdet.to(phi.dtype), quad.to(phi.dtype)
        sums = value_and_grad_sums(kernel, tables, phi, alpha, y, jitter)
        ctx.save_for_backward(sums[2:].to(phi.dtype))
        return sums[0].to(phi.dtype), sums[1].to(phi.dtype)

    @staticmethod
    def backward(ctx, g_ld, g_q):
        (derivs,) = ctx.saved_tensors
        dld_dphi, dq_dphi, dld_da, dq_da = derivs
        dphi = g_ld * dld_dphi + g_q * dq_dphi
        dalpha = g_ld * dld_da + g_q * dq_da
        return dphi, dalpha, None, None, None, None


def diff_suffstats(kernel, tables: SiteTables, phi, alpha, y, jitter=1e-6):
    """(logdet, quad) per chain; differentiable in phi and alpha.

    A differentiated call (grad enabled and phi or alpha requiring grad)
    runs kernel 2 once; any other call runs kernel 1 only."""
    phi = torch.atleast_1d(phi)
    alpha = torch.as_tensor(alpha, dtype=phi.dtype, device=phi.device)
    alpha = torch.atleast_1d(alpha).expand_as(phi)
    if torch.is_grad_enabled() and (phi.requires_grad or alpha.requires_grad
                                    or y.requires_grad):
        return DiffSuffstats.apply(phi, alpha, y, kernel, tables, jitter)
    logdet, quad, _, _ = suffstats(kernel, tables, phi, alpha, y, jitter)
    return logdet.to(phi.dtype), quad.to(phi.dtype)
