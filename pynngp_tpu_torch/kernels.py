"""Correlation kernels (counterpart of ``pynngp_tpu.kernels``).

Kernels are unit-variance correlation functions rho(d); the model owns
sigma^2 and the nugget.  Each closed-form kernel also carries the integer
``family`` code that selects its rho and d rho / d phi inside the CUDA
kernels (``csrc/vecchia_common.cuh``), and ``dcorrelation_dphi``, the plain
counterpart of the reference's ``_drho_fn`` (``pynngp_tpu/ops/pallas_bf.py``).

- SqExp:        rho(d) = exp(-(d/phi)^2)
- Exponential:  rho(d) = exp(-d/phi)
- Spherical:    rho(d) = 1 - 1.5 t + 0.5 t^3, t = min(d/phi, 1)
- Matern(nu):   rho(d) = 2^(1-nu)/Gamma(nu) t^nu K_nu(t), t = sqrt(2 nu) d/phi;
  closed forms for static nu in {1/2, 3/2, 5/2} (families 3-5), and the
  general form through :mod:`pynngp_tpu_torch.bessel` for any other static
  nu and for ``Matern()``, whose nu is a sampled parameter (family 6).

Two floors.  ``correlation`` sets rho = 1 below t = 1e-12, as the reference's
``kernels.py`` does.  The fused kernels floor t at 1e-8
(``pallas_bf.py:301,690``): ``fused_correlation``, ``dcorrelation_dphi`` and
``dcorrelation_dnu`` follow them, and so do the CUDA kernels and their plain
versions.  For every closed form the two are the same function.
"""

from __future__ import annotations

import math

import torch

from pynngp_tpu_torch.bessel import kve

__all__ = ["SqExp", "Exponential", "Spherical", "Matern", "get_kernel"]

_HALF_INTEGER_NU = (0.5, 1.5, 2.5)
_SAFE_EPS = 1e-12  # floor of t in correlation
_FUSED_EPS = 1e-8  # floor of t in the fused kernels
_NU_STEP = 1e-2  # half width of the kernels' central difference in nu
_NU_MIN = 1e-3  # its lower point is clamped here


class KernelBase:
    name: str = "base"
    family: int = -1
    param_names: tuple = ("phi",)
    static_nu = None

    @property
    def samples_nu(self) -> bool:
        """True when nu is a sampled parameter: it rides the kernels'
        parameter row per chain and kernel 2 emits the two nu sums."""
        return "nu" in self.param_names

    def default_params(self, dtype=torch.float32, device=None) -> dict:
        """The initial parameters: phi = 1, and nu = 1.5 where nu is sampled."""
        out = {"phi": torch.tensor(1.0, dtype=dtype, device=device)}
        if self.samples_nu:
            out["nu"] = torch.tensor(1.5, dtype=dtype, device=device)
        return out

    def correlation(self, d, params):  # pragma: no cover - abstract
        raise NotImplementedError

    def fused_correlation(self, d, params):
        """rho as the fused kernels compute it (the reference's ``_rho_fn``)."""
        return self.correlation(d, params)

    def dcorrelation_dphi(self, d, phi, nu=None):  # pragma: no cover - abstract
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"


class SqExp(KernelBase):
    """Squared-exponential: rho(d) = exp(-(d/phi)^2)."""

    name = "sqexp"
    family = 0

    def correlation(self, d, params):
        t = d / params["phi"]
        return torch.exp(-(t * t))

    def dcorrelation_dphi(self, d, phi, nu=None):
        t = d / phi
        return torch.exp(-(t * t)) * 2.0 * d * d / (phi**3)


class Exponential(KernelBase):
    """Exponential: rho(d) = exp(-d/phi)."""

    name = "exponential"
    family = 1

    def correlation(self, d, params):
        return torch.exp(-d / params["phi"])

    def dcorrelation_dphi(self, d, phi, nu=None):
        return torch.exp(-d / phi) * d / (phi * phi)


class Spherical(KernelBase):
    """Spherical: compactly supported on [0, phi]."""

    name = "spherical"
    family = 2

    def correlation(self, d, params):
        t = torch.clamp(d / params["phi"], max=1.0)
        return 1.0 - 1.5 * t + 0.5 * t * t * t

    def dcorrelation_dphi(self, d, phi, nu=None):
        t = d / phi
        inside = (t < 1.0).to(d.dtype)
        return inside * 1.5 * t * (1.0 - t * t) / phi


class Matern(KernelBase):
    """Matern with smoothness nu.

    ``Matern(nu=1.5)`` (static nu in {0.5, 1.5, 2.5}) uses the exact closed
    forms.  ``Matern()`` samples nu: it becomes a kernel parameter
    (``param_names = ("phi", "nu")``) and every evaluation goes through the
    Bessel K_nu.  ``Matern(nu=0.8)`` fixes a general static nu."""

    name = "matern"

    def __init__(self, nu=None):
        self.static_nu = None if nu is None else float(nu)
        self.param_names = ("phi",) if nu is not None else ("phi", "nu")
        if self.static_nu in _HALF_INTEGER_NU:
            self.family = 3 + _HALF_INTEGER_NU.index(self.static_nu)
        else:
            self.family = 6  # kMaternGeneral

    @property
    def closed_form(self) -> bool:
        return self.family != 6

    def nu_of(self, params):
        """The static nu, or the sampled one from ``params``."""
        return self.static_nu if self.static_nu is not None else params["nu"]

    def _t(self, d, phi):
        return math.sqrt(2.0 * self.static_nu) * d / phi

    def _general(self, d, phi, nu, floor, order_shift=0.0):
        """exp of 2^(1-nu)/Gamma(nu) t^(nu + s) K_{nu - s}(t) in log space,
        s = ``order_shift``, with t floored at ``floor``; returns (value, t)."""
        nu = torch.as_tensor(nu, dtype=d.dtype, device=d.device)
        t = torch.sqrt(2.0 * nu) * d / phi
        ts = torch.clamp(t, min=floor)
        log_v = ((1.0 - nu) * math.log(2.0) - torch.lgamma(nu)
                 + (nu + order_shift) * torch.log(ts)
                 + torch.log(kve(ts, nu - order_shift)) - ts)
        return torch.exp(log_v), t

    def _closed(self, d, phi):
        t = self._t(d, phi)
        e = torch.exp(-t)
        if self.static_nu == 0.5:
            return e
        if self.static_nu == 1.5:
            return (1.0 + t) * e
        return (1.0 + t + t * t / 3.0) * e

    def _rho(self, d, params, floor):
        if self.closed_form:
            return self._closed(d, params["phi"])
        rho, t = self._general(d, params["phi"], self.nu_of(params), floor)
        return torch.where(t < floor, torch.ones_like(t), rho)  # rho(0) = 1

    def correlation(self, d, params):
        return self._rho(d, params, _SAFE_EPS)

    def fused_correlation(self, d, params):
        return self._rho(d, params, _FUSED_EPS)

    def dcorrelation_dphi(self, d, phi, nu=None):
        if not self.closed_form:
            # d/dt [t^nu K_nu(t)] = -t^nu K_{nu-1}(t) and dt/dphi = -t/phi, so
            # drho/dphi = 2^(1-nu)/Gamma(nu) t^(nu+1) K_{nu-1}(t) / phi
            # (``_drho_fn``, pallas_bf.py:683-698); K_{-a} = K_a covers nu < 1
            nu = self.static_nu if nu is None else nu
            val, t = self._general(d, phi, nu, _FUSED_EPS, order_shift=1.0)
            return torch.where(t < _FUSED_EPS, torch.zeros_like(t), val / phi)
        t = self._t(d, phi)
        e = torch.exp(-t)
        if self.static_nu == 0.5:
            return e * t / phi
        if self.static_nu == 1.5:
            return e * t * t / phi
        return e * t * t * (1.0 + t) / (3.0 * phi)

    def dcorrelation_dnu(self, d, phi, nu):
        """d rho / d nu as the fused kernels take it (``_drho_nu_fn``,
        pallas_bf.py:712-722): a central difference of the fused rho with
        h = 1e-2, the lower point clamped to 1e-3, over the actual width.
        h balances the float32 series' noise against the O(h^2) truncation;
        the samplers stay exact, their acceptance uses energies."""
        nu = torch.as_tensor(nu, dtype=d.dtype, device=d.device)
        hi = nu + _NU_STEP
        lo = torch.clamp(nu - _NU_STEP, min=_NU_MIN)
        rho = lambda v: self.fused_correlation(d, {"phi": phi, "nu": v})
        return (rho(hi) - rho(lo)) / (hi - lo)

    def __repr__(self):
        return f"Matern(nu={self.static_nu})"


_REGISTRY = {
    "sqexp": SqExp,
    "squared_exponential": SqExp,
    "exponential": Exponential,
    "matern": Matern,
    "spherical": Spherical,
}


def get_kernel(name_or_obj, **kwargs):
    """Resolve a kernel from a name (e.g. ``'sqexp'``) or pass one through."""
    if isinstance(name_or_obj, str):
        return _REGISTRY[name_or_obj.lower()](**kwargs)
    if not isinstance(name_or_obj, KernelBase):
        raise NotImplementedError(
            f"kernel {name_or_obj!r} is not a pynngp_tpu_torch kernel"
        )
    return name_or_obj
