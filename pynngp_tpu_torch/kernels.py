"""Correlation kernels (counterpart of ``pynngp_tpu.kernels``).

Kernels are unit-variance correlation functions rho(d); the model owns
sigma^2 and the nugget.  Each closed-form kernel also carries the integer
``family`` code that selects its rho and d rho / d phi inside the CUDA
kernels (``csrc/vecchia_common.cuh``), and ``dcorrelation_dphi``, the plain
counterpart of the reference's ``_drho_fn`` (``pynngp_tpu/ops/pallas_bf.py``).

- SqExp:        rho(d) = exp(-(d/phi)^2)
- Exponential:  rho(d) = exp(-d/phi)
- Spherical:    rho(d) = 1 - 1.5 t + 0.5 t^3, t = min(d/phi, 1)
- Matern(nu):   closed forms for nu in {1/2, 3/2, 5/2}.  General and sampled
  nu need the Bessel K_nu port (``bessel.py``) and raise for now.
"""

from __future__ import annotations

import math

import torch

__all__ = ["SqExp", "Exponential", "Spherical", "Matern", "get_kernel"]

_HALF_INTEGER_NU = (0.5, 1.5, 2.5)


class KernelBase:
    name: str = "base"
    family: int = -1

    def correlation(self, d, params):  # pragma: no cover - abstract
        raise NotImplementedError

    def dcorrelation_dphi(self, d, phi):  # pragma: no cover - abstract
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

    def dcorrelation_dphi(self, d, phi):
        t = d / phi
        return torch.exp(-(t * t)) * 2.0 * d * d / (phi**3)


class Exponential(KernelBase):
    """Exponential: rho(d) = exp(-d/phi)."""

    name = "exponential"
    family = 1

    def correlation(self, d, params):
        return torch.exp(-d / params["phi"])

    def dcorrelation_dphi(self, d, phi):
        return torch.exp(-d / phi) * d / (phi * phi)


class Spherical(KernelBase):
    """Spherical: compactly supported on [0, phi]."""

    name = "spherical"
    family = 2

    def correlation(self, d, params):
        t = torch.clamp(d / params["phi"], max=1.0)
        return 1.0 - 1.5 * t + 0.5 * t * t * t

    def dcorrelation_dphi(self, d, phi):
        t = d / phi
        inside = (t < 1.0).to(d.dtype)
        return inside * 1.5 * t * (1.0 - t * t) / phi


class Matern(KernelBase):
    """Matern with static half-integer smoothness nu in {0.5, 1.5, 2.5}.

    ``Matern()`` (sampled nu) and general static nu need the Bessel K_nu
    port and raise ``NotImplementedError``."""

    name = "matern"

    def __init__(self, nu=None):
        self.static_nu = None if nu is None else float(nu)
        if self.static_nu not in _HALF_INTEGER_NU:
            raise NotImplementedError(
                f"Matern(nu={nu}) needs the general-nu Bessel port; only "
                "static nu in {0.5, 1.5, 2.5} is ported"
            )
        self.family = 3 + _HALF_INTEGER_NU.index(self.static_nu)

    def _t(self, d, phi):
        return math.sqrt(2.0 * self.static_nu) * d / phi

    def correlation(self, d, params):
        t = self._t(d, params["phi"])
        e = torch.exp(-t)
        if self.static_nu == 0.5:
            return e
        if self.static_nu == 1.5:
            return (1.0 + t) * e
        return (1.0 + t + t * t / 3.0) * e

    def dcorrelation_dphi(self, d, phi):
        t = self._t(d, phi)
        e = torch.exp(-t)
        if self.static_nu == 0.5:
            return e * t / phi
        if self.static_nu == 1.5:
            return e * t * t / phi
        return e * t * t * (1.0 + t) / (3.0 * phi)

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
