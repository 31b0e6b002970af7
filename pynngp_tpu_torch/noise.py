"""Noise (nugget) models — the counterpart of ``pynngp_tpu.noise``.

- :class:`HomogeneousNoise`: a constant nugget tau^2 I.
- :class:`HeterogeneousNoise`: per-site variance tau^2 v_i with fixed known
  positive weights v (measurement-error weights, say), given in the user's
  site order; tau^2 stays inverse-gamma conjugate with weighted residuals.

A noise model provides the per-site variance and weights; the models permute
v into ordered site space and hand it to the kernels (``noise_v``).
"""

from __future__ import annotations

import torch

__all__ = ["HomogeneousNoise", "HeterogeneousNoise", "get_noise"]


class HomogeneousNoise:
    """tau^2 I."""

    name = "homogeneous"

    def variance(self, tau2, n):
        tau2 = torch.as_tensor(tau2)
        return tau2 * torch.ones((n,), dtype=tau2.dtype, device=tau2.device)

    def weights(self, n, dtype=torch.float32, device="cpu"):
        return torch.ones((n,), dtype=dtype, device=device)


class HeterogeneousNoise:
    """tau^2 diag(v) with fixed positive weights v (n,), in the user's site
    order."""

    name = "heterogeneous"

    def __init__(self, v):
        self.v = torch.as_tensor(v)

    def variance(self, tau2, n):
        tau2 = torch.as_tensor(tau2)
        return tau2 * self.v.to(dtype=tau2.dtype, device=tau2.device)

    def weights(self, n, dtype=torch.float32, device="cpu"):
        return self.v.to(dtype=dtype, device=device)


def get_noise(name_or_obj, **kwargs):
    """A noise model from its name ("homogeneous", "heterogeneous", with the
    class's arguments as keywords) or the model itself.
    ``get_noise("heterogeneous")`` without ``v`` raises ``TypeError``, as the
    reference's does."""
    if isinstance(name_or_obj, str):
        return {
            "homogeneous": HomogeneousNoise,
            "heterogeneous": HeterogeneousNoise,
        }[name_or_obj.lower()](**kwargs)
    return name_or_obj
