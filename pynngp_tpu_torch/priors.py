"""Priors and unconstrained-space transforms (counterpart of
``pynngp_tpu.priors``).  Priors hold plain Python floats; ``logpdf`` takes a
tensor in natural space.  Samplers work in unconstrained space and add the
transform's log-Jacobian."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = [
    "InverseGamma",
    "Uniform",
    "LogNormal",
    "Normal",
    "log_transform",
    "logit_transform",
]

_LOG_SQRT_2PI = 0.918938533204672669541


class InverseGamma(NamedTuple):
    """IG(a, b) with density b^a/Gamma(a) x^{-a-1} e^{-b/x}."""

    a: float = 2.0
    b: float = 1.0

    def logpdf(self, x):
        x = torch.as_tensor(x)
        a = torch.as_tensor(self.a, dtype=x.dtype, device=x.device)
        return (
            self.a * math.log(self.b)
            - torch.lgamma(a)
            - (self.a + 1.0) * torch.log(x)
            - self.b / x
        )


class Uniform(NamedTuple):
    lo: float = 0.0
    hi: float = 1.0

    def logpdf(self, x):
        x = torch.as_tensor(x)
        inside = (x >= self.lo) & (x <= self.hi)
        return torch.where(
            inside,
            torch.full_like(x, -math.log(self.hi - self.lo)),
            torch.full_like(x, -math.inf),
        )


class LogNormal(NamedTuple):
    mu: float = 0.0
    sigma: float = 1.0

    def logpdf(self, x):
        x = torch.as_tensor(x)
        z = (torch.log(x) - self.mu) / self.sigma
        return -0.5 * z * z - torch.log(x * self.sigma) - _LOG_SQRT_2PI


class Normal(NamedTuple):
    mu: float = 0.0
    sigma: float = 1.0

    def logpdf(self, x):
        x = torch.as_tensor(x)
        z = (x - self.mu) / self.sigma
        return -0.5 * z * z - math.log(self.sigma) - _LOG_SQRT_2PI


class log_transform:
    """x = exp(u): positive parameters. log|dx/du| = u."""

    @staticmethod
    def forward(u):
        return torch.exp(u)

    @staticmethod
    def inverse(x):
        return torch.log(x)

    @staticmethod
    def log_jac(u):
        return u


class logit_transform:
    """x = lo + (hi-lo) sigmoid(u): interval parameters (e.g. phi bounds)."""

    def __init__(self, lo, hi):
        self.lo = lo
        self.hi = hi

    def forward(self, u):
        s = torch.where(
            u >= 0, 1.0 / (1.0 + torch.exp(-u)), torch.exp(u) / (1.0 + torch.exp(u))
        )
        return self.lo + (self.hi - self.lo) * s

    def inverse(self, x):
        p = (x - self.lo) / (self.hi - self.lo)
        return torch.log(p) - torch.log1p(-p)

    def log_jac(self, u):
        # log|dx/du| = log(hi-lo) + log s + log(1-s)
        softplus = torch.where(
            u > 30.0, u, torch.log1p(torch.exp(torch.clamp(u, max=30.0)))
        )
        softplus_neg = softplus - u  # softplus(-u)
        return math.log(self.hi - self.lo) - softplus - softplus_neg
