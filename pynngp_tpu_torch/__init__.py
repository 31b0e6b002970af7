"""pynngp_tpu_torch: the PyTorch + CUDA port of pynngp_tpu for NVIDIA Hopper.

The response NNGP (Vecchia) model, with fixed effects, homogeneous or
per-site noise, Metropolis-within-Gibbs sampling and a MAP/Laplace fit, and
the latent-w NNGP model with its chromatic Gibbs sweep, over hand-written CUDA kernels for the fused Vecchia
sufficient statistics, their value + gradient pass and the explicit kriging
weights B/F (``csrc/``, built with nvcc at first use).  CPU tensors run the kernels' plain PyTorch versions.
The package imports no JAX; ``pynngp_tpu`` stays the reference it is tested
against.
"""

from pynngp_tpu_torch.diagnostics import ess, split_rhat
from pynngp_tpu_torch.kernels import Exponential, Matern, Spherical, SqExp, get_kernel
from pynngp_tpu_torch.models.latent import LatentNNGP, LatentState
from pynngp_tpu_torch.models.response import ResponseNNGP, ResponseState
from pynngp_tpu_torch.neighbors import NeighborTable, build_neighbor_table
from pynngp_tpu_torch.noise import HeterogeneousNoise, HomogeneousNoise, get_noise
from pynngp_tpu_torch.vecchia import (
    VecchiaData,
    make_vecchia_data,
    vecchia_bf,
    vecchia_loglik,
    vecchia_suffstats,
)

__all__ = [
    "ResponseNNGP",
    "ResponseState",
    "LatentNNGP",
    "LatentState",
    "SqExp",
    "Exponential",
    "Spherical",
    "Matern",
    "get_kernel",
    "HomogeneousNoise",
    "HeterogeneousNoise",
    "get_noise",
    "NeighborTable",
    "build_neighbor_table",
    "VecchiaData",
    "make_vecchia_data",
    "vecchia_bf",
    "vecchia_suffstats",
    "vecchia_loglik",
    "ess",
    "split_rhat",
]
