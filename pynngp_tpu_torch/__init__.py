"""pynngp_tpu_torch: the PyTorch + CUDA port of pynngp_tpu for NVIDIA Hopper.

The ``SeqNNGP`` workflow (construct -> sample -> predict) over the response
NNGP (Vecchia) model, with fixed effects, homogeneous or per-site noise,
Metropolis-within-Gibbs, NUTS, HMC, tempered SMC, ADVI and a MAP/Laplace
fit, and the latent-w NNGP model with its chromatic Gibbs sweep; kriging
prediction for every posterior draw; the Euclidean and dot-product distances
and the coordinate, max-min and natural orderings.  The models run on
hand-written CUDA kernels for the fused Vecchia sufficient statistics, their
value + gradient pass and the explicit kriging weights B/F (``csrc/``, built
with nvcc at first use), under the chunked multi-chain driver with
checkpoints and config sidecars (``NNGPConfig``).  Both models shard sites
and chains over a mesh of devices (``mesh=``, :mod:`.parallel`); several
processes join over ``torch.distributed``.  CPU tensors run the kernels'
plain PyTorch versions.  The package imports no JAX;
``pynngp_tpu`` stays the reference it is tested against.
"""

import torch

from pynngp_tpu_torch.config import NNGPConfig
from pynngp_tpu_torch.diagnostics import ess, split_rhat, summarize
from pynngp_tpu_torch.distance import DotProduct, Euclidean
from pynngp_tpu_torch.kernels import Exponential, Matern, Spherical, SqExp, get_kernel
from pynngp_tpu_torch.models.latent import LatentNNGP, LatentState
from pynngp_tpu_torch.models.response import ResponseNNGP, ResponseState
from pynngp_tpu_torch.models.seq import SeqNNGP
from pynngp_tpu_torch.neighbors import NeighborTable, build_neighbor_table
from pynngp_tpu_torch.noise import HeterogeneousNoise, HomogeneousNoise, get_noise
from pynngp_tpu_torch.parallel import (
    global_mesh,
    host_local_to_global,
    initialize_distributed,
    make_mesh,
    make_sharded_bf,
    make_sharded_chromatic,
    make_sharded_loglik,
    make_sharded_suffstats,
    pad_data_for_sharding,
    process_chain_slice,
    shard_color_tables,
    shard_vecchia_data,
)
from pynngp_tpu_torch.predict import build_prediction_table, predict_draws
from pynngp_tpu_torch.vecchia import (
    VecchiaData,
    make_vecchia_data,
    vecchia_bf,
    vecchia_loglik,
    vecchia_suffstats,
)



def _settle_cpu_math() -> None:
    """One serial call of each vectorized CPU function the plain versions
    use, in float32 and float64, before any call runs on several threads.

    torch's first vectorized float64 exp of a process, when several threads
    run it at once, came out up to 3.3e-9 off (relative) over one thread's
    share of the elements in 3 of 120 fresh processes on a loaded 8-core
    host, and never in 150 after a serial call of 16 elements: a race in the
    lazy set-up of the vectorized kernel.  The plain versions are held to
    the reference at rtol 1e-8, so the race failed a comparison of B now and
    then (tests/test_torch_cpu_math.py)."""
    for dtype in (torch.float32, torch.float64):
        x = torch.full((64,), 0.5, dtype=dtype)
        for fn in (torch.exp, torch.log, torch.log1p, torch.sqrt, torch.sin,
                   torch.sinh, torch.cosh, torch.lgamma):
            fn(x)
        # the SMC sampler's weights
        torch.logsumexp(x, 0)
        torch.cumsum(x, 0)


_settle_cpu_math()

__all__ = [
    "NNGPConfig",
    "SeqNNGP",
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
    "Euclidean",
    "DotProduct",
    "NeighborTable",
    "build_neighbor_table",
    "VecchiaData",
    "make_vecchia_data",
    "vecchia_bf",
    "vecchia_suffstats",
    "vecchia_loglik",
    "build_prediction_table",
    "predict_draws",
    "ess",
    "split_rhat",
    "summarize",
    # several devices and processes (parallel/)
    "make_mesh",
    "make_sharded_bf",
    "make_sharded_chromatic",
    "make_sharded_loglik",
    "make_sharded_suffstats",
    "pad_data_for_sharding",
    "shard_color_tables",
    "shard_vecchia_data",
    "initialize_distributed",
    "global_mesh",
    "host_local_to_global",
    "process_chain_slice",
]
