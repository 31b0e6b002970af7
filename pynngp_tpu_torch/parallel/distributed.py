"""Several processes on ``torch.distributed`` — the counterpart of
``pynngp_tpu.parallel.distributed``.

Each process is the one controller of its own devices
(:mod:`pynngp_tpu_torch.parallel.sharded`).  Across processes the chains
axis is split: a process owns a contiguous slice of the chains
(:func:`process_chain_slice`), runs them on its share of the mesh
(:func:`global_mesh`), and the only collectives are over the chains (a
reduction of per-chain values, the pooling of draws).  Nothing tells a
process of a cluster: the caller passes the coordinator's address, the
number of processes and this process's rank to
:func:`initialize_distributed`.

Backends.  NCCL, the default on CUDA, refuses two ranks on one card; two
processes that share a card run ``backend="gloo"``, which moves CUDA tensors
for ``all_reduce`` and ``broadcast`` only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "initialize_distributed",
    "global_mesh",
    "host_local_to_global",
    "process_chain_slice",
]


def _world():
    """(number of processes, this process's rank): (1, 0) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None):
    """Bring up the default process group; a no-op for one process or a
    group that is already up.

    ``coordinator_address`` is "host:port" (or a ``tcp://`` URL), to which
    every process connects; ``backend`` defaults to "nccl" where torch sees
    a card and "gloo" elsewhere (pass "gloo" for ranks that share a card)."""
    if dist.is_initialized() or num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("several processes need coordinator_address and "
                         "process_id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = (coordinator_address if coordinator_address.startswith("tcp://")
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)


def global_mesh(n_chain_shards: int = 1, n_site_shards: Optional[int] = None,
                devices=None):
    """This process's share of a (chains, sites) mesh whose chains axis runs
    across the processes: ``n_chain_shards / processes`` chain rows, the
    sites axis over this process's ``devices`` (default: its visible
    cards)."""
    from pynngp_tpu_torch.parallel.sharded import make_mesh

    processes, _ = _world()
    if n_chain_shards % processes:
        raise ValueError(f"{n_chain_shards} chain shards do not split over "
                         f"{processes} processes")
    return make_mesh(n_chain_shards // processes, n_site_shards, devices)


def host_local_to_global(mesh, pspec, host_arrays):
    """This process's shard of an array (its chains' rows, or a value every
    process holds whole) on the mesh's first device, where the sampler's
    state lives and every sharded call takes its inputs.  ``pspec`` is the
    reference's PartitionSpec argument and is not read: the site tables are
    placed shard by shard by ``ops.site_tables.shard_site_tables``."""
    return torch.as_tensor(np.asarray(host_arrays)).to(mesh.first)


def process_chain_slice(n_chains_total: int):
    """The chains this process owns under chain sharding."""
    processes, rank = _world()
    per = n_chains_total // processes
    return slice(rank * per, (rank + 1) * per)
