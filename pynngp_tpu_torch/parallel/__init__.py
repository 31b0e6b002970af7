"""Several devices and several processes: the (chains, sites) mesh, the
site-sharded likelihood, B/F build and chromatic sweep, and process-group
bring-up (counterpart of ``pynngp_tpu.parallel``, under its twelve public
names)."""

from pynngp_tpu_torch.parallel.distributed import (
    global_mesh,
    host_local_to_global,
    initialize_distributed,
    process_chain_slice,
)
from pynngp_tpu_torch.parallel.sharded import (
    Mesh,
    make_mesh,
    make_sharded_bf,
    make_sharded_chromatic,
    make_sharded_loglik,
    make_sharded_suffstats,
    pad_data_for_sharding,
    shard_color_tables,
    shard_vecchia_data,
)

__all__ = [
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
    "Mesh",
]
