"""The parallel layer of the port: process groups, the ("data", "model")
device mesh, the ambient-mesh hints and the global-batch reductions of the
data-parallel step; ``parallel.large_graph`` holds the node-sharded GCN
encoder.  The counterpart of ``snd_vae_tpu/parallel/``."""

from .distributed import initialize_distributed, is_primary
from .hints import constrain, shard_nodes, use_mesh
from .mesh import (
    batch_sharding,
    make_mesh,
    mesh_from_config,
    param_shardings,
    replicated,
    shard_graphbatch,
    shard_params,
)

__all__ = [
    "make_mesh",
    "mesh_from_config",
    "batch_sharding",
    "replicated",
    "shard_graphbatch",
    "shard_params",
    "param_shardings",
    "initialize_distributed",
    "is_primary",
    "constrain",
    "shard_nodes",
    "use_mesh",
]
