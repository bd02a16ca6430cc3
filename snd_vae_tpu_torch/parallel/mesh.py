"""The ``("data", "model")`` device mesh — the counterpart of
``snd_vae_tpu/parallel/mesh.py:22-78``.

JAX places global arrays on a ``Mesh`` with ``NamedSharding``s and lets
GSPMD insert the collectives.  The port is explicit SPMD: a
``torch.distributed`` ``DeviceMesh`` over the processes of the default
group (one per card), each process holding its own block, and the
collectives called on the mesh's named groups (``mesh.get_group("data")``).
``batch_sharding`` / ``replicated`` / ``param_shardings`` return the
placements JAX's shardings name (``Shard(0)`` over ``data``,
``Replicate()``); ``shard_graphbatch`` takes this process's block of a
global batch.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from ..config import MeshConfig
from ..device import DeviceLike, resolve_device
from ..params import torch_perm
from .distributed import backend_for

# canonical axis names of the 2-D ('data', 'model') mesh
DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)


def make_mesh(data: int = 1, model: int = 1, device: DeviceLike = None) -> DeviceMesh:
    """A ``data`` x ``model`` mesh over every process of the default group
    (call ``initialize_distributed`` first), on ``device``'s type (CUDA
    unless named).  Raises ValueError unless data·model is the group's
    size, and RuntimeError when the group's backend is not the device's."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.initialize_distributed() first (the CLI: --distributed)")
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} processes, "
                         f"the group has {world}")
    backend = dist.get_backend()
    if backend != backend_for(dev):
        raise RuntimeError(f"the process group runs {backend}, a {dev.type} mesh needs "
                           f"{backend_for(dev)}")
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=AXES)


def mesh_from_config(cfg: MeshConfig, device: DeviceLike = None) -> DeviceMesh:
    return make_mesh(cfg.data, cfg.model, device)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of ``axis`` on ``mesh``; 1 for an axis the mesh lacks (a
    sub-mesh such as ``mesh["model"]``)."""
    names = mesh.mesh_dim_names or ()
    return mesh.shape[names.index(axis)] if axis in names else 1


def node_block(n: int, parts: int, index: int) -> Tuple[int, int]:
    """Rows [start, start + size) of a node axis of ``n`` that part
    ``index`` of ``parts`` holds: ceil(n / parts) rows each, the last part
    short (25 over 4: 7, 7, 7, 4; 10 over 4: 3, 3, 3, 1), as GSPMD pads an
    uneven axis.  A part past the end holds no rows."""
    size = -(-n // parts)
    start = min(index * size, n)
    return start, min(size, n - start)


def batch_sharding(mesh: DeviceMesh) -> Tuple:
    """The leading (graph-batch) axis sharded over ``data``."""
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh) -> Tuple:
    return (Replicate(), Replicate())


def shard_graphbatch(batch, mesh: DeviceMesh, axis: int = 0):
    """This process's contiguous block of every batch-axis tensor of a
    global ``GraphBatch``: rows [r·B/d, (r+1)·B/d) of ``axis`` (the graphs;
    1 for an epoch's batches [nb, B, ...]) for data rank r of d, a view.
    Raises ValueError when d does not divide B."""
    d, r = axis_size(mesh, DATA_AXIS), mesh.get_local_rank(DATA_AXIS)
    B = batch.adj.shape[axis]
    if B % d:
        raise ValueError(f"a batch of {B} graphs does not split over {d} data ranks")
    return batch._map(lambda t: t.narrow(axis, r * (B // d), B // d))


def param_shardings(params: Mapping[str, torch.Tensor], mesh: DeviceMesh,
                    min_size: int = 1 << 14) -> Dict[str, Tuple]:
    """Each parameter's placements, by JAX's rule on its flax layout: a
    tensor of at least ``min_size`` elements shards over ``model`` the last
    flax axis that the ``model`` axis divides; everything else is
    replicated.  ``params`` are the port's tensors under the port's names
    (a ``state_dict``): the rule reads each in the flax layout
    (``params.torch_perm``) and the placement names the port's axis, so
    every element lives on the ``model`` rank where JAX places it."""
    m = axis_size(mesh, MODEL_AXIS)

    def one(name, p):
        if m > 1 and p.dim() > 0 and math.prod(p.shape) >= min_size:
            perm = torch_perm(name.rsplit(".", 1)[-1], p.dim())
            for flax_ax in reversed(range(p.dim())):
                ax = perm.index(flax_ax)
                if p.shape[ax] % m == 0 and p.shape[ax] >= m:
                    return (Replicate(), Shard(ax))
        return replicated(mesh)

    return {name: one(name, p) for name, p in params.items()}


def shard_params(params: Union[nn.Module, Mapping[str, torch.Tensor]], mesh: DeviceMesh,
                 min_size: int = 1 << 14):
    """Place the parameters on the mesh: rank 0's values are broadcast to
    every process, in one flattened buffer per dtype, and written in place.
    At ``model`` = 1 that is all.
    Above it each process keeps its ``model`` rank's slice of every tensor
    ``param_shardings`` shards: a module's parameter becomes that slice
    (``tensor_parallel.shard_module``: the module reads the whole tensor,
    all-gathered, in its forward); a mapping is returned with the slices
    in place of those tensors.  Returns the module, or the mapping."""
    module = params if isinstance(params, nn.Module) else None
    named = dict(module.named_parameters()) if module is not None else dict(params)
    by_dtype: Dict[torch.dtype, list] = {}
    for t in named.values():
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for tensors in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in tensors])
            dist.broadcast(flat, src=0)
            for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
                t.copy_(v.view_as(t))
    if axis_size(mesh, MODEL_AXIS) == 1:
        return params
    from .tensor_parallel import own_slice, shard_module   # it imports this module
    if module is not None:
        return shard_module(module, mesh, min_size)
    placements = param_shardings(named, mesh, min_size)
    return {name: own_slice(t, placements[name], mesh) for name, t in named.items()}
