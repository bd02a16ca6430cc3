"""Collectives with gradients, and the reductions over the global batch of
a data-parallel step.

JAX computes a data-parallel step on the global batch: GSPMD turns each
mean over a batch-sharded array into local sums and a ``psum``.  Each of
the port's processes holds its own rows, so every quantity that reads the
whole batch goes through this module: the loss terms, the class-balance
statistics of the weighted BCE, DIP-VAE's moments, β-TCVAE's log q(z), the
batch statistics of ``BatchStatNorm``, the edge accuracy and the noise
draws.  Each reads the ``data`` axis of the ambient mesh
(``hints.use_mesh``); without one it is the plain op on the tensor as it
is, so the single-process path is unchanged.  A group of one process still
calls its collectives.

The shards are equal (``mesh.shard_graphbatch`` refuses any other split),
so the global mean of a quantity is the mean over ranks of its local
means, taken for several terms at once in one all-reduce of one
flattened buffer.  ``all_reduce`` and ``gather_rows`` have the adjoints
``torch.distributed.nn`` gives them (an all-reduce, and an all-reduce
whose own rows each rank keeps), so every rank computes the same global
loss L, and the gradients the ranks hold sum to world·dL/dθ:
``average_gradients`` divides by the world.

Under a ``model`` axis above 1 the node axis of the big activations is
split over the model ranks too (``hints.shard_nodes``, ``mesh.node_block``:
ceil blocks, the last short), and the same rule holds over both axes:
``gather_nodes`` has the all-gather's adjoint (each rank keeps its rows of
the summed gradient), ``model_sum`` the all-reduce's, so every rank of the
mesh computes the same loss and the gradients sum to (data·model)·dL/dθ.
A tensor whose node axis is sharded enters a global reduction through
``node_mean`` / ``model_sum`` (its rows are disjoint over the model ranks);
one that every model rank holds whole (the truth adjacency, the latents)
through the data-axis functions alone, so it is counted once.

Every collective here runs as it is captured into the train step's CUDA
graph (``train.StepGraph``) and replays so: it reads no number on the
host, its buffers (the gathered parts, the flattened sums) are allocated
in the graph's pool at capture and reused by each replay, and the groups'
communicators exist before the capture (the eager first step made them).
The noise of ``local_rows`` comes from the generator registered with the
graph, so each replay draws the next global batch's.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
from torch.distributed.device_mesh import DeviceMesh

from .hints import DATA_AXIS, MODEL_AXIS, ambient_mesh, model_group
from .mesh import node_block


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        ctx.group, ctx.rows = group, x.shape[0]
        ctx.rank = dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


class _AllReduceFlat(torch.autograd.Function):
    """Several tensors summed over a group in one all-reduce of one
    flattened buffer, times ``scale``; the backward likewise."""

    @staticmethod
    def forward(ctx, group, scale, *tensors):
        ctx.group, ctx.scale, ctx.shapes = group, scale, [t.shape for t in tensors]
        return _reduce_flat([t.reshape(-1) for t in tensors], group, scale, ctx.shapes)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + _reduce_flat([g.reshape(-1) for g in grads], ctx.group, ctx.scale,
                                           ctx.shapes)


def _reduce_flat(flats, group, scale, shapes):
    flat = torch.cat(flats)
    dist.all_reduce(flat, group=group)
    if scale != 1:
        flat.mul_(scale)
    return tuple(v.view(s) for v, s in zip(flat.split([math.prod(s) for s in shapes]), shapes))


class _GatherNodes(torch.autograd.Function):
    """The rows of a node axis split in ``mesh.node_block``'s uneven blocks
    gathered into the whole axis: each block padded to the longest, one
    all-gather, the padding dropped.  Backward: this rank's rows of the
    gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, n, axis, group):
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        size = -(-n // world)
        ctx.group, ctx.axis, ctx.block = group, axis, node_block(n, world, rank)
        pad = [0, 0] * (x.dim() - 1 - axis) + [0, size - x.shape[axis]]
        x = F.pad(x, pad).contiguous() if size != x.shape[axis] else x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=axis).narrow(axis, 0, n)

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        start, size = ctx.block
        return out.narrow(ctx.axis, start, size), None, None, None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the processes of ``group``, with a gradient."""
    return _AllReduceFlat.apply(group, 1.0, x)[0]


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every process's ``x`` [n, ...] of ``group`` stacked in rank order
    along the first axis ([world·n, ...], contiguous), with a gradient."""
    return _GatherRows.apply(x, group)


def gather_blocks(x: torch.Tensor, n: int, axis: int, group) -> torch.Tensor:
    """The whole axis ``axis`` (``n`` long) from every process of ``group``
    holding its ``mesh.node_block`` of it, with a gradient (this rank's
    block of the gradient summed over the group)."""
    return _GatherNodes.apply(x, n, axis, group)


def gather_nodes(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    """The whole node axis (``n`` long, at ``axis``) from every model
    rank's rows of it, with a gradient; ``x`` as it is without a model axis
    above 1."""
    group = model_group()
    return x if group is None else gather_blocks(x, n, axis, group)


def model_sum(*local_sums: torch.Tensor):
    """Each model rank's sums over its own node rows added over the model
    axis, in one all-reduce; the tensors as they are without a model axis
    above 1.  One tensor in, one out."""
    group = model_group()
    if group is not None:
        local_sums = _AllReduceFlat.apply(group, 1.0, *local_sums)
    return local_sums[0] if len(local_sums) == 1 else local_sums


def node_mean(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    """The mean of every element of the tensor whose ``axis`` is a node axis
    of ``n`` and of which ``x`` holds this rank's rows (``hints.own_block``);
    ``x.mean()`` without a model axis above 1."""
    if model_group() is None:
        return x.mean()
    count = math.prod(x.shape[:axis]) * n * math.prod(x.shape[axis + 1:])
    return model_sum(x.sum()) / count


def _data_group():
    """The ambient mesh's data-axis process group, or None without a mesh."""
    mesh = ambient_mesh()
    if mesh is None or DATA_AXIS not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(DATA_AXIS)


def _over_data_axis(tensors: Tuple[torch.Tensor, ...], mean: bool):
    group = _data_group()
    if group is not None:
        scale = 1.0 / dist.get_world_size(group) if mean else 1.0
        tensors = _AllReduceFlat.apply(group, scale, *tensors)
    return tensors[0] if len(tensors) == 1 else tensors


def global_sum(*local_sums: torch.Tensor):
    """Each rank's sums added over the data axis, in one all-reduce; the
    tensors as they are without a mesh.  One tensor in, one out."""
    return _over_data_axis(local_sums, mean=False)


def global_mean(*local_means: torch.Tensor):
    """The global batch's means from each rank's means over its own equal
    block, in one all-reduce; the tensors as they are without a mesh."""
    return _over_data_axis(local_means, mean=True)


def global_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch's rows of ``x`` (this rank's block on its first
    axis), with a gradient; ``x`` as it is without a mesh."""
    group = _data_group()
    return x if group is None else gather_rows(x, group)


def local_rows(draw: Callable[[Tuple[int, ...]], torch.Tensor],
               shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)`` for this rank's block of the batch: every rank draws
    the global batch's noise from the same generator (the stream a single
    process draws) and keeps its own rows, so the ranks' generators stay
    in step."""
    group = _data_group()
    shape = tuple(shape)
    if group is None:
        return draw(shape)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    full = draw((shape[0] * world,) + shape[1:])
    return full[rank * shape[0]:(rank + 1) * shape[0]]


def average_gradients(params: Iterable[torch.Tensor], mesh: DeviceMesh,
                      sharded: Iterable[torch.Tensor] = ()) -> None:
    """Average the parameters' ``.grad`` over the mesh in place: one
    all-reduce of one flattened buffer per dtype over the model axis (when
    above 1) and one over the data axis, as DDP's buckets do, then a
    division by the number of processes.  The slices in ``sharded``
    (``tensor_parallel``) skip the model axis: the all-gather that makes
    them whole already summed their gradients over it."""
    world = dist.get_world_size(mesh.get_group(DATA_AXIS))
    model = mesh.get_group(MODEL_AXIS) if MODEL_AXIS in mesh.mesh_dim_names else None
    m = 1 if model is None else dist.get_world_size(model)
    skip = {id(t) for t in sharded}
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault((p.grad.dtype, id(p) in skip), []).append(p.grad)
    for (_, is_slice), grads in by_dtype.items():
        flat = _flatten_dense_tensors(grads)
        if m > 1 and not is_slice:
            dist.all_reduce(flat, group=model)
        dist.all_reduce(flat, group=mesh.get_group(DATA_AXIS))
        flat.div_(world * m)
        torch._foreach_copy_(grads, _unflatten_dense_tensors(flat, grads))
