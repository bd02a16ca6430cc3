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
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
from torch.distributed.device_mesh import DeviceMesh

from .hints import DATA_AXIS, ambient_mesh


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


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the processes of ``group``, with a gradient."""
    return _AllReduceFlat.apply(group, 1.0, x)[0]


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every process's ``x`` [n, ...] of ``group`` stacked in rank order
    along the first axis ([world·n, ...], contiguous), with a gradient."""
    return _GatherRows.apply(x, group)


def _data_group():
    """The ambient mesh's data-axis process group, or None without a mesh."""
    mesh = ambient_mesh()
    return None if mesh is None else mesh.get_group(DATA_AXIS)


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


def average_gradients(params: Iterable[torch.Tensor], mesh: DeviceMesh) -> None:
    """Average the parameters' ``.grad`` over the mesh's data axis in
    place: one all-reduce of one flattened buffer per dtype, as DDP's
    buckets do, then a division by the number of ranks."""
    group = mesh.get_group(DATA_AXIS)
    world = dist.get_world_size(group)
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        torch._foreach_copy_(grads, _unflatten_dense_tensors(flat, grads))

