"""The ambient mesh and the node-sharding hints — the counterpart of
``snd_vae_tpu/parallel/hints.py:29-81``.

``use_mesh(mesh)`` makes ``mesh`` the ambient mesh of the code it wraps, as
``jax.set_mesh`` does: the train step runs under it, the global-batch
reductions (``parallel/batch.py``) read its ``data`` axis and the
node-sharded sites its ``model`` axis.

In JAX, ``constrain`` and ``shard_nodes`` are layout hints that GSPMD turns
into collectives over the whole program.  The port runs eagerly and has no
such compiler, so under a ``model`` axis above 1 a hint does the
partitioning itself: ``shard_nodes`` returns this rank's rows of the node
axis (``mesh.node_block``: ceil blocks, the last one short), and the
sharded modules compute on those rows and call the collectives of
``parallel/batch.py`` where a site reads every node.  On a model axis of 1
(a data-parallel mesh) or without a mesh both hints are the identity and
nothing collective runs for the node axis, as XLA elides a constraint to
a trivial axis, so those paths are unchanged.

Each ``shard_nodes`` site reports ``(tag, start, stop, n)`` to ``_INSPECT``
when it is set, the counterpart of JAX's compile-time hook of that name
(``snd_vae_tpu/parallel/hints.py:63-80``): the tests read it to see which
sites really hold a part of the node axis.  A site reports from Python, as
the step's code runs: under the default dispatch on the card that is the
eager first step and the capture (``train.StepGraph``), not the replays,
which run the captured kernels alone; per step (``per_step=True``, the CPU)
every step reports.
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import DATA_AXIS, MODEL_AXIS, axis_size, node_block  # noqa: F401

_AMBIENT: ContextVar[Optional[DeviceMesh]] = ContextVar("ambient_mesh", default=None)

# test hook: when set to a callable, every shard_nodes site under a mesh
# that names a model axis calls it with (tag, start, stop, n) of the rows
# it keeps (all n on an axis of 1)
_INSPECT = None


@contextmanager
def use_mesh(mesh: Optional[DeviceMesh]):
    """``mesh`` as the ambient mesh inside the block (None: no mesh)."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def ambient_mesh() -> Optional[DeviceMesh]:
    return _AMBIENT.get()


def model_group():
    """The ambient mesh's ``model`` process group when that axis is above
    1, else None (no node sharding)."""
    mesh = ambient_mesh()
    if mesh is None or axis_size(mesh, MODEL_AXIS) == 1:
        return None
    return mesh.get_group(MODEL_AXIS)


def own_block(n: int) -> Tuple[int, int]:
    """(start, size) of this rank's rows of a node axis of ``n``: all of it
    without a model axis."""
    group = model_group()
    if group is None:
        return 0, n
    return node_block(n, dist.get_world_size(group), dist.get_rank(group))


def _rows(x: torch.Tensor, axis: int, nodes: Optional[int], tag: str) -> torch.Tensor:
    n = x.shape[axis] if nodes is None else nodes
    start, size = own_block(n)
    if x.shape[axis] == n:
        x = x.narrow(axis, start, size)
    elif x.shape[axis] != size:
        raise ValueError(f"shard_nodes({tag!r}): axis {axis} holds {x.shape[axis]} rows, "
                         f"neither the {n} nodes nor this rank's {size}")
    if _INSPECT is not None:
        _INSPECT(tag or "activation", start, start + size, n)
    return x


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """JAX's ``with_sharding_constraint(x, P(*spec))`` hint: under a model
    axis above 1, this rank's rows of the axis whose entry names ``model``
    (the other entries are what each process holds already); the identity
    otherwise."""
    if model_group() is None:
        return x
    for axis, s in enumerate(spec):
        names = s if isinstance(s, (tuple, list)) else (s,)
        if MODEL_AXIS in names:
            return _rows(x, axis, None, "constrain")
    return x


def shard_nodes(x: torch.Tensor, batch_axes: int = 1, tag: str = "",
                nodes: Optional[int] = None) -> torch.Tensor:
    """JAX's hint that partitions ``x``'s first node axis (position
    ``batch_axes``) over ``model``: under a model axis above 1 this rank's
    rows of it, reported to ``_INSPECT`` as ``tag``; the identity otherwise
    (reported too, as all n rows, under a mesh whose model axis is 1).
    With ``nodes`` (the whole axis's length) an ``x`` that already holds
    this rank's rows is returned as it is."""
    if model_group() is None:
        mesh = ambient_mesh()
        if _INSPECT is not None and mesh is not None and MODEL_AXIS in (
                mesh.mesh_dim_names or ()):
            n = x.shape[batch_axes]
            _INSPECT(tag or "activation", 0, n, n)
        return x
    return _rows(x, batch_axes, nodes, tag)
