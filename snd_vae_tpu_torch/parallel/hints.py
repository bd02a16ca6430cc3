"""The ambient mesh and the node-sharding hints — the counterpart of
``snd_vae_tpu/parallel/hints.py:29-81``.

``use_mesh(mesh)`` makes ``mesh`` the ambient mesh of the code it wraps, as
``jax.set_mesh`` does: the data-parallel train step runs under it, and the
global-batch reductions (``parallel/batch.py``) read its ``data`` axis.

In JAX, ``constrain`` and ``shard_nodes`` are layout hints that GSPMD turns
into collectives over the whole program.  The port runs eagerly and has no
such compiler: partitioning the node axis over ``model`` needs sharded
modules and explicit collectives at every hint site.  So both are the
identity unless the ambient mesh has a ``model`` axis above 1, where they
raise (ROADMAP.md queue 1, item 6(a)).
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from .mesh import DATA_AXIS, MODEL_AXIS, MODEL_AXIS_TODO, axis_size  # noqa: F401

_AMBIENT: ContextVar[Optional[DeviceMesh]] = ContextVar("ambient_mesh", default=None)


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


def _check_no_model_axis() -> None:
    mesh = ambient_mesh()
    if mesh is not None and axis_size(mesh, MODEL_AXIS) > 1:
        raise NotImplementedError(MODEL_AXIS_TODO)


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """JAX's ``with_sharding_constraint(x, P(*spec))`` hint: the identity
    without a ``model`` axis above 1."""
    _check_no_model_axis()
    return x


def shard_nodes(x: torch.Tensor, batch_axes: int = 1, tag: str = "") -> torch.Tensor:
    """JAX's hint that partitions ``x``'s first node axis over ``model``:
    the identity without a ``model`` axis above 1."""
    _check_no_model_axis()
    return x
