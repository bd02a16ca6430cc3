"""Rematerialization: named big-tensor regions and the selective policies —
the port of ``snd_vae_tpu/nn/ckpt.py``.

``Config.remat`` runs each motif conv (third and fourth order) and the
adjacency head under ``torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)`` (``rematerialized``): the forward keeps the region's
inputs, and the backward runs the region again to get what it needs.
``Config.remat_policy`` picks what the forward keeps besides, through
``create_selective_checkpoint_contexts``:

  * ``recompute-big`` — every op run inside a ``big(name)`` region is
    recomputed, every other op's output is kept (JAX's
    ``save_anything_except_these_names``): the O(B·N²·h) and larger tensors
    go, the small ones stay;
  * ``dots-no-batch`` — the outputs of matmuls without a batch axis
    (``aten.mm`` / ``aten.addmm``) are kept and everything else recomputed
    (JAX's ``checkpoint_dots_with_no_batch_dims``).

Both policies recompute the ops that allocate a buffer (``empty_like``,
``zeros``, ...).  A policy sees aten ops only; the CUDA kernels fill their
outputs through ctypes (``fused_motif_level3``'s and
``fused_motif_level4``'s ``empty_like``, ``blocked_adj_matmul``'s
``empty``), so keeping such a buffer would hand
the recompute the forward's buffer to fill again.  Recomputed, it gets a
fresh one, and the kernel launches once more per region and step.

Where the tags are (``BIG_NAMES``; ``tests/test_torch_remat.py`` holds the
``big(...)`` call sites to this list):
  * ``nn/spatial_conv.py::spatial_graph_conv_3d`` — ``sgc3.nd4``,
    ``sgc3.m4_sum`` (pu), ``sgc3.tm`` (K4's output), ``sgc3.m3_sum``, on
    the unblocked and the row-blocked lowering alike: a policy's cache sees
    the ops of a ``checkpoint`` nested inside its region, so untagged block
    tensors would be kept, block after block;
  * ``nn/kernels/motif_level4.py::motif_level4_plain`` — ``sgc3.m4_sum``,
    the m4 buffer that only the plain version (the CPU) builds; on the card
    ``fused_motif_level4`` never writes it;
  * ``nn/kernels/motif_level3.py::motif_level3_plain`` — the third order's
    ``sgc.d_ij``, ``sgc.rf``, ``sgc.wf``, ``sgc.m3_sum``.  Only the plain
    version (the CPU) builds them; on the card ``fused_motif_level3`` is
    one kernel from φ(rel) to nt and never writes them, as JAX's Pallas
    branch leaves its ``f_ik`` untagged;
  * ``models/outputs.py::adjacency_e2e`` — ``dec.pair`` (the tile-concat
    map) and ``dec.e2e`` (each E2E layer after the first separable one).

Under the mesh's model axis the regions hold the node-sharded sites (the
motif convs' rows, the adjacency head's rows and E2E's gathers): the
recompute takes the same rows and runs the same collectives again, in the
same order on every rank, as JAX's remat regions hold its hints.

Regions are identity outside a checkpoint, so the hot code carries them
unconditionally.  The open regions are per thread, as autograd's grad mode
is.
"""

from __future__ import annotations

import functools
import threading
from contextlib import contextmanager
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn
from torch.nn.utils.stateless import _reparametrize_module
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

BIG_NAMES = (
    "sgc.d_ij", "sgc.rf", "sgc.wf", "sgc.m3_sum",
    "sgc3.nd4", "sgc3.m4_sum", "sgc3.tm", "sgc3.m3_sum",
    "dec.pair", "dec.e2e",
)

_aten = torch.ops.aten
_ALLOCATING = {
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten.zeros, _aten.zeros_like, _aten.new_zeros,
    _aten.ones, _aten.ones_like, _aten.new_ones, _aten.full, _aten.full_like,
    _aten.new_full,
}
_DOTS_NO_BATCH = {_aten.mm, _aten.addmm}
_regions = threading.local()


def open_regions() -> Sequence[str]:
    """The names of the ``big`` regions open on this thread, innermost last."""
    return getattr(_regions, "names", ())


@contextmanager
def big(name: str):
    """Mark the ops run inside as producers of the big tensor ``name``, which
    must be in ``BIG_NAMES`` (a name outside it would escape the policies)."""
    if name not in BIG_NAMES:
        raise ValueError(f"big region {name!r} is not registered in nn.ckpt.BIG_NAMES")
    outer = open_regions()
    _regions.names = (*outer, name)
    try:
        yield
    finally:
        _regions.names = outer


def _recompute_big(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op.overloadpacket in _ALLOCATING or open_regions():
        return CheckpointPolicy.PREFER_RECOMPUTE
    return CheckpointPolicy.MUST_SAVE


def _dots_no_batch(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op.overloadpacket in _DOTS_NO_BATCH:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


POLICIES = {"recompute-big": _recompute_big, "dots-no-batch": _dots_no_batch}


def policy_from_config(remat: bool, remat_policy: Optional[str]) -> Optional[Callable]:
    """``context_fn`` of ``checkpoint`` for (Config.remat, Config.remat_policy),
    or None for plain remat (keep the inputs only) or no remat."""
    if not remat or remat_policy is None:
        return None
    if remat_policy not in POLICIES:
        raise ValueError(
            f"unknown remat_policy {remat_policy!r}; expected recompute-big | dots-no-batch"
        )
    return functools.partial(create_selective_checkpoint_contexts, POLICIES[remat_policy])


def rematerialized(model: nn.Module, owner: nn.Module, fn: Callable, *args,
                   params: Optional[Dict[str, torch.Tensor]] = None):
    """``fn(*args)``; with ``model.cfg.remat`` while autograd records, under
    a non-reentrant checkpoint with ``model.remat_context`` (the policy's
    contexts, from ``policy_from_config``).  ``params`` (names under
    ``owner``, default all of its parameters, as ``fn`` reads them now) go
    in as inputs and are bound to ``owner`` again while the backward reruns
    ``fn``: a bf16 step runs the model on casts of its parameters
    (``torch.func.functional_call``), which are unbound by then.  JAX wraps
    the same regions in ``nn.remat`` (``models/disentangled.py:74-87,
    302-309``, ``models/joint.py:44-55, 191-198``)."""
    if not model.cfg.remat or not torch.is_grad_enabled():
        return fn(*args)
    if params is None:
        params = dict(owner.named_parameters())
    names, n = list(params), len(args)

    def run(*flat):
        with _reparametrize_module(owner, dict(zip(names, flat[n:]))):
            return fn(*flat[:n])

    kw = {} if model.remat_context is None else {"context_fn": model.remat_context}
    return checkpoint(run, *args, *params.values(), use_reentrant=False, **kw)
