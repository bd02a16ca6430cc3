"""Tensor-parallel parameters: the mesh's ``model`` axis on the weights —
the counterpart of JAX's ``shard_params`` (``snd_vae_tpu/parallel/
mesh.py:50-78``) and the Trainer's sharded state (``train.py:366-371``).

JAX places each big parameter and its Adam moments on the mesh with a
``NamedSharding`` and lets GSPMD gather them where the program reads them.
Here a parameter that ``mesh.param_shardings`` shards becomes its ``model``
rank's slice (``Shard(dim)``: the equal block ``rank`` of ``dim``), held by
a ``torch.nn.utils.parametrize`` parametrization: the module's parameter is
the slice, the optimizer and its moments see only the slice, and reading
``module.<name>`` all-gathers the whole tensor over the model axis
(``_Gathered``), whose backward sums the gradient over the model ranks and
keeps this rank's block.  ``parametrize.cached()`` around a forward gathers
each tensor once; in the train step's CUDA graph (``train.StepGraph``)
that gather and its backward's sum over the model ranks are captured with
the step, and the slices, being the module's parameters, get their
``.grad`` back from the graph after each chunk as every parameter does.

Checkpoints hold whole tensors under the unsharded names and in the
unsharded parameter order (``whole_state_dict``, ``whole_optimizer_state``;
``load_whole_state_dict`` / ``load_whole_optimizer_state`` take them back),
so a run saved on one mesh resumes on any other, or in one process.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize
from torch.distributed.device_mesh import DeviceMesh

from .batch import gather_blocks
from .mesh import MODEL_AXIS, param_shardings

_MARK = ".parametrizations."


class _Gathered(nn.Module):
    """The parametrization of a parameter sharded on ``dim`` over the
    model group: ``right_inverse`` keeps this rank's block of the whole
    tensor, ``forward`` gathers the blocks back."""

    def __init__(self, dim: int, group):
        super().__init__()
        self.dim, self.group = dim, group
        self.parts, self.rank = dist.get_world_size(group), dist.get_rank(group)

    def forward(self, block: torch.Tensor) -> torch.Tensor:
        return gather_blocks(block, block.shape[self.dim] * self.parts, self.dim, self.group)

    def right_inverse(self, whole: torch.Tensor) -> torch.Tensor:
        return block_of(whole, self.dim, self.parts, self.rank)


def block_of(whole: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
    """Equal block ``index`` of ``parts`` of ``whole``'s ``dim``, a copy."""
    size = whole.shape[dim] // parts
    return whole.detach().narrow(dim, index * size, size).clone()


def own_slice(t: torch.Tensor, placements: Tuple, mesh: DeviceMesh) -> torch.Tensor:
    """This process's slice of ``t`` under ``placements`` (from
    ``param_shardings``): its model rank's block of the sharded axis, or
    ``t`` when it is replicated."""
    model = placements[1]
    if not model.is_shard():
        return t
    return block_of(t, model.dim, mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS)),
                    mesh.get_local_rank(MODEL_AXIS))


def _owner(module: nn.Module, name: str) -> Tuple[nn.Module, str]:
    path, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    return (module.get_submodule(path) if path else module), leaf


def shard_module(module: nn.Module, mesh: DeviceMesh, min_size: int = 1 << 14) -> nn.Module:
    """Make each parameter of ``module`` that ``param_shardings`` shards over
    ``model`` this rank's slice of it (see the module docstring); returns
    ``module``.  The parameters' unsharded names and order are kept as
    ``module.tp_names`` for ``canonical_parameters`` and the checkpoints."""
    names = [n for n, _ in module.named_parameters()]
    placements = param_shardings(dict(module.named_parameters()), mesh, min_size)
    group = mesh.get_group(MODEL_AXIS)
    for name in names:
        model = placements[name][1]
        if model.is_shard():
            owner, leaf = _owner(module, name)
            parametrize.register_parametrization(owner, leaf, _Gathered(model.dim, group),
                                                 unsafe=True)
    module.tp_names = names
    return module


def sharded(module: nn.Module) -> Dict[str, Tuple[torch.Tensor, _Gathered]]:
    """The sharded parameters of ``module`` by unsharded name: (the slice
    this rank holds, its parametrization: dim, group, parts, rank)."""
    out = {}
    for name, p in module.named_parameters():
        if _MARK in name and name.endswith(".original"):
            path, leaf = name[:-len(".original")].split(_MARK)
            owner = module.get_submodule(path) if path else module
            out[f"{path}.{leaf}" if path else leaf] = (p, owner.parametrizations[leaf][0])
    return out


def canonical_parameters(module: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """(unsharded name, the tensor this process holds) in the unsharded
    module's parameter order: what the optimizer is built over, so that its
    state's indices are those of an unsharded run."""
    names = getattr(module, "tp_names", None)
    if names is None:
        return list(module.named_parameters())
    split = sharded(module)
    plain = dict(module.named_parameters())
    return [(n, split[n][0] if n in split else plain[n]) for n in names]


def whole_tensors(module: nn.Module, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``tensors`` (by unsharded parameter name: the parameters, their
    gradients, ...) with each sharded parameter's slice gathered whole,
    detached (every model rank calls it: the gathers are collectives)."""
    split = sharded(module)

    def whole(name, t):
        if name not in split:
            return t.detach()
        g = split[name][1]
        return gather_blocks(t.detach(), t.shape[g.dim] * g.parts, g.dim, g.group)

    return {name: whole(name, t) for name, t in tensors.items()}


def whole_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every sharded parameter gathered whole
    under its unsharded name, in the unsharded order."""
    if not sharded(module):
        return module.state_dict()
    return whole_tensors(module, dict(canonical_parameters(module)))


def load_whole_state_dict(module: nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """Load a whole (unsharded) state dict: each sharded parameter takes
    this rank's block of its tensor."""
    split = sharded(module)
    if not split:
        module.load_state_dict(state)
        return
    held = dict(canonical_parameters(module))
    if set(held) != set(state):
        raise KeyError(f"state dict keys differ from the module's parameters: "
                       f"{sorted(set(held) ^ set(state))}")
    with torch.no_grad():
        for name, t in held.items():
            t.copy_(split[name][1].right_inverse(state[name]) if name in split else state[name])


def _map_moments(state: dict, module: nn.Module, fn) -> dict:
    """An optimizer ``state_dict`` with ``fn(parametrization, tensor)``
    applied to each moment of every sharded parameter (the optimizer was
    built over ``canonical_parameters(module)``, so index i is name i)."""
    split = sharded(module)
    if not split:
        return state
    names = [n for n, _ in canonical_parameters(module)]
    out = {}
    for idx, st in state["state"].items():
        g = split[names[int(idx)]][1] if names[int(idx)] in split else None
        out[idx] = {k: fn(g, v) if g is not None and torch.is_tensor(v) and v.dim() > 0 else v
                    for k, v in st.items()}
    return {"state": out, "param_groups": state["param_groups"]}


def whole_optimizer_state(optimizer: torch.optim.Optimizer, module: nn.Module) -> dict:
    """``optimizer.state_dict()`` with the moments of every sharded
    parameter gathered whole (collectives, as ``whole_tensors``)."""
    return _map_moments(optimizer.state_dict(), module, lambda g, v: gather_blocks(
        v, v.shape[g.dim] * g.parts, g.dim, g.group))


def load_whole_optimizer_state(optimizer: torch.optim.Optimizer, module: nn.Module,
                               state: dict) -> None:
    """Load a whole optimizer state: each sharded parameter's moments take
    this rank's block."""
    optimizer.load_state_dict(_map_moments(state, module, lambda g, v: g.right_inverse(v)))


def slices(module: nn.Module) -> List[torch.Tensor]:
    """The sharded slices ``module`` holds (for ``batch.average_gradients``)."""
    return [t for t, _ in sharded(module).values()]
