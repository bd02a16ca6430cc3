"""Checkpoints of the port's training state — the counterpart of
``snd_vae_tpu/checkpoint.py`` (which writes Orbax directories; the port
does not read those).

One ``torch.save`` file per saved epoch, ``ckpt_<epoch>.pt`` under the
directory, holding the model's f32 state_dict, the optimizer's state_dict,
the step count and the state of the trainer's generator (the ε stream), so
that a restored run continues bit for bit.  The tensors are whole and in
the unsharded layout whatever the mesh (``checkpoint_payload``; under the
mesh's model axis every rank gathers its slices, ``parallel.tensor_
parallel``), so a run saved on one mesh resumes on another, or in one
process.  A save goes to a temporary file
first and is moved into place with ``os.replace``: a crash mid-save leaves
the previous checkpoints as they were.  With ``max_to_keep`` a save then
deletes the oldest other files beyond that many, as Orbax's option of that
name does (the held-out best checkpoint keeps one).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch

from .parallel.tensor_parallel import (
    load_whole_optimizer_state, load_whole_state_dict, whole_optimizer_state, whole_state_dict,
)

_NAME = re.compile(r"ckpt_(\d+)\.pt")


def checkpoint_dir(cfg, workdir: str) -> str:
    """Where a run of ``cfg`` under ``workdir`` keeps its checkpoints:
    ``<workdir>/<train.checkpoint_dir>/<dataset>_<model_type>``, as the JAX
    package lays them out."""
    return os.path.join(workdir, cfg.train.checkpoint_dir, f"{cfg.dataset}_{cfg.model_type}")


def checkpoint_payload(state) -> Dict[str, Any]:
    """What a checkpoint of ``state`` (a ``train.TrainState``) holds: whole
    tensors in the unsharded layout.  Under a model axis every model rank
    calls it (the gathers are collectives)."""
    return {
        "model": whole_state_dict(state.model),
        "optimizer": whole_optimizer_state(state.optimizer, state.model),
        "step": int(state.step),
        "generator": state.generator.get_state(),
    }


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(os.path.expanduser(directory))
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{int(step)}.pt")

    def save(self, step: int, state, payload: Optional[Dict[str, Any]] = None) -> None:
        """Write ``state`` (a ``train.TrainState``) as the checkpoint of
        epoch ``step``; ``payload``, its ``checkpoint_payload`` when the
        caller has it already."""
        os.makedirs(self.directory, exist_ok=True)
        if payload is None:
            payload = checkpoint_payload(state)
        tmp = self.path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path(step))
        if self.max_to_keep is not None:
            # the file just written stays, whatever its epoch
            others = [s for s in self.steps() if s != int(step)]
            for old in others[:max(len(others) - self.max_to_keep + 1, 0)]:
                os.remove(self.path(old))

    def steps(self):
        if not os.path.isdir(self.directory):
            return []
        found = (_NAME.fullmatch(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def load(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The saved payload of ``step`` (the latest when None), on the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        return torch.load(self.path(step), map_location="cpu", weights_only=True)

    def restore(self, state, step: Optional[int] = None):
        """Load the checkpoint of ``step`` (the latest when None) into
        ``state`` in place; returns it."""
        payload = self.load(step)
        load_whole_state_dict(state.model, payload["model"])
        load_whole_optimizer_state(state.optimizer, state.model, payload["optimizer"])
        state.step = payload["step"]
        state.generator.set_state(payload["generator"])
        return state
