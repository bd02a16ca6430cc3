"""What every traffic mode shares, and the mode found by name.  A cell names a
configuration (``configs/<name>.json``: sizes, precision, generator, split
sizes) and a traffic mix (``traffic/<name>.json``: a ``mode`` and its
parameters); ``drive`` runs the mode's module, ``modes/<mode>.py``, whose
``drive(ctx) -> Outcome`` sets the cell up from the seed, drives its window,
traces it when asked, and judges what the window's entry produced against
the plain reference (``reference/``).  A new mix of an existing mode is a
data file alone; a new mode is a new module beside the others.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .traces import Trace

HERE = Path(__file__).resolve().parent
TRACE_MARGIN_S = 0.1


class TraceRefused(RuntimeError):
    """The traced run's trace lacks device records of launches it made."""


@dataclass
class Run:
    """What a traced run leaves for the per-layer metric readers."""

    cell: str
    mode: str
    cfg: dict
    traffic: dict
    trace: Optional[Trace] = None
    window: Optional[tuple] = None          # the traced window, the trace's µs
    launches: Optional[dict] = None         # the program's trace_rank0.launches.json
    units: int = 0                          # train steps or requests in the traced window
    trees: List[np.ndarray] = field(default_factory=list)   # their trees, [B,S,N,N] each
    graphs_per_unit: int = 0
    enqueue_ms: List[float] = field(default_factory=list)
    peak_bytes_window: int = 0

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return self.trace.busy_us(self.window) / 1e6


@dataclass
class Outcome:
    e2e: Dict[str, float]
    attempted: int
    failed: int
    numbers: Dict[str, float]
    peak_bytes: int
    run: Optional[Run] = None


@dataclass
class Context:
    """One run of one cell."""

    name: str
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    setup_s: float = 0.0
    # the tests' hook on the program object the window drives (a fault)
    patch_program: Callable = lambda obj: None
    # what the check found out about its worst leaf (``control.py`` prints it)
    look: dict = field(default_factory=dict)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def port_config(cfg: dict, seed: int):
    """The program's ``Config`` of a configuration file, from its preset with
    every size, width and setting the file states."""
    from snd_vae_tpu_torch import config as pc

    base = pc.preset(cfg["preset"])
    sub = lambda dc, d: replace(dc, **{k: _tuples(v) for k, v in d.items()})
    return base.with_(
        model_type=cfg["model_type"], compute_dtype=cfg["compute_dtype"],
        num_nodes=cfg["num_nodes"], num_features=cfg["num_features"],
        spatial_dim=cfg["spatial_dim"], rel_dim=cfg["rel_dim"],
        sampling_num=cfg["sampling_num"], parity=True,
        encoder=sub(base.encoder, cfg["encoder"]), decoder=sub(base.decoder, cfg["decoder"]),
        loss=sub(base.loss, cfg["loss"]), train=sub(base.train, {**cfg["train"], "seed": seed}))


def load_weights(model: torch.nn.Module, P0: Dict[str, torch.Tensor]) -> None:
    """The benchmark's weights into the program's model; its parameters must
    be the reference's, name for name and shape for shape."""
    have = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {k: tuple(v.shape) for k, v in P0.items()}
    if have != want:
        raise RuntimeError("the program's parameters are not the reference's: "
                           f"{sorted(set(have.items()) ^ set(want.items()))[:6]}")
    model.load_state_dict(P0)


def to_device(data: Dict[str, np.ndarray], dev, lo: int = 0, n: Optional[int] = None):
    hi = None if n is None else lo + n
    return {k: torch.as_tensor(v[lo:hi], device=dev) for k, v in data.items()}


def graphbatch(data: Dict[str, np.ndarray], dev):
    from snd_vae_tpu_torch.data.graphbatch import from_numpy

    return from_numpy(data["adj"], data["features"], data["coords"], data["rel"],
                      adj_samples=data["adj_samples"]).to(dev)


def peak_bytes(dev: torch.device) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def mode_module(mode: str, root: Path = HERE):
    """``modes/<mode>.py``, found by name."""
    path = root / "modes" / f"{mode}.py"
    if not path.is_file():
        raise ValueError(f"unknown traffic mode {mode!r}: no {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_mode_{mode.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def drive(ctx: Context) -> Outcome:
    return mode_module(ctx.traffic["mode"]).drive(ctx)
