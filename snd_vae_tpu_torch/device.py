"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another one.  Asking for CUDA where there is none raises; nothing falls
    back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def full_f32() -> None:
    """f32 means f32 on the card: matmuls and cuDNN convolutions of f32
    tensors run in full f32, not TF32 (PyTorch lets cuDNN take TF32 by
    default), so what an entry point computes on the card is what the CPU
    computes.  Set by the CLI, the Trainer and ``serve.reconstruct`` /
    ``serve.sample``; process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN takes deterministic algorithms only while the block runs, and
    its setting before is put back after.  Its default picks include
    backward-filter algorithms that sum with atomics, under which two runs
    of one train step from one state differ in the last bits (on an H100
    every per-step run of synthetic2 did), so neither a resumed run nor a
    replayed CUDA graph could continue a trajectory bit for bit.  Held by
    ``train.train_step`` (a captured step keeps the algorithms it was
    captured with); serving and other code keep cuDNN's default picks.
    The setting is process-wide while it is held."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def dtype_of(name: Optional[str]) -> torch.dtype:
    """torch dtype of a config dtype name ("float32", "bfloat16", ...)."""
    dt = getattr(torch, name or "float32", None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt
