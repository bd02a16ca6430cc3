"""Device selection for the port's entry points."""

from __future__ import annotations

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


def dtype_of(name: Optional[str]) -> torch.dtype:
    """torch dtype of a config dtype name ("float32", "bfloat16", ...)."""
    dt = getattr(torch, name or "float32", None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt
