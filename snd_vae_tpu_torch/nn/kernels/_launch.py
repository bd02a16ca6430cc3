"""What every kernel wrapper checks before a launch, and how it launches."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

# dtypes a kernel takes, by the code its C entry point expects
CUDA_DTYPES: Dict[torch.dtype, int] = {torch.float32: 0, torch.bfloat16: 1}
# the plain versions also take float64 on the CPU (the float64 parity tests)
CPU_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def check_inputs(kernel: str, **tensors: torch.Tensor) -> torch.device:
    """One device, one dtype the kernel takes on that device, contiguous
    memory.  Raises ValueError / TypeError on anything else; returns the
    device."""
    first = next(iter(tensors.values()))
    dev, dt = first.device, first.dtype
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{kernel}: {name} is {type(t).__name__}, not a tensor")
        if t.device != dev:
            raise ValueError(f"{kernel}: {name} on {t.device}, expected {dev}")
        if t.dtype != dt:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    if dev.type == "cuda":
        if dt not in CUDA_DTYPES:
            raise TypeError(f"{kernel}: CUDA kernel takes float32 or bfloat16, got {dt}")
    elif dev.type == "cpu":
        if dt not in CPU_DTYPES:
            raise TypeError(f"{kernel}: unsupported dtype {dt}")
    else:
        raise ValueError(f"{kernel}: no kernel for device type {dev.type!r}")
    return dev


def stream_handle(dev: torch.device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on ``dev``."""
    return torch.cuda.current_stream(dev).cuda_stream


def raise_on_error(kernel: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {code}")


# the kernels' election counters, one buffer per (kernel, device, stream):
# zero before a launch and left zero by it; a larger one replaces it when a
# plan needs more
_COUNTERS: Dict[Tuple[str, int, int], torch.Tensor] = {}


def election_counters(kernel: str, dev: torch.device, stream: int, size: int) -> torch.Tensor:
    """At least ``size`` int32 counters, all zero, for launches of
    ``kernel`` on ``stream`` (launches on one stream run one after
    another, and each leaves its counters zero)."""
    key = (kernel, dev.index, stream)
    if key not in _COUNTERS or _COUNTERS[key].numel() < size:
        _COUNTERS[key] = torch.zeros(size, dtype=torch.int32, device=dev)
    return _COUNTERS[key]
