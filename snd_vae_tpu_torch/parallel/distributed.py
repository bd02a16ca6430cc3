"""Process-group initialization — the counterpart of
``snd_vae_tpu/parallel/distributed.py:25-67``.

JAX joins its processes with ``jax.distributed.initialize`` and then runs one
program over every process's devices.  The port runs one process per card
(``torchrun --nproc_per_node k``), each holding its own block of the data, and
joins them into one ``torch.distributed`` process group.  The backend follows
the device: NCCL on CUDA, gloo on the CPU.  A CUDA request without a card or
without NCCL raises; nothing falls back to gloo on the CPU.

The group needs no setting for the train step's CUDA-graph capture
(``train.StepGraph``): NCCL 2.9.6 and later capture collectives, and the
NCCL process group hands its watchdog only the collectives it runs
outside a capture, so its asynchronous error handling stays as torch sets
it (the port captures and replays its step so with torch 2.11.0+cu128 and
NCCL 2.28.9).  A collective replayed from a graph is not watched:
``train.wait_for_replays`` holds a chunk of replays under a mesh to NCCL's
default timeout instead, aborts the groups and raises.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device


def backend_for(device: DeviceLike = None) -> str:
    """The collective backend of ``device`` (CUDA unless named): "nccl" on
    CUDA, "gloo" on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch has no NCCL; pass device='cpu' to run on gloo")
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device type {dev.type!r}")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: DeviceLike = None) -> int:
    """Join this process to the default process group (idempotent: with a
    group already there, return its rank); returns this process's rank.

    The arguments default to what ``torchrun`` sets: ``MASTER_ADDR`` /
    ``MASTER_PORT`` (the ``env://`` rendezvous), ``WORLD_SIZE`` and
    ``RANK``.  A ``coordinator_address`` "host:port" rendezvous over TCP
    there; one with a scheme ("file:///path", "tcp://...") is taken as the
    init method as it stands.  On CUDA the current device becomes
    ``cuda:LOCAL_RANK`` (0 when unset), one card per process."""
    if dist.is_initialized():
        return dist.get_rank()
    backend = backend_for(device)
    world = int(os.environ.get("WORLD_SIZE", 1)) if num_processes is None else num_processes
    rank = int(os.environ.get("RANK", 0)) if process_id is None else process_id
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return rank


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs: rank 0, or
    the only process when there is no group."""
    return not dist.is_initialized() or dist.get_rank() == 0
