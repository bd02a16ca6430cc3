"""snd_vae_tpu_torch — the PyTorch/CUDA port of snd_vae_tpu.

The JAX package ``snd_vae_tpu`` is the reference; this package mirrors its
module names and public layouts and imports nothing of it.  Entry points run
on the CUDA card unless the caller passes ``device="cpu"``; the hand-written
kernels (``nn/kernels``) launch on CUDA tensors and hand CPU tensors to their
plain PyTorch versions.
"""

from .config import Config, preset
from .device import resolve_device

__all__ = ["Config", "preset", "resolve_device"]
