"""Latent-to-graph decode ops — the port of ``snd_vae_tpu/nn/decoders.py:19-43``.

  * ``inner_product_decoder`` — batched Z·Zᵀ edge logits (reference
    layers.py:400-410, whose ``act`` is never applied: apply a sigmoid at
    the call site).
  * ``Graphite`` — relu(R1 (R1ᵀ (XW)) + R2 (R2ᵀ (XW))) (layers.py:591-604).

No model calls them; both are plain PyTorch products, accumulated in at
least f32.
"""

from __future__ import annotations

import torch
from torch import nn

from . import init as inits
from .basic import acc_dtype
from .kernels.adj_matmul import project


def inner_product_decoder(z: torch.Tensor) -> torch.Tensor:
    """[..., N, D] latents -> [..., N, N] edge logits Z Zᵀ."""
    za = z.to(acc_dtype(z.dtype))
    return (za @ za.transpose(-1, -2)).to(z.dtype)


class Graphite(nn.Module):
    """Graphite propagation; ``Matrix`` [F, features] ~ N(0, 0.02²)."""

    def __init__(self, in_features: int, features: int, generator: torch.Generator,
                 stddev: float = 0.02):
        super().__init__()
        self.Matrix = nn.Parameter(inits.normal((in_features, features), stddev, generator))

    def forward(self, x: torch.Tensor, recon_1: torch.Tensor,
                recon_2: torch.Tensor) -> torch.Tensor:
        acc = acc_dtype(x.dtype)
        mm = lambda a, b: (a.to(acc) @ b.to(acc)).to(x.dtype)
        xw = project(x, self.Matrix)
        y = (mm(recon_1, mm(recon_1.transpose(-1, -2), xw))
             + mm(recon_2, mm(recon_2.transpose(-1, -2), xw)))
        return torch.relu(y)
