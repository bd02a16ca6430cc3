"""``E2E`` edge-to-edge conv — the port of ``snd_vae_tpu/nn/edge_conv.py:70-187``
(reference layers.py:431-450): a 1xk_h SAME conv plus the same weights
transposed to k_hx1, one shared bias added to each, summed.

Two lowerings, numerically the same function, chosen by the JAX auto rule
(``edge_conv.py:139-156``): the conv lowering (``F.conv2d``) below
``matmul_threshold`` width, and the Toeplitz lowering (one contraction
against the banded expansion of the kernel, ``_toeplitz_weights``) from it
on, unless that expansion would exceed ``matmul_max_bytes``.  Maps are NHWC
[B,H,W,C] at the public boundary, NCHW only around ``F.conv2d``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import init as inits
from .basic import same_pad


def _toeplitz_weights(w: torch.Tensor, width: int) -> torch.Tensor:
    """``w`` [k_h, C, O] -> ``Mt`` [width, width, C, O] with
    ``Mt[t, j] = w[t - j + pad_left]`` (zero outside the kernel), so a SAME
    stride-1 window conv over a width-``width`` map is
    ``out[b,i,j,o] = Σ_{t,c} x[b,i,t,c]·Mt[t,j,c,o]``."""
    k_h = w.shape[0]
    pl = (k_h - 1) // 2
    ar = torch.arange(width, device=w.device)
    idx = pl + ar[:, None] - ar[None, :]                       # [t, j]
    valid = (idx >= 0) & (idx < k_h)
    g = w[idx.clamp(0, k_h - 1)]                               # [W, W, C, O]
    return torch.where(valid[..., None, None], g, torch.zeros((), dtype=w.dtype,
                                                                 device=w.device))


class E2E(nn.Module):
    """Edge-to-edge conv on an NHWC map [B,N,N,C] -> [B,N,N,O].

    ``w1`` is stored as the row conv's torch kernel [O, C, 1, k_h]; the
    column conv uses its transpose [O, C, k_h, 1].  ``use_matmul`` None =
    the auto rule."""

    def __init__(self, in_features: int, features: int, k_h: int,
                 generator: torch.Generator, stddev: float = 0.02,
                 use_matmul: Optional[bool] = None, matmul_threshold: int = 96,
                 matmul_max_bytes: int = 2 << 30):
        super().__init__()
        self.k_h = k_h
        self.use_matmul = use_matmul
        self.matmul_threshold = matmul_threshold
        self.matmul_max_bytes = matmul_max_bytes
        w = inits.truncated_normal((1, k_h, in_features, features), stddev, generator)
        self.w1 = nn.Parameter(w.permute(3, 2, 0, 1).contiguous())   # [O, C, 1, k_h]
        self.biases1 = nn.Parameter(inits.zeros((features,)))

    def uses_matmul(self, x: torch.Tensor) -> bool:
        if self.use_matmul is not None:
            return self.use_matmul
        mt_bytes = x.shape[2] ** 2 * x.shape[-1] * self.w1.shape[0] * x.element_size()
        return x.shape[2] >= self.matmul_threshold and mt_bytes <= self.matmul_max_bytes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.uses_matmul(x):
            if x.shape[1] != x.shape[2]:
                raise ValueError(
                    f"E2E matmul lowering requires square maps, got H={x.shape[1]} "
                    f"W={x.shape[2]}; pass use_matmul=False"
                )
            w = self.w1[:, :, 0, :].permute(2, 1, 0)                  # [k_h, C, O]
            mt = _toeplitz_weights(w, x.shape[2])                     # [t, j, C, O]
            conv1 = torch.einsum("bitc,tjco->bijo", x, mt) + self.biases1
            conv2 = torch.einsum("btjc,tico->bijo", x, mt) + self.biases1
            return conv1 + conv2
        xc = x.permute(0, 3, 1, 2)                                    # NCHW
        H, W = xc.shape[2:]
        row = F.conv2d(F.pad(xc, same_pad(W, self.k_h, 1)), self.w1, self.biases1)
        col = F.conv2d(F.pad(xc, (0, 0) + same_pad(H, self.k_h, 1)),
                       self.w1.transpose(2, 3), self.biases1)
        return (row + col).permute(0, 2, 3, 1)
