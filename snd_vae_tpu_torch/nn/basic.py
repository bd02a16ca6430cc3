"""Basic NN ops: activation, dense, 1-D conv, normalization, dropout — the
port of ``snd_vae_tpu/nn/basic.py:32-183``.

Public layouts follow the JAX package: features on the last axis, 1-D convs
on NWC maps.  Parameters keep the flax names (``kernel``, ``bias``,
``gamma``, ``beta``); ``Conv1D.kernel`` is stored in torch's [out, in, k]
layout (``params.state_dict_from_flax`` transposes the flax [k, in, out]).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.batch import global_mean, local_rows, model_sum
from ..parallel.hints import model_group
from . import init as inits


def acc_dtype(dt: torch.dtype) -> torch.dtype:
    """The dtype products of ``dt`` operands accumulate in: f32 for bf16 and
    f16, else ``dt`` (the JAX package's ``preferred_element_type``)."""
    return torch.float32 if dt in (torch.bfloat16, torch.float16) else dt


def lrelu(x: torch.Tensor, leak: float = 0.2) -> torch.Tensor:
    """Leaky ReLU, max(x, leak*x) (reference layers.py:112-113)."""
    return torch.maximum(x, leak * x)


class Dense(nn.Module):
    """XW + b over the last axis; W ~ N(0, stddev²), b = bias_start."""

    def __init__(self, in_features: int, features: int, generator: torch.Generator,
                 stddev: float = 0.02, bias_start: float = 0.0):
        super().__init__()
        self.kernel = nn.Parameter(inits.normal((in_features, features), stddev, generator))
        self.bias = nn.Parameter(torch.full((features,), float(bias_start)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.kernel) + self.bias


def same_pad(length: int, kernel_size: int, stride: int) -> Tuple[int, int]:
    """TF/XLA SAME padding (left, right) of one spatial axis: the output
    has ceil(length/stride) positions and any odd pad goes to the right."""
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel_size - length, 0)
    return total // 2, total - total // 2


class Conv1D(nn.Module):
    """``tf.layers.conv1d`` with SAME padding on an NWC map [..., L, C]:
    glorot-uniform kernel, zero bias, linear output.  Explicit padding, so
    stride > 1 works (torch's padding="same" refuses it)."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 generator: torch.Generator, stride: int = 1):
        super().__init__()
        self.stride = stride
        w = inits.glorot_uniform((kernel_size, in_features, features), generator)
        self.kernel = nn.Parameter(w.permute(2, 1, 0).contiguous())   # [out, in, k]
        self.bias = nn.Parameter(inits.zeros((features,)))

    def out_length(self, length: int) -> int:
        return -(-length // self.stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead, (L, C) = x.shape[:-2], x.shape[-2:]
        xb = x.reshape(-1, L, C).transpose(1, 2)                       # NCW
        xb = F.pad(xb, same_pad(L, self.kernel.shape[-1], self.stride))
        y = F.conv1d(xb, self.kernel, self.bias, stride=self.stride)
        y = y.transpose(1, 2)                                          # NWC
        return y.reshape(lead + y.shape[1:])


def _block_params(gamma, beta, x, block):
    if block is None:
        return gamma, beta
    lo, hi = block
    if hi - lo != x.shape[-1]:
        raise ValueError(
            f"block {block} width {hi - lo} != input channels {x.shape[-1]} "
            f"(shape {tuple(x.shape)})"
        )
    return gamma[lo:hi], beta[lo:hi]


class FrozenBatchNorm(nn.Module):
    """Keras BN with its moving statistics frozen at init (parity mode):
    y = gamma * x / sqrt(1 + eps) + beta over the last axis.  ``block=(lo,
    hi)`` applies channels [lo, hi) of the full width to an input holding
    only those channels.  ``nodes`` (see ``BatchStatNorm``) changes
    nothing: the map is per element."""

    def __init__(self, features: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.gamma = nn.Parameter(inits.ones((features,)))
        self.beta = nn.Parameter(inits.zeros((features,)))

    def forward(self, x: torch.Tensor, block: Optional[Tuple[int, int]] = None,
                nodes: Optional[int] = None) -> torch.Tensor:
        gamma, beta = _block_params(self.gamma, self.beta, x, block)
        return x * (gamma * (1.0 / math.sqrt(1.0 + self.epsilon))) + beta


class BatchStatNorm(nn.Module):
    """Corrected batch norm: normalize with the current batch's statistics
    over all axes but the last (the global batch's under a data-parallel
    mesh); trainable gamma/beta.  ``nodes``: ``x``'s axis 1 holds this
    rank's rows of a node axis of that many under the mesh's model axis
    (the adjacency head's maps, a motif conv's output), so the moments sum
    over the model ranks too before the data axis's mean."""

    def __init__(self, features: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.gamma = nn.Parameter(inits.ones((features,)))
        self.beta = nn.Parameter(inits.zeros((features,)))

    def forward(self, x: torch.Tensor, block: Optional[Tuple[int, int]] = None,
                nodes: Optional[int] = None) -> torch.Tensor:
        gamma, beta = _block_params(self.gamma, self.beta, x, block)
        axes = tuple(range(x.dim() - 1))
        if nodes is None or model_group() is None:
            mean = global_mean(x.mean(dim=axes, keepdim=True))
            var = global_mean((x - mean).square().mean(dim=axes, keepdim=True))
        else:
            count = x.shape[0] * nodes * math.prod(x.shape[2:-1])
            mean = global_mean(model_sum(x.sum(dim=axes, keepdim=True)) / count)
            var = global_mean(model_sum((x - mean).square().sum(dim=axes, keepdim=True)) / count)
        return (x - mean) * torch.rsqrt(var + self.epsilon) * gamma + beta


def make_norm(features: int, parity: bool = True, epsilon: float = 1e-3) -> nn.Module:
    if parity:
        return FrozenBatchNorm(features, epsilon)
    return BatchStatNorm(features, epsilon)


def dropout(x: torch.Tensor, keep_prob: float, generator: Optional[torch.Generator] = None,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout with a keep-probability (``snd_vae_tpu/nn/basic.py:
    174-183``, tf.nn.dropout's semantics): x / keep_prob where the mask
    keeps, 0 elsewhere.  The boolean mask is ``mask`` when given, else
    uniform < keep_prob drawn from ``generator`` (under a data-parallel mesh
    the global batch's draw, this rank's rows); identity at keep_prob >= 1."""
    if keep_prob >= 1.0:
        return x
    if mask is None:
        if generator is None:
            raise ValueError("dropout needs a torch.Generator or a mask")
        u = local_rows(lambda s: torch.rand(s, generator=generator, device=generator.device),
                       x.shape)
        mask = u < keep_prob
    mask = mask.to(x.device)
    return torch.where(mask, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))
