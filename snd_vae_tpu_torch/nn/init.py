"""Weight initializers on an explicit ``torch.Generator``, matching the
distributions of the JAX package's ``nn/init.py`` (the reference's TF1
initializers).  The bits differ from ``jax.random``'s; the distributions
do not.

  * ``normal(std)``           — N(0, std²): ``linear`` and the SGConv matrices
  * ``truncated_normal(std)`` — std · N(0,1) truncated at ±2 (not rescaled),
                                as TF's and jax's truncated normal
  * ``glorot_uniform``        — U(±sqrt(6/(fan_in+fan_out))), fans taken as
                                flax does for a [..., in, out] kernel
  * ``zeros`` / ``ones``

Each takes the shape in the JAX layout and returns a float32 CPU tensor.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def normal(shape: Sequence[int], std: float, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator) * std


def truncated_normal(shape: Sequence[int], std: float,
                     generator: torch.Generator) -> torch.Tensor:
    """Inverse-CDF draw from N(0,1) restricted to [-2, 2], times ``std``."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    return (z.clamp(-2.0, 2.0) * std).to(torch.float32)


def glorot_uniform(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """Fans as flax computes them: in = shape[-2], out = shape[-1], both
    times the receptive field (the product of the leading axes)."""
    shape = tuple(shape)
    receptive = math.prod(shape[:-2])
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit


def zeros(shape: Sequence[int]) -> torch.Tensor:
    return torch.zeros(tuple(shape))


def ones(shape: Sequence[int]) -> torch.Tensor:
    return torch.ones(tuple(shape))
