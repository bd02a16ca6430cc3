"""Serving: posterior-mean reconstruction and decoding from the prior.

  * ``reconstruct(model, batch)`` — the counterpart of the JAX
    ``make_eval_step`` (``snd_vae_tpu/train.py:292-300``): encode, take the
    posterior means, decode.
  * ``sample(model, num, generator)`` — the counterpart of
    ``DisentangledSNDVAE.generate`` (``models/disentangled.py:367-372``).

Both run without autograd, on the model's device and in its dtype; the
batch is moved and cast to match.
"""

from __future__ import annotations

from typing import Optional

import torch

from .data.graphbatch import GraphBatch
from .models import DecodedGraph, DisentangledSNDVAE, ModelOutput


def reconstruct(model: DisentangledSNDVAE, batch: GraphBatch) -> ModelOutput:
    with torch.inference_mode():
        return model(batch.to(model.device, model.dtype), deterministic_z=True)


def sample(model: DisentangledSNDVAE, num: int, generator: torch.Generator,
           num_samples: Optional[int] = None) -> DecodedGraph:
    with torch.inference_mode():
        return model.generate(generator, num, num_samples)
