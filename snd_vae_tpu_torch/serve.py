"""Serving: posterior-mean reconstruction and decoding from the prior.

  * ``reconstruct(model, batch)`` — the counterpart of the JAX
    ``make_eval_step`` (``snd_vae_tpu/train.py:292-300``): encode, take the
    posterior means, decode.
  * ``sample(model, num, generator)`` — the counterpart of the models'
    ``generate`` (``models/disentangled.py:367-372``, ``models/joint.py:
    253-255``); ``num_samples`` (prior draws of z_sg averaged per graph)
    applies to the disentangled family only.

Both take either model family and run without autograd, on the model's
device and in its dtype; the batch is moved and cast to match.  Both are
entry points, so both turn TF32 off first (``device.full_f32``): an f32
model computes in full f32 on the card, as on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from .data.graphbatch import GraphBatch
from .device import full_f32
from .models import DecodedGraph, JointSNDVAE, Model, ModelOutput


def reconstruct(model: Model, batch: GraphBatch) -> ModelOutput:
    full_f32()
    with torch.inference_mode():
        return model(batch.to(model.device, model.dtype), deterministic_z=True)


def sample(model: Model, num: int, generator: torch.Generator,
           num_samples: Optional[int] = None) -> DecodedGraph:
    full_f32()
    with torch.inference_mode():
        if isinstance(model, JointSNDVAE):
            if num_samples not in (None, 1):
                raise ValueError("the joint model draws one z_sg per graph")
            return model.generate(generator, num)
        return model.generate(generator, num, num_samples)
