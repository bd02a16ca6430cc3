from typing import Union

import torch

from ..config import Config
from ..device import DeviceLike, dtype_of, resolve_device
from .disentangled import DisentangledSNDVAE
from .joint import JointSNDVAE
from .outputs import DecodedGraph, Latents, LatentStats, ModelOutput

Model = Union[DisentangledSNDVAE, JointSNDVAE]


def build_model(cfg: Config, device: DeviceLike = None) -> Model:
    """The model of ``cfg`` with weights drawn from ``cfg.train.seed`` on a
    CPU generator — the same weights on every device — then moved to
    ``device`` (CUDA unless named) and cast to ``cfg.compute_dtype``, in
    eval mode.

    "base" is the joint model; every other model type (disentangled,
    disentangled_C, NED-VAE-IP, beta-TCVAE, geoGCN, posGCN) the disentangled
    one, as ``snd_vae_tpu/models/__init__.py:7-14`` dispatches."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.train.seed)
    model = JointSNDVAE(cfg, gen) if cfg.model_type == "base" else DisentangledSNDVAE(cfg, gen)
    return model.to(device=dev, dtype=dtype_of(cfg.compute_dtype)).eval()


__all__ = [
    "DisentangledSNDVAE",
    "JointSNDVAE",
    "Model",
    "build_model",
    "ModelOutput",
    "LatentStats",
    "Latents",
    "DecodedGraph",
]
