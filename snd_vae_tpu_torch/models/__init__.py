import torch

from ..config import Config
from ..device import DeviceLike, dtype_of, resolve_device
from .disentangled import DisentangledSNDVAE
from .outputs import DecodedGraph, Latents, LatentStats, ModelOutput


def build_model(cfg: Config, device: DeviceLike = None) -> DisentangledSNDVAE:
    """The model of ``cfg`` with weights drawn from ``cfg.train.seed`` on a
    CPU generator — the same weights on every device — then moved to
    ``device`` (CUDA unless named) and cast to ``cfg.compute_dtype``, in
    eval mode.

    The disentangled family (disentangled, disentangled_C, NED-VAE-IP,
    beta-TCVAE) shares one model; "base" (the joint model) comes in a later
    slice and raises."""
    dev = resolve_device(device)
    if cfg.model_type == "base":
        raise NotImplementedError("the joint (base) model is not ported yet")
    gen = torch.Generator().manual_seed(cfg.train.seed)
    model = DisentangledSNDVAE(cfg, gen)
    return model.to(device=dev, dtype=dtype_of(cfg.compute_dtype)).eval()


__all__ = [
    "DisentangledSNDVAE",
    "build_model",
    "ModelOutput",
    "LatentStats",
    "Latents",
    "DecodedGraph",
]
