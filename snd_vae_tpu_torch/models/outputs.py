"""Typed containers for model outputs — the port of
``snd_vae_tpu/models/outputs.py:14-81``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class LatentStats:
    """Per-branch posterior parameters; ``logstd`` fields hold logσ, used as
    exp(logσ) (the reference's convention)."""

    mean_sg: torch.Tensor                     # [B, S, L_sg]
    logstd_sg: torch.Tensor
    mean_s: Optional[torch.Tensor] = None     # [B, L_s]
    logstd_s: Optional[torch.Tensor] = None
    mean_g: Optional[torch.Tensor] = None     # [B, L_g]
    logstd_g: Optional[torch.Tensor] = None


@dataclass
class Latents:
    z_sg: torch.Tensor                        # [B, S, L_sg]
    z_s: Optional[torch.Tensor] = None        # [B, L_s]
    z_g: Optional[torch.Tensor] = None        # [B, L_g]


@dataclass
class DecodedGraph:
    """The decoder's three heads."""

    adj: torch.Tensor          # [B, N, N] hard 0/1 edges (argmax), int64
    adj_prob: torch.Tensor     # [B, N, N, C] edge-class logits (diag-masked)
    coords: torch.Tensor       # [B, N, D]
    node_feat: torch.Tensor    # [B, N, F]
    node_feat_prob: Optional[torch.Tensor] = None  # scene: categorical logits


@dataclass
class ModelOutput:
    stats: Optional[LatentStats]
    latents: Latents
    decoded: DecodedGraph


def apply_coord_activation(cfg, raw: torch.Tensor, reference_linear: bool) -> torch.Tensor:
    """Coordinate-head output activation (DecoderConfig.coord_activation):
    "auto" keeps what the reference does at the call site
    (``reference_linear``), "linear"/"sigmoid" force one."""
    mode = cfg.decoder.coord_activation
    linear = reference_linear if mode == "auto" else (mode == "linear")
    return raw if linear else torch.sigmoid(raw)


def edge_distance_channel(cfg, coords: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Decoded-coordinate pairwise distances as a [B,N,N,1] edge channel
    (DecoderConfig.edge_from_coords); ``efc_stop_grad`` detaches the
    coordinates first."""
    if cfg.decoder.efc_stop_grad:
        coords = coords.detach()
    diff = coords[:, :, None, :] - coords[:, None, :, :]
    dist = torch.sqrt((diff * diff).sum(-1, keepdim=True) + 1e-8)
    return dist.to(dtype)
