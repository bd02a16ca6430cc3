"""Typed containers for model outputs — the port of
``snd_vae_tpu/models/outputs.py:14-81`` — and the decoders' shared parts:
the coordinate activation, the distance edge channel and the adjacency
head's E2E stack.

Under the mesh's ``model`` axis the adjacency head runs on this rank's rows
i of its [B,N,N,·] maps (``parallel.hints.own_block``): the pair map's rows
are built locally from the whole per-node states, the E2E stack takes and
returns rows, and the edge logits and hard edges the decoder returns are
rows too (``whole_decoded`` gathers them)."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from ..nn.ckpt import big
from ..parallel.batch import gather_nodes
from ..parallel.hints import model_group, shard_nodes


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


def whole_decoded(decoded: DecodedGraph) -> DecodedGraph:
    """``decoded`` with its adjacency (``adj``, ``adj_prob``) gathered from
    every model rank's rows; as it is without a model axis above 1."""
    if model_group() is None:
        return decoded
    n = decoded.coords.shape[1]
    return replace(decoded, adj=gather_nodes(decoded.adj, n),
                   adj_prob=gather_nodes(decoded.adj_prob, n))


def edge_distance_channel(cfg, coords: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Decoded-coordinate pairwise distances as a [B,N,N,1] edge channel
    (DecoderConfig.edge_from_coords), this rank's rows i of it under a
    model axis; ``efc_stop_grad`` detaches the coordinates first."""
    if cfg.decoder.efc_stop_grad:
        coords = coords.detach()
    rows = shard_nodes(coords, tag="dec.dist", nodes=coords.shape[1])
    diff = rows[:, :, None, :] - coords[:, None, :, :]
    dist = torch.sqrt((diff * diff).sum(-1, keepdim=True) + 1e-8)
    return dist.to(dtype)


def adjacency_e2e(cfg, convs, bns, h: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The adjacency head's E2E stack over the pairwise tile-concat map
    [h_i, h_j (, distance)] of per-node states ``h`` [B,N,C]: BN, relu, E2E
    per layer (``snd_vae_tpu/models/disentangled.py:316-355`` and
    ``models/joint.py:211-241``).  With ``cfg.adj_factored_engaged`` the
    first layer runs separable: the map stays channel-separable through the
    per-channel BN and relu, so it is never built (``E2E._separable``).
    The map and each later layer's output run in ``nn.ckpt.big`` regions
    (``dec.pair``, ``dec.e2e``), as JAX tags them.  Under a model axis the
    map and the result hold this rank's rows i ([B,n,N,·]): the pair map's
    rows need no communication (JAX ``disentangled.py:338-349``)."""
    B, N, C = h.shape
    if cfg.adj_factored_engaged and len(convs):
        bn0 = bns[0]
        p = torch.relu(bn0(h, block=(0, C)))
        q = torch.relu(bn0(h, block=(C, 2 * C)))
        d = None
        if cfg.decoder.edge_from_coords:
            dch = edge_distance_channel(cfg, coords, h.dtype)
            d = torch.relu(bn0(dch, block=(2 * C, 2 * C + dch.shape[-1]), nodes=N))
        t = convs[0](factors=(p, q, d))
        layers = zip(convs[1:], bns[1:])
    else:
        rows = shard_nodes(h, tag="dec.h_i", nodes=N)
        n = rows.shape[1]
        parts = [rows[:, :, None, :].expand(B, n, N, C), h[:, None, :, :].expand(B, n, N, C)]
        if cfg.decoder.edge_from_coords:
            parts.append(edge_distance_channel(cfg, coords, h.dtype))
        with big("dec.pair"):
            t = shard_nodes(torch.cat(parts, dim=-1), tag="dec.pair", nodes=N)
        layers = zip(convs, bns)
    for e2e, bn in layers:
        t = torch.relu(bn(t, nodes=N))
        with big("dec.e2e"):
            t = e2e(t)
    return t


def diag_masked(logits: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """2-class edge logits with the diagonal forced to class 0: logit 1 for
    class 0 and 0 for class 1 on i = j.  ``logits`` [B,n,N,2] holds rows
    [row0, row0 + n) of the map (all of it by default)."""
    n, N = logits.shape[1:3]
    eye = torch.arange(row0, row0 + n, device=logits.device)[:, None] == torch.arange(
        N, device=logits.device)
    off_diag = 1.0 - eye.to(logits.dtype)
    prob1 = off_diag * logits[..., 1]
    prob0 = off_diag * logits[..., 0] + (1.0 - off_diag)
    return torch.stack([prob0, prob1], dim=-1)
