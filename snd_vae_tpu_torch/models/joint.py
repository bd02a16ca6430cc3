"""The joint ("base") SND-VAE — one latent z_sg.  The port of
``snd_vae_tpu/models/joint.py:35-255`` (reference model_joint.py:11-206,
which despite its name is the baseline model).

Encoder: SpatialGraphConv (kernel K1 at level 3, its backward K2 through
``_MotifLevel3``; on protein and mnist the fourth-order SpatialGraphConv3D,
as JAX ``models/joint.py:57-61``) + BN + lrelu + dropout over each graph's
own adjacency and rel, no spanning trees; the latent keeps a one-sample
axis, [B,1,L].
Decoder from the per-node state d_sg_lin1(z): the coordinate head (conv1d +
BN + lrelu + dropout; linear output for synthetic3 and scene), the
node-feature head (the same; scene's is a categorical softmax-argmax over
shapes) and the adjacency head (tile-concat + E2E stack, separable first
layer from ``cfg.adj_factored_engaged`` on; scene returns K-way edge
logits with no diagonal mask).

Dropout runs with ``dropout_keep`` < 1 at the JAX sites: encoder layer i,
coordinate layer i and node layer 100 + i (``joint.py:107-189``), as the
keys ``("encode", i)`` and ``("decode", i)`` of ``dropout_masks``; a mask
not given there is drawn from the generator, in the order encoder sites,
ε, coordinate sites, node sites.  No site lies inside a region that
``cfg.remat`` checkpoints (the motif convs, the adjacency head), so the
backward's recompute draws nothing.

Submodule names follow the flax tree (``sg_convs.0.Matrix1``,
``d_sg_lin1``, ``s_deconvs.0``, ``d_bn_e.0``, ``d_e_lin2``), so
``params.state_dict_from_flax`` carries JAX weights across.

Ranges and stamps as in the disentangled model: ``model.encode``,
``model.encode.sg_conv.<i>``, ``model.decode`` and
``model.decode.adj_head`` under a profiler, and the motif-conv stack's and
the adjacency head's stamps in a stamped train step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .. import spans
from ..config import Config
from ..data.graphbatch import GraphBatch
from ..nn import E2E, Conv1D, Dense, dropout, lrelu, make_norm
from ..nn.ckpt import policy_from_config, rematerialized
from ..parallel.batch import gather_nodes, local_rows
from ..parallel.hints import own_block, shard_nodes
from .disentangled import adj_head_params, motif_conv
from .outputs import (
    DecodedGraph, Latents, LatentStats, ModelOutput, adjacency_e2e, apply_coord_activation,
    diag_masked,
)

MaskKey = Tuple[str, int]


class JointSNDVAE(nn.Module):
    # the adjacency head's modules, rematerialized together
    ADJ_HEAD = ("d_bn_e", "e_deconvs", "d_e_lin2")

    def __init__(self, cfg: Config, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.remat_context = policy_from_config(cfg.remat, cfg.remat_policy)
        enc, dec = cfg.encoder, cfg.decoder
        N, g = cfg.num_nodes, generator
        norm = lambda c: make_norm(c, cfg.parity)

        convs, bns, c = [], [], cfg.num_features
        for hidden in enc.sg_conv_hidden:
            convs.append(motif_conv(cfg, c, hidden, g))
            c = hidden[-1]
            bns.append(norm(c))
        self.sg_convs, self.sg_bns = nn.ModuleList(convs), nn.ModuleList(bns)
        self.sg_lin1 = Dense(N * c, enc.sg_hidden_size, g)
        self.sg_lin_mean = Dense(enc.sg_hidden_size, enc.sg_latent_size, g)
        self.sg_lin_std = Dense(enc.sg_hidden_size, enc.sg_latent_size, g)

        nh = dec.node_h_size
        self.d_sg_lin1 = Dense(enc.sg_latent_size, N * nh, g)

        convs, bns, c = [], [], nh
        for ch, k, s in zip(dec.s_d_channels, dec.s_d_kernel_sizes, dec.s_d_strides):
            convs.append(Conv1D(c, ch, k, g, s))
            bns.append(norm(ch))
            c = ch
        self.s_deconvs, self.d_bn_s = nn.ModuleList(convs), nn.ModuleList(bns)
        self.d_s_lin2 = Dense(c, cfg.spatial_dim, g)

        convs, bns, c = [], [], nh
        for ch, k, s in zip(dec.n_d_channels, dec.n_d_kernel_sizes, dec.n_d_strides):
            convs.append(Conv1D(c, ch, k, g, s))
            bns.append(norm(ch))
            c = ch
        self.n_deconvs, self.d_bn_n = nn.ModuleList(convs), nn.ModuleList(bns)
        self.d_n_lin2 = Dense(c, cfg.num_features, g)

        # the first BN normalizes the pairwise tile-concat map
        c = 2 * nh + (1 if dec.edge_from_coords else 0)
        convs, bns = [], []
        for h in dec.e_d_hidden:
            bns.append(norm(c))
            convs.append(E2E(c, h, N, g))
            c = h
        self.e_deconvs, self.d_bn_e = nn.ModuleList(convs), nn.ModuleList(bns)
        self.d_e_lin2 = Dense(c, dec.num_edge_feature, g)

    @property
    def device(self) -> torch.device:
        return self.d_s_lin2.kernel.device

    @property
    def dtype(self) -> torch.dtype:
        return self.d_s_lin2.kernel.dtype

    # ------------------------------------------------------------------ #
    def forward(self, batch: GraphBatch, deterministic_z: bool = False,
                generator: Optional[torch.Generator] = None,
                eps: Optional[Latents] = None, dropout_keep: float = 1.0,
                dropout_masks: Optional[Dict[MaskKey, torch.Tensor]] = None) -> ModelOutput:
        """Encode, pick z_sg (the posterior mean with ``deterministic_z``,
        else μ + ε·σ with ε given or drawn from ``generator``), decode;
        dropout at ``dropout_keep`` < 1 (see the module docstring)."""
        drop = self._dropper(dropout_keep, generator, dropout_masks)
        stats = self.encode(batch, drop)
        if deterministic_z:
            latents = Latents(z_sg=stats.mean_sg)
        else:
            latents = self.reparameterize(stats, eps=eps, generator=generator)
        return ModelOutput(stats=stats, latents=latents, decoded=self.decode(latents, drop))

    @staticmethod
    def _dropper(keep: float, generator, masks):
        if keep >= 1.0:
            return None
        masks = masks or {}
        return lambda t, key: dropout(t, keep, generator, masks.get(key))

    @spans.ranged("model.encode")
    def encode(self, batch: GraphBatch, drop=None) -> LatentStats:
        """One joint branch over the truth graph (model_joint.py:72-85)."""
        B, N = batch.batch_size, batch.num_nodes
        sg = batch.features
        # the stack's backward ends with its first conv's parameter gradients
        spans.stamp("sg_conv.forward.start")
        spans.after_grads("sg_conv.backward.end", self.sg_convs[0])
        for i, (conv, bn) in enumerate(zip(self.sg_convs, self.sg_bns)):
            # this rank's node rows under a model axis, gathered for what follows
            with spans.labelled(f"model.encode.sg_conv.{i}"):
                sg = rematerialized(self, conv, conv, batch.adj, sg, batch.rel)
            sg = gather_nodes(lrelu(bn(sg, nodes=N)), N)
            if drop is not None:
                sg = drop(sg, ("encode", i))
        sg = spans.marked("sg_conv.forward.end", "sg_conv.backward.start", sg)
        sg_ = self.sg_lin1(sg.reshape(B, -1))
        return LatentStats(mean_sg=self.sg_lin_mean(sg_)[:, None],
                           logstd_sg=self.sg_lin_std(sg_)[:, None])

    def _normal(self, shape, generator: Optional[torch.Generator]) -> torch.Tensor:
        if generator is None:
            raise ValueError("drawing latents needs a torch.Generator")
        # under a data-parallel mesh: the global batch's draw, this rank's rows
        z = local_rows(lambda s: torch.randn(s, generator=generator, device=generator.device,
                                             dtype=self.dtype), shape)
        return z.to(self.device)

    def reparameterize(self, stats: LatentStats, eps: Optional[Latents] = None,
                       generator: Optional[torch.Generator] = None) -> Latents:
        """z_sg = μ + ε·exp(logσ), ε from ``eps.z_sg`` or drawn from ``generator``."""
        e = eps.z_sg if eps is not None else self._normal(stats.mean_sg.shape, generator)
        e = e.to(stats.mean_sg.device, stats.mean_sg.dtype).reshape(stats.mean_sg.shape)
        return Latents(z_sg=stats.mean_sg + e * torch.exp(stats.logstd_sg))

    @spans.ranged("model.decode")
    def decode(self, latents: Latents, drop=None) -> DecodedGraph:
        cfg = self.cfg
        N, nh = cfg.num_nodes, cfg.decoder.node_h_size
        B = latents.z_sg.shape[0]
        drop = drop or (lambda t, key: t)
        joint_h = self.d_sg_lin1(latents.z_sg.reshape(B, -1)).reshape(B, N, nh)

        # coordinate head (model_joint.py:112-123)
        sp = joint_h
        for i, (conv, bn) in enumerate(zip(self.s_deconvs, self.d_bn_s)):
            sp = drop(lrelu(bn(conv(sp))), ("decode", i))
        coords = apply_coord_activation(
            cfg, self.d_s_lin2(sp.reshape(B * N, -1)),
            reference_linear=cfg.dataset in ("synthetic3", "scene"),
        ).reshape(B, N, -1)

        # node-feature head (model_joint.py:129-145)
        x = joint_h
        for i, (conv, bn) in enumerate(zip(self.n_deconvs, self.d_bn_n)):
            x = drop(lrelu(bn(conv(x))), ("decode", 100 + i))
        node_logits = self.d_n_lin2(x.reshape(B * N, -1))
        node_feat_prob = None
        if cfg.dataset == "scene":
            node_feat_prob = node_logits.reshape(B, N, -1)
            node_feat = torch.softmax(node_feat_prob, dim=-1).argmax(dim=-1) \
                .to(node_logits.dtype)[..., None]
        else:
            node_feat = torch.sigmoid(node_logits).reshape(B, N, -1)

        h_in = spans.marked("adj_head.forward.start", "adj_head.backward.end", joint_h)
        with spans.labelled("model.decode.adj_head"):
            adj_prob = rematerialized(self, self, self._adj_head, h_in, coords,
                                      params=adj_head_params(self))
        adj_prob = spans.marked("adj_head.forward.end", "adj_head.backward.start", adj_prob)
        adj = torch.softmax(adj_prob, dim=-1).argmax(dim=-1)
        return DecodedGraph(adj=adj, adj_prob=adj_prob, coords=coords, node_feat=node_feat,
                            node_feat_prob=node_feat_prob)

    def _adj_head(self, joint_h: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """Tile-concat + E2E stack; scene: K-way edge logits as they are,
        else the 2-class diag mask (model_joint.py:164-179)."""
        N = joint_h.shape[1]
        t = adjacency_e2e(self.cfg, self.e_deconvs, self.d_bn_e, joint_h, coords)
        logits = shard_nodes(self.d_e_lin2(torch.relu(t)), tag="dec.logits", nodes=N)
        return logits if self.cfg.dataset == "scene" else diag_masked(logits, own_block(N)[0])

    def prior_latents(self, batch_size: int, generator: Optional[torch.Generator]) -> Latents:
        """z_sg ~ N(0, I) [B, 1, L] in the model's dtype."""
        return Latents(z_sg=self._normal(
            (batch_size, 1, self.cfg.encoder.sg_latent_size), generator))

    def generate(self, generator: torch.Generator, num: int) -> DecodedGraph:
        """Decode from the prior (model_joint.py's test_generation)."""
        return self.decode(self.prior_latents(num, generator))
