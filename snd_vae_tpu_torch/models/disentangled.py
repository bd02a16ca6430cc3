"""The disentangled SND-VAE — three latent branches (spatial z_s, topology
z_g, joint z_sg) and a three-headed decoder.  The port of
``snd_vae_tpu/models/disentangled.py:46-372`` (reference model.py:19-229).

Encoder: the g-branch stacks GraphConv (kernel K3) + frozen BN + a skip
concat of the raw features; the s-branch stacks SAME conv1d + BN + relu
over the coordinates; the sg-branch stacks SpatialGraphConv (kernel K1 at
level 3) + BN + lrelu over the B·S spanning trees, or for the geoGCN /
posGCN baselines GeoGraphConv / StructGraphConv + BN + lrelu over the truth
graph with S = 1.  Decoder: per-branch projections to per-node states, sg
states averaged over the tree axis, then the node-feature head (conv1d),
the coordinate head (conv1d) and the adjacency head (pairwise tile-concat
+ E2E stack + diag mask; from ``cfg.adj_factored_engaged`` on, its first
layer runs separable, ``E2E._separable``).  On the 3-D datasets (protein,
mnist: ``cfg.uses_3d_conv``) the sg-branch stacks the fourth-order
SpatialGraphConv3D instead, as JAX ``models/disentangled.py:97-100`` does.

Submodule and parameter names follow the flax tree (``g_convs.0.kernel``
for ``g_convs_0/kernel``), so ``params.state_dict_from_flax`` carries JAX
weights across.  With ``cfg.remat`` each motif conv and the adjacency head
run under ``torch.utils.checkpoint`` (``rematerialized``; the policy of
``cfg.remat_policy`` from ``nn/ckpt.py``), so the backward recomputes them.

Under a profiler ``encode`` and ``decode`` run inside the ranges
``model.encode`` and ``model.decode``, each motif conv inside
``model.encode.sg_conv.<i>`` and the adjacency head inside
``model.decode.adj_head`` (``spans.labelled``).  In a stamped train step
(``spans.stamping``) the motif-conv stack and the adjacency head stamp the
start and end of their forward and of their backward (``spans.STAMPS``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .. import spans
from ..config import Config
from ..data.graphbatch import GraphBatch
from ..nn import (
    E2E, Conv1D, Dense, GeoGraphConv, GraphConv, SpatialGraphConv, SpatialGraphConv3D,
    StructGraphConv, lrelu, make_norm,
)
from ..nn.ckpt import policy_from_config, rematerialized
from ..parallel.batch import gather_nodes, local_rows
from ..parallel.hints import own_block, shard_nodes
from .outputs import (
    DecodedGraph, Latents, LatentStats, ModelOutput, adjacency_e2e, apply_coord_activation,
    diag_masked,
)


def adj_head_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters of ``model``'s adjacency head (``model.ADJ_HEAD``)."""
    return {n: p for n, p in model.named_parameters()
            if n.split(".", 1)[0] in model.ADJ_HEAD}


def motif_conv(cfg: Config, in_features: int, hidden, generator: torch.Generator) -> nn.Module:
    """The sg-branch's motif conv of ``cfg``: fourth order on the 3-D
    datasets, else third order; ``cfg.motif_block_rows`` passed on."""
    conv = SpatialGraphConv3D if cfg.uses_3d_conv else SpatialGraphConv
    return conv(in_features, cfg.rel_dim, tuple(hidden), generator,
                block_rows=cfg.motif_block_rows)


class DisentangledSNDVAE(nn.Module):
    # the adjacency head's modules, rematerialized together
    ADJ_HEAD = ("d_bn_e", "e_deconvs", "decoder_adj_bn", "d_e_lin2")

    def __init__(self, cfg: Config, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.remat_context = policy_from_config(cfg.remat, cfg.remat_policy)
        enc, dec = cfg.encoder, cfg.decoder
        N, nf, g = cfg.num_nodes, cfg.num_features, generator
        norm = lambda c: make_norm(c, cfg.parity)

        # --- encoder: topology branch ------------------------------------
        convs, bns, c = [], [], nf
        for h in enc.g_conv_hidden:
            convs.append(GraphConv(c, h, g))
            bns.append(norm(h))
            c = h + nf                                  # skip-concat of the features
        self.g_convs, self.g_bns = nn.ModuleList(convs), nn.ModuleList(bns)
        self.encoder_g_bn = norm(c)
        self.g_lin1 = Dense(N * c, enc.g_hidden_size, g)
        self.g_lin_mean = Dense(enc.g_hidden_size, enc.g_latent_size, g)
        self.g_lin_std = Dense(enc.g_hidden_size, enc.g_latent_size, g)

        # --- encoder: spatial branch -------------------------------------
        convs, bns, c, L = [], [], cfg.spatial_dim, N
        for ch, k, s in zip(enc.s_channels, enc.s_kernel_sizes, enc.s_strides):
            convs.append(Conv1D(c, ch, k, g, s))
            bns.append(norm(ch))
            c, L = ch, convs[-1].out_length(L)
        self.s_convs, self.s_bns = nn.ModuleList(convs), nn.ModuleList(bns)
        self.encoder_s_bn = norm(c)
        self.s_lin1 = Dense(L * c, enc.s_hidden_size, g)
        self.s_lin_mean = Dense(enc.s_hidden_size, enc.s_latent_size, g)
        self.s_lin_std = Dense(enc.s_hidden_size, enc.s_latent_size, g)

        # --- encoder: joint branch ---------------------------------------
        # geoGCN / posGCN take the first width of each layer's tuple;
        # GeoGraphConv outputs one block of it per relation channel
        convs, bns, c = [], [], nf
        for hidden in enc.sg_conv_hidden:
            hidden = tuple(hidden) if isinstance(hidden, (tuple, list)) else (hidden,)
            if cfg.model_type == "geoGCN":
                convs.append(GeoGraphConv(c, hidden[0], g))
                c = cfg.rel_dim * hidden[0]
            elif cfg.model_type == "posGCN":
                convs.append(StructGraphConv(c, hidden[0], g))
                c = hidden[0]
            else:
                convs.append(motif_conv(cfg, c, hidden, g))
                c = hidden[-1]
            bns.append(norm(c))
        self.sg_convs, self.sg_bns = nn.ModuleList(convs), nn.ModuleList(bns)
        self.encoder_sg_bn = norm(c)
        self.sg_lin1 = Dense(N * c, enc.sg_hidden_size, g)
        self.sg_lin_mean = Dense(enc.sg_hidden_size, enc.sg_latent_size, g)
        self.sg_lin_std = Dense(enc.sg_hidden_size, enc.sg_latent_size, g)

        # --- decoder ------------------------------------------------------
        nh = dec.node_h_size
        self.d_sg_lin1 = Dense(enc.sg_latent_size, N * nh, g)
        self.d_s_lin1 = Dense(enc.s_latent_size, N * nh, g)
        self.d_g_lin1 = Dense(enc.g_latent_size, N * nh, g)

        convs, bns, c = [], [], 2 * nh
        for ch, k, s in zip(dec.n_d_channels, dec.n_d_kernel_sizes, dec.n_d_strides):
            convs.append(Conv1D(c, ch, k, g, s))
            bns.append(norm(ch))
            c = ch
        self.n_deconvs, self.d_bn_n = nn.ModuleList(convs), nn.ModuleList(bns)
        self.decoder_node_bn = norm(c)
        self.d_n_lin2 = Dense(c, nf, g)

        # the adjacency head normalizes the pairwise tile-concat map first
        c = 2 * (2 * nh) + (1 if dec.edge_from_coords else 0)
        convs, bns = [], []
        for h in dec.e_d_hidden:
            bns.append(norm(c))
            convs.append(E2E(c, h, N, g))
            c = h
        self.e_deconvs, self.d_bn_e = nn.ModuleList(convs), nn.ModuleList(bns)
        self.decoder_adj_bn = norm(c)
        self.d_e_lin2 = Dense(c, 2, g)

        convs, bns, c = [], [], 2 * nh
        for ch, k, s in zip(dec.s_d_channels, dec.s_d_kernel_sizes, dec.s_d_strides):
            convs.append(Conv1D(c, ch, k, g, s))
            bns.append(norm(ch))
            c = ch
        self.s_deconvs, self.d_bn_s = nn.ModuleList(convs), nn.ModuleList(bns)
        self.d_s_lin2 = Dense(c, cfg.spatial_dim, g)

    @property
    def device(self) -> torch.device:
        return self.d_s_lin2.kernel.device

    @property
    def dtype(self) -> torch.dtype:
        return self.d_s_lin2.kernel.dtype

    # ------------------------------------------------------------------ #
    # Entry point                                                        #
    # ------------------------------------------------------------------ #
    def forward(self, batch: GraphBatch, deterministic_z: bool = False,
                generator: Optional[torch.Generator] = None,
                eps: Optional[Latents] = None, dropout_keep: float = 1.0) -> ModelOutput:
        """Encode, pick latents (posterior means with ``deterministic_z``,
        else μ + ε·σ with ε given or drawn from ``generator``), decode.
        ``dropout_keep`` is taken for a train step common to both families
        and unused: the reference disentangled model has no dropout."""
        del dropout_keep
        stats = self.encode(batch)
        if deterministic_z:
            latents = Latents(z_sg=stats.mean_sg, z_s=stats.mean_s, z_g=stats.mean_g)
        else:
            latents = self.reparameterize(stats, eps=eps, generator=generator)
        return ModelOutput(stats=stats, latents=latents, decoded=self.decode(latents))

    # ------------------------------------------------------------------ #
    # Encoder (model.py:98-151)                                          #
    # ------------------------------------------------------------------ #
    @spans.ranged("model.encode")
    def encode(self, batch: GraphBatch) -> LatentStats:
        B, N = batch.batch_size, batch.num_nodes
        feats, coords, adj = batch.features, batch.coords, batch.adj

        # topology branch
        g = feats
        for conv, bn in zip(self.g_convs, self.g_bns):
            g = torch.cat([bn(conv(adj, g)), feats], dim=-1)
        g_ = self.g_lin1(self.encoder_g_bn(g).reshape(B, -1))
        z_mean_g, z_std_g = self.g_lin_mean(g_), self.g_lin_std(g_)

        # spatial branch
        h = coords
        for conv, bn in zip(self.s_convs, self.s_bns):
            h = torch.relu(bn(conv(h)))
        h_ = self.s_lin1(self.encoder_s_bn(h).reshape(B, -1))
        z_mean_s, z_std_s = self.s_lin_mean(h_), self.s_lin_std(h_)

        if self.cfg.model_type in ("geoGCN", "posGCN"):
            # the baselines' joint branch: the truth graph, S = 1
            sg = feats
            for conv, bn in zip(self.sg_convs, self.sg_bns):
                geo = batch.rel if self.cfg.model_type == "geoGCN" else coords
                sg = lrelu(bn(conv(adj, sg, geo)))
            sg_ = self.sg_lin1(self.encoder_sg_bn(sg).reshape(B, -1))
            return LatentStats(
                mean_sg=self.sg_lin_mean(sg_)[:, None], logstd_sg=self.sg_lin_std(sg_)[:, None],
                mean_s=z_mean_s, logstd_s=z_std_s, mean_g=z_mean_g, logstd_g=z_std_g)

        # joint branch over the B·S spanning trees
        if batch.adj_samples is None:
            raise ValueError("the sg-branch needs spanning-tree samples (adj_samples)")
        S = batch.num_samples
        adj_s = batch.adj_samples.reshape(B * S, N, N)
        if batch.rel_samples is not None:
            rel_s = batch.rel_samples.reshape(B * S, N, N, -1)
        else:
            rel_s = batch.rel[:, None].expand((B, S) + batch.rel.shape[1:]) \
                .reshape(B * S, N, N, -1)
        if batch.feat_samples is not None:
            sg = batch.feat_samples.reshape(B * S, N, -1)
        else:
            sg = feats[:, None].expand((B, S) + feats.shape[1:]).reshape(B * S, N, -1)
        # the stack's backward ends with its first conv's parameter gradients
        spans.stamp("sg_conv.forward.start")
        spans.after_grads("sg_conv.backward.end", self.sg_convs[0])
        for i, (conv, bn) in enumerate(zip(self.sg_convs, self.sg_bns)):
            # under a model axis the conv returns this rank's node rows: the
            # next layer and the flatten read every node
            with spans.labelled(f"model.encode.sg_conv.{i}"):
                sg = rematerialized(self, conv, conv, adj_s, sg, rel_s)
            sg = gather_nodes(lrelu(bn(sg, nodes=N)), N)
        sg = spans.marked("sg_conv.forward.end", "sg_conv.backward.start", sg)
        sg_ = self.sg_lin1(self.encoder_sg_bn(sg).reshape(B * S, -1))
        z_mean_sg, z_std_sg = self.sg_lin_mean(sg_), self.sg_lin_std(sg_)

        return LatentStats(
            mean_sg=z_mean_sg.reshape(B, S, -1),
            logstd_sg=z_std_sg.reshape(B, S, -1),
            mean_s=z_mean_s, logstd_s=z_std_s,
            mean_g=z_mean_g, logstd_g=z_std_g,
        )

    # ------------------------------------------------------------------ #
    # Latent sampling (model.py:153-169)                                 #
    # ------------------------------------------------------------------ #
    def _normal(self, shape, generator: Optional[torch.Generator]) -> torch.Tensor:
        if generator is None:
            raise ValueError("drawing latents needs a torch.Generator")
        # under a data-parallel mesh: the global batch's draw, this rank's rows
        z = local_rows(lambda s: torch.randn(s, generator=generator, device=generator.device,
                                             dtype=self.dtype), shape)
        return z.to(self.device)

    def reparameterize(self, stats: LatentStats, eps: Optional[Latents] = None,
                       generator: Optional[torch.Generator] = None) -> Latents:
        """z = μ + ε·exp(logσ); ε given (a Latents of noise, taken in the
        stats' dtype) or drawn from ``generator`` in the order s, sg, g."""
        if eps is None:
            eps = Latents(z_s=self._normal(stats.mean_s.shape, generator),
                          z_sg=self._normal(stats.mean_sg.shape, generator),
                          z_g=self._normal(stats.mean_g.shape, generator))
        noise = lambda e, t: e.to(t.device, t.dtype).reshape(t.shape)
        return Latents(
            z_sg=stats.mean_sg + noise(eps.z_sg, stats.mean_sg) * torch.exp(stats.logstd_sg),
            z_s=stats.mean_s + noise(eps.z_s, stats.mean_s) * torch.exp(stats.logstd_s),
            z_g=stats.mean_g + noise(eps.z_g, stats.mean_g) * torch.exp(stats.logstd_g),
        )

    def prior_latents(self, batch_size: int, num_samples: int,
                      generator: Optional[torch.Generator]) -> Latents:
        """z ~ N(0, I) in the model's dtype, drawn in the order s, sg, g."""
        enc = self.cfg.encoder
        z_s = self._normal((batch_size, enc.s_latent_size), generator)
        z_sg = self._normal((batch_size, num_samples, enc.sg_latent_size), generator)
        z_g = self._normal((batch_size, enc.g_latent_size), generator)
        return Latents(z_sg=z_sg, z_s=z_s, z_g=z_g)

    # ------------------------------------------------------------------ #
    # Decoder (model.py:172-222)                                         #
    # ------------------------------------------------------------------ #
    @spans.ranged("model.decode")
    def decode(self, latents: Latents) -> DecodedGraph:
        cfg = self.cfg
        N, nh = cfg.num_nodes, cfg.decoder.node_h_size
        z_sg, z_s, z_g = latents.z_sg, latents.z_s, latents.z_g
        B, S = z_sg.shape[0], z_sg.shape[1]

        zsg = self.d_sg_lin1(z_sg.reshape(B * S, -1)).reshape(B, S, N, nh).mean(dim=1)
        zs = self.d_s_lin1(z_s).reshape(B, N, nh)
        zg = self.d_g_lin1(z_g).reshape(B, N, nh)
        z_sg_g = torch.cat([zsg, zg], dim=-1)

        # node-feature head
        x = z_sg_g
        for conv, bn in zip(self.n_deconvs, self.d_bn_n):
            x = bn(conv(x))
        x = self.decoder_node_bn(x.reshape(B * N, -1))
        node_feat = torch.sigmoid(self.d_n_lin2(x)).reshape(B, N, -1)

        # coordinate head, before the adjacency head (edge_from_coords)
        sp = torch.cat([zsg, zs], dim=-1)
        for conv, bn in zip(self.s_deconvs, self.d_bn_s):
            sp = bn(conv(sp))
        coords = apply_coord_activation(
            cfg, self.d_s_lin2(sp.reshape(B * N, -1)), reference_linear=False
        ).reshape(B, N, -1)

        z_in = spans.marked("adj_head.forward.start", "adj_head.backward.end", z_sg_g)
        with spans.labelled("model.decode.adj_head"):
            adj_prob = rematerialized(self, self, self._adj_head, z_in, coords,
                                      params=adj_head_params(self))
        adj_prob = spans.marked("adj_head.forward.end", "adj_head.backward.start", adj_prob)
        adj = torch.softmax(adj_prob, dim=-1).argmax(dim=-1)
        return DecodedGraph(adj=adj, adj_prob=adj_prob, coords=coords, node_feat=node_feat)

    def _adj_head(self, z_sg_g: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """Pairwise tile-concat + E2E stack + diag mask (model.py:196-208);
        this rank's rows under a model axis."""
        N = z_sg_g.shape[1]
        t = adjacency_e2e(self.cfg, self.e_deconvs, self.d_bn_e, z_sg_g, coords)
        logits = self.d_e_lin2(torch.relu(self.decoder_adj_bn(t, nodes=N)))
        return diag_masked(shard_nodes(logits, tag="dec.logits", nodes=N), own_block(N)[0])

    def generate(self, generator: torch.Generator, num: int,
                 num_samples: Optional[int] = None) -> DecodedGraph:
        """Decode from the prior (the reference's test_generation)."""
        S = num_samples or self.cfg.sampling_num
        return self.decode(self.prior_latents(num, S, generator))
