"""ELBO losses and disentanglement regularizers — the port of
``snd_vae_tpu/losses.py`` (reference optimizer.py:7-203).

  * reconstruction — 2-class softmax CE over edges vs [1-A, A] (scene: K-way
    one-hot), node MSE (scene: 0, or categorical CE with
    ``scene_node_loss``), coordinate MSE; optionally the weighted BCE whose
    ``pos_weight`` / ``norm`` are derived from the batch on the device;
  * ``kl_diag_gaussian`` — mean over all elements, logσ convention;
  * the capacity-annealed KL (disentangled_C), DIP-VAE (NED-VAE-IP) and the
    β-TCVAE total correlation.

``elbo_loss`` dispatches on ``model_type`` as the JAX ``elbo_loss`` does and
returns (total, aux) with the same aux keys.  The losses are computed in at
least float32 whatever the compute dtype: bf16 outputs are cast up, float64
stays float64 (the tests compare in float64).

Under a data-parallel mesh (``parallel.hints.use_mesh``) each rank holds
its block of the batch, and every term that reads the whole batch is taken
over the global batch (``parallel/batch.py``): the loss terms' means, the
weighted BCE's counts, DIP-VAE's moments and β-TCVAE's log q(z), which
scores each local sample against every sample's (μ, logσ).

Under the mesh's ``model`` axis the decoder's edge logits hold this rank's
rows i (``parallel.hints.own_block``): the edge terms average them against
the same rows of the truth and sum over the model ranks
(``parallel.batch.node_mean``), while the weighted BCE's ``pos_weight`` /
``norm`` count the whole truth adjacency, which every model rank holds, once.
"""

from __future__ import annotations

import math
from dataclasses import fields, is_dataclass, replace
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import Config
from .models.outputs import ModelOutput
from .parallel.batch import global_mean, global_rows, global_sum, node_mean
from .parallel.hints import shard_nodes


def at_least_f32(x):
    """A float tensor, or a dataclass of them (``ModelOutput`` and its
    parts), in at least float32; other leaves unchanged."""
    if is_dataclass(x):
        return replace(x, **{f.name: at_least_f32(getattr(x, f.name)) for f in fields(x)})
    if (isinstance(x, torch.Tensor) and x.is_floating_point()
            and x.dtype != torch.float64):
        return x.float()
    return x


# ---------------------------------------------------------------------------
# Reconstruction terms
# ---------------------------------------------------------------------------

def edge_cross_entropy(adj_logits: torch.Tensor, adj_true: torch.Tensor) -> torch.Tensor:
    """Mean softmax CE of 2-class edge logits vs the [1-A, A] one-hot (under
    a model axis: over every rank's rows)."""
    labels = torch.stack([1.0 - adj_true, adj_true], dim=-1)
    logp = torch.log_softmax(adj_logits, dim=-1)
    return node_mean(-(labels * logp).sum(-1), adj_logits.shape[2])


def edge_categorical_cross_entropy(adj_logits: torch.Tensor, adj_true: torch.Tensor,
                                   num_classes: int) -> torch.Tensor:
    """Scene dataset: K-way categorical edges."""
    labels = F.one_hot(adj_true.long(), num_classes).to(adj_logits.dtype)
    logp = torch.log_softmax(adj_logits, dim=-1)
    return node_mean(-(labels * logp).sum(-1), adj_logits.shape[2])


def edge_weighted_bce(adj_logits: torch.Tensor, adj_true: torch.Tensor,
                      pos_weight, norm) -> torch.Tensor:
    """Weighted binary CE on the single logit l = l1 - l0 of the 2-class
    head: (1-y)·l + (1 + (w-1)·y)·log(1+exp(-l)), TF's formula."""
    logit = adj_logits[..., 1] - adj_logits[..., 0]
    log1p = torch.logaddexp(torch.zeros_like(logit), -logit)
    loss = (1.0 - adj_true) * logit + (1.0 + (pos_weight - 1.0) * adj_true) * log1p
    return norm * node_mean(loss, adj_logits.shape[2])


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (target - pred).square().mean()


# ---------------------------------------------------------------------------
# KL family
# ---------------------------------------------------------------------------

def kl_diag_gaussian(mean: torch.Tensor, logstd: torch.Tensor) -> torch.Tensor:
    """-(1/2)·mean(1 + 2logσ − μ² − exp(logσ)²), over all elements."""
    return -0.5 * (1.0 + 2.0 * logstd - mean.square() - torch.exp(logstd).square()).mean()


def capacity_schedule(global_iter: torch.Tensor, c_max: float, c_stop_iter: float,
                      c_step: float) -> torch.Tensor:
    """C = clip(C_max·C_step/C_stop_iter·⌊iter/C_step⌋, 0, C_max)."""
    return torch.clamp(c_max * c_step / c_stop_iter * torch.floor(global_iter / c_step),
                       0.0, c_max)


def kl_between_gaussians(mu, sigma, mu1, sigma1) -> torch.Tensor:
    """KL(N(μ,σ²) || N(μ1,σ1²)) elementwise."""
    return 0.5 * ((sigma / sigma1) ** 2 + (mu - mu1) ** 2 / sigma1 ** 2 - 1.0
                  + 2.0 * (torch.log(sigma1) - torch.log(sigma)))


# ---------------------------------------------------------------------------
# Disentanglement regularizers
# ---------------------------------------------------------------------------

def dip_regularizer(enc_mean: torch.Tensor, lambda_od: float, lambda_d: float) -> torch.Tensor:
    """DIP-VAE covariance penalty."""
    mu = enc_mean.reshape(-1, enc_mean.shape[-1])
    exp_mu, exp_mu_mu_t = global_mean(mu.mean(0), (mu[:, None, :] * mu[:, :, None]).mean(0))
    cov = exp_mu_mu_t - exp_mu[None, :] * exp_mu[:, None]
    diag = torch.diagonal(cov)
    off_diag = cov - torch.diag(diag)
    return lambda_od * off_diag.square().sum() + lambda_d * (diag - 1.0).square().sum()


def gaussian_log_density(samples, mean, log_var) -> torch.Tensor:
    normalization = math.log(2.0 * math.pi)
    inv_sigma = torch.exp(-log_var)
    tmp = samples - mean
    return -0.5 * (tmp * tmp * inv_sigma + log_var + normalization)


def total_correlation(z, z_mean, z_logstd) -> torch.Tensor:
    """Minibatch TC estimate: E_j[log q(z_j) − log Π_l q(z_j_l)], each
    sample z_j against every (μ, logσ) of the global batch."""
    L = z.shape[-1]
    z = z.reshape(-1, L)
    stats = global_rows(torch.cat([z_mean.reshape(-1, L), z_logstd.reshape(-1, L)], dim=1))
    z_mean, z_logvar = stats[:, :L], 2.0 * stats[:, L:]
    log_qz_prob = gaussian_log_density(z[:, None, :], z_mean[None], z_logvar[None])
    log_qz_product = torch.logsumexp(log_qz_prob, dim=1).sum(1)
    log_qz = torch.logsumexp(log_qz_prob.sum(2), dim=1)
    return global_mean((log_qz - log_qz_product).mean())


def hierarchical_total_correlation(z1, m1, s1, z2, m2, s2, z3, m3, s3) -> torch.Tensor:
    """Group TC across the three branches."""
    flat = lambda t: t.reshape(-1, t.shape[-1])
    z = torch.cat([flat(z1), flat(z2), flat(z3)], dim=1)
    d1 = z1.shape[-1]
    d2 = d1 + z2.shape[-1]
    d3 = d2 + z3.shape[-1]
    stats = global_rows(torch.cat([flat(m1), flat(m2), flat(m3), 2.0 * flat(s1),
                                   2.0 * flat(s2), 2.0 * flat(s3)], dim=1))
    mean, logvar = stats[:, :d3], stats[:, d3:]
    log_qz_prob = gaussian_log_density(z[:, None, :], mean[None], logvar[None])
    group = lambda lo, hi: torch.logsumexp(log_qz_prob[:, :, lo:hi].sum(2), dim=1)
    log_qz = torch.logsumexp(log_qz_prob.sum(2), dim=1)
    return global_mean((log_qz - (group(0, d1) + group(d1, d2) + group(d2, d3))).mean())


# ---------------------------------------------------------------------------
# Full ELBO
# ---------------------------------------------------------------------------

def reconstruction_losses(
    cfg: Config,
    output: ModelOutput,
    adj_true: torch.Tensor,
    node_true: torch.Tensor,
    coords_true: torch.Tensor,
    pos_weight=None,
    norm=None,
    node_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    d = output.decoded
    # the truth's rows that the logits hold (all of them without a model axis)
    adj_rows = shard_nodes(adj_true, tag="loss.adj_true", nodes=adj_true.shape[1])
    if cfg.dataset == "scene":
        adj_cost = edge_categorical_cross_entropy(d.adj_prob, adj_rows,
                                                  cfg.decoder.num_edge_feature)
        if cfg.loss.scene_node_loss and d.node_feat_prob is not None:
            node_cost = -(node_true * torch.log_softmax(d.node_feat_prob, dim=-1)).sum(-1).mean()
        else:
            node_cost = adj_cost.new_zeros(())
    elif cfg.loss.use_weighted_bce:
        if pos_weight is None:
            # the class-imbalance stats of this batch, on the device; padded
            # nodes (node_mask = 0) do not count as negatives
            if node_mask is not None:
                n_tot = (node_mask[..., :, None] * node_mask[..., None, :]).sum().to(adj_true.dtype)
            else:
                n_tot = adj_true.new_tensor(float(adj_true.numel()))
            # the global batch's counts under a data-parallel mesh
            n_tot, n_pos = global_sum(n_tot, adj_true.sum())
            n_pos = torch.clamp(n_pos, min=1.0)
            pos_weight = (n_tot - n_pos) / n_pos
            norm = n_tot / (2.0 * torch.clamp(n_tot - n_pos, min=1.0))
        if norm is None:
            norm = 1.0
        adj_cost = edge_weighted_bce(d.adj_prob, adj_rows, pos_weight, norm)
        node_cost = mse(d.node_feat, node_true)
    else:
        adj_cost = edge_cross_entropy(d.adj_prob, adj_rows)
        node_cost = mse(d.node_feat, node_true)
    spatial_cost = mse(d.coords, coords_true)
    return {"adj_loss": adj_cost, "node_loss": node_cost, "spatial_loss": spatial_cost}


def elbo_loss(
    cfg: Config,
    output: ModelOutput,
    adj_true: torch.Tensor,
    node_true: torch.Tensor,
    coords_true: torch.Tensor,
    global_iter=0.0,
    beta: Optional[float] = None,
    pos_weight=None,
    norm=None,
    node_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total cost and the aux dict, dispatching on ``cfg.model_type``."""
    beta = cfg.loss.beta if beta is None else beta
    output = at_least_f32(output)
    adj_true, node_true, coords_true = (at_least_f32(t) for t in (adj_true, node_true,
                                                                   coords_true))
    stats, lat = output.stats, output.latents
    aux = reconstruction_losses(cfg, output, adj_true, node_true, coords_true,
                                pos_weight, norm, node_mask=node_mask)
    aux["sg_kl"] = kl_diag_gaussian(stats.mean_sg, stats.logstd_sg)
    mt = cfg.model_type
    if mt in ("disentangled", "geoGCN", "posGCN", "disentangled_C", "NED-VAE-IP",
              "beta-TCVAE"):
        aux["spatial_kl"] = kl_diag_gaussian(stats.mean_s, stats.logstd_s)
        aux["graph_kl"] = kl_diag_gaussian(stats.mean_g, stats.logstd_g)
    # the global batch's means under a data-parallel mesh, in one all-reduce
    aux = dict(zip(aux, global_mean(*aux.values())))
    mse_loss = aux["adj_loss"] + aux["node_loss"] + aux["spatial_loss"]
    kl_sg, kl_s, kl_g = aux["sg_kl"], aux.get("spatial_kl"), aux.get("graph_kl")

    if mt in ("disentangled", "geoGCN", "posGCN"):
        cost = mse_loss + beta * (kl_sg + kl_s + kl_g)
    elif mt == "disentangled_C":
        c = capacity_schedule(torch.as_tensor(global_iter, dtype=torch.float32,
                                              device=kl_sg.device),
                              cfg.loss.c_max, cfg.loss.c_stop_iter, cfg.loss.c_step)
        cost = mse_loss + cfg.loss.gamma * torch.relu(kl_sg - c) + kl_s + kl_g
        aux["capacity"] = c
    elif mt == "NED-VAE-IP":
        lod, ld = cfg.loss.dip_lambda_od, cfg.loss.dip_lambda_d
        dip = (dip_regularizer(stats.mean_s, lod, ld) + dip_regularizer(stats.mean_g, lod, ld)
               + dip_regularizer(stats.mean_sg, lod, ld))
        cost = mse_loss + (kl_sg + kl_s + kl_g) + beta * dip
        aux["dip"] = dip
    elif mt == "beta-TCVAE":
        tc = (total_correlation(lat.z_s, stats.mean_s, stats.logstd_s)
              + total_correlation(lat.z_g, stats.mean_g, stats.logstd_g)
              + total_correlation(lat.z_sg, stats.mean_sg, stats.logstd_sg))
        cost = mse_loss + beta * (kl_sg + kl_s + kl_g) + cfg.loss.tc_weight * tc
        aux["tc"] = tc
    else:  # the base (joint) model
        cost = mse_loss + beta * kl_sg

    aux["loss"] = cost
    aux["mse_loss"] = mse_loss
    return cost, aux
