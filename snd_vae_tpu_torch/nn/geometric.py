"""Geometric features and the geoGCN / posGCN encoder layers — the port of
``snd_vae_tpu/nn/geometric.py:39-211`` (reference layers.py:606-784).

  * ``knn_dist``             — kNN graph from 3D coords
  * ``rbf_expand``           — radial-basis distance expansion
  * ``positional_embedding`` — sinusoidal relative-index embedding
  * ``gather_nodes``         — per-neighbour gather (the JAX package's, not the
                               reference's, which indexes the wrong axis)
  * ``quaternions`` / ``orientations`` — backbone frames, relative rotations
  * ``GeoGraphConv``         — geoGCN's layer: lrelu(adj[...,None]·rel @ XW)
                               per relation channel
  * ``StructGraphConv``      — posGCN's layer: geometric edge embeddings and
                               kNN message passing; 2D coords are lifted to
                               the z = 0 plane

Both layers keep the JAX package's well-defined forms of the reference's
shape-inconsistent code (``geometric.py:15-23`` there).  Their contractions
are plain PyTorch products: the JAX package runs them as XLA einsums, not
as a TPU kernel.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from . import init as inits
from .basic import acc_dtype, lrelu
from .kernels.adj_matmul import project


def knn_dist(x: torch.Tensor, eps: float = 1e-6,
             top_k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B,L,3] coords -> (D_neighbors [B,L,K], E_idx [B,L,K]): the K smallest
    of d + rowmax(d) per row, ties to the lower index (as ``lax.top_k``), so
    each node's first neighbour is itself."""
    dx = x[:, None, :, :] - x[:, :, None, :]
    d = torch.sqrt((dx * dx).sum(-1) + eps)
    d_adjust = d + d.amax(dim=-1, keepdim=True)
    vals, idx = torch.sort(d_adjust, dim=-1, stable=True)
    k = min(top_k, x.shape[1])
    return vals[..., :k], idx[..., :k]


def rbf_expand(d: torch.Tensor, num_rbf: int = 16, d_min: float = 0.0,
               d_max: float = 20.0) -> torch.Tensor:
    """[B,L,K] distances -> [B,L,K,num_rbf] Gaussian RBF features, in at
    least f32 (the JAX centres are f32)."""
    mu = torch.linspace(d_min, d_max, num_rbf, device=d.device,
                        dtype=torch.promote_types(torch.float32, d.dtype))
    sigma = (d_max - d_min) / num_rbf
    return torch.exp(-(((d[..., None] - mu) / sigma) ** 2))


def positional_embedding(e_idx: torch.Tensor, num_embeddings: int = 16,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sinusoidal embedding of the neighbour offsets e_idx - i, computed in
    ``dtype`` (the JAX function computes it in float32; StructGraphConv asks
    for at least float32)."""
    L = e_idx.shape[1]
    ii = torch.arange(L, dtype=dtype, device=e_idx.device)[None, :, None]
    d = (e_idx.to(dtype) - ii)[..., None]
    freq = torch.exp(torch.arange(0, num_embeddings, 2, dtype=dtype, device=e_idx.device)
                     * -(math.log(10000.0) / num_embeddings))
    angles = d * freq
    return torch.cat([torch.cos(angles), torch.sin(angles)], dim=-1)


def gather_nodes(nodes: torch.Tensor, e_idx: torch.Tensor) -> torch.Tensor:
    """[B,L,C] features at [B,L,K] indices -> [B,L,K,C]."""
    b = torch.arange(nodes.shape[0], device=nodes.device)[:, None, None]
    return nodes[b, e_idx]


def quaternions(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [...,3,3] -> unit quaternions [...,4] (x, y, z, w)."""
    diag = torch.diagonal(r, dim1=-2, dim2=-1)
    rxx, ryy, rzz = diag[..., 0], diag[..., 1], diag[..., 2]
    mags = 0.5 * torch.sqrt(torch.abs(1 + torch.stack(
        [rxx - ryy - rzz, -rxx + ryy - rzz, -rxx - ryy + rzz], -1)))
    signs = torch.sign(torch.stack(
        [r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
         r[..., 1, 0] - r[..., 0, 1]], -1))
    w = torch.sqrt(torch.relu(1 + diag.sum(-1, keepdim=True))) / 2.0
    return _l2norm(torch.cat([signs * mags, w], -1))


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=eps)


def orientations(x: torch.Tensor, e_idx: torch.Tensor,
                 eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone angle features and relative-orientation features: x [B,L,3]
    coords -> (AD_features [B,L,3], O_features [B,L,K,7])."""
    cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)
    u = _l2norm(x[:, 1:] - x[:, :-1])
    u_2, u_1, u_0 = u[:, :-2], u[:, 1:-1], u[:, 2:]
    n_2 = _l2norm(cross(u_2, u_1))
    n_1 = _l2norm(cross(u_1, u_0))

    cos_a = torch.clamp((-(u_1 * u_0)).sum(-1), -1 + eps, 1 - eps)
    a = torch.arccos(cos_a)
    cos_d = torch.clamp((n_2 * n_1).sum(-1), -1 + eps, 1 - eps)
    d = torch.sign((u_2 * n_1).sum(-1)) * torch.arccos(cos_d)
    ad = torch.stack([torch.cos(a), torch.sin(a) * torch.cos(d), torch.sin(a) * torch.sin(d)], 2)
    ad = nn.functional.pad(ad, (0, 0, 1, 2))

    o_1 = _l2norm(u_2 - u_1)
    o = torch.stack([o_1, n_2, cross(o_1, n_2)], 2)
    o = nn.functional.pad(o.reshape(o.shape[0], o.shape[1], 9), (0, 0, 1, 2))

    o_neighbors = gather_nodes(o, e_idx)
    x_neighbors = gather_nodes(x, e_idx)
    o_mat = o.reshape(o.shape[0], o.shape[1], 3, 3)
    o_n_mat = o_neighbors.reshape(o_neighbors.shape[:3] + (3, 3))

    du = _l2norm(torch.einsum("blij,blkj->blki", o_mat, x_neighbors - x[:, :, None, :]))
    # r[b,l,k] = O_l^T O_k as three outer products added in a fixed order:
    # r_im - r_mi is then exactly 0 where the math makes r symmetric (a
    # node with itself; on planar coordinates, frames turning opposite
    # ways), so the quaternion's sign(r_im - r_mi) is 0 there on every
    # device, not the sign of a rounding residue
    rows = [o_mat[:, :, None, j, :, None] * o_n_mat[:, :, :, j, None, :] for j in range(3)]
    r = rows[0] + rows[1] + rows[2]
    return ad, torch.cat([du, quaternions(r)], dim=-1)


class GeoGraphConv(nn.Module):
    """geoGCN's layer (layers.py:606-619): per relation channel c,
    lrelu((adj ⊙ rel_c) @ (X W)); the channels concatenate on the feature
    axis -> [B,N,R·features].  W ~ truncated_normal(0.02) [F, features]."""

    def __init__(self, in_features: int, features: int, generator: torch.Generator,
                 stddev: float = 0.02):
        super().__init__()
        self.w = nn.Parameter(inits.truncated_normal((in_features, features), stddev, generator))

    def forward(self, adj: torch.Tensor, x: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
        adj_mc = adj[..., None] * rel                                   # [B,N,N,R]
        xw = project(x, self.w)
        acc = acc_dtype(x.dtype)
        conv = torch.einsum("bnmc,bmo->bnco", adj_mc.to(acc), xw.to(acc)).to(x.dtype)
        out = lrelu(conv)
        return out.reshape(out.shape[0], out.shape[1], -1)


class StructGraphConv(nn.Module):
    """posGCN's layer (layers.py:759-784): kNN graph of the coordinates,
    edge features [positional 16, RBF 16, orientation 7] embedded to
    ``edge_channels`` by ``edge_embedding_matrix`` + ``bias1``, then
    lrelu(mean over channels of Σ_k edge[l,k,c]·(X W)[nbr_k(l)]).  2D
    coordinates are lifted to the z = 0 plane."""

    def __init__(self, in_features: int, features: int, generator: torch.Generator,
                 num_rbf: int = 16, top_k: int = 10, num_positional_embeddings: int = 16,
                 edge_channels: int = 128, stddev: float = 0.02, bias_start: float = 0.0):
        super().__init__()
        self.num_rbf, self.top_k = num_rbf, top_k
        self.num_positional_embeddings = num_positional_embeddings
        self.edge_channels = edge_channels
        self.edge_embedding_matrix = nn.Parameter(inits.normal(
            (num_positional_embeddings + num_rbf + 7, edge_channels), stddev, generator))
        self.bias1 = nn.Parameter(torch.full((edge_channels,), float(bias_start)))
        self.w = nn.Parameter(inits.truncated_normal((in_features, features), stddev, generator))

    def forward(self, adj: torch.Tensor, x: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        if coords.shape[-1] < 3:
            pad = coords.new_zeros(coords.shape[:-1] + (3 - coords.shape[-1],))
            coords = torch.cat([coords, pad], dim=-1)
        d_neighbors, e_idx = knn_dist(coords, top_k=self.top_k)
        _, o_features = orientations(coords, e_idx)
        # edge features in at least f32, as the JAX concat promotes them
        rbf = rbf_expand(d_neighbors, self.num_rbf)
        et = rbf.dtype
        e_pos = positional_embedding(e_idx, self.num_positional_embeddings, et)
        edge = torch.cat([e_pos, rbf, o_features.to(et)], -1)
        edge = (edge @ self.edge_embedding_matrix.to(et)).to(x.dtype) + self.bias1

        x_neigh = gather_nodes(project(x, self.w), e_idx)           # [B,L,K,out]
        acc = acc_dtype(x.dtype)
        conv = torch.einsum("blkc,blko->blo", edge.to(acc), x_neigh.to(acc)).to(x.dtype)
        return lrelu(conv / self.edge_channels)
