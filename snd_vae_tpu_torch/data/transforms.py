"""Graph transforms — the port of ``snd_vae_tpu/data/transforms.py:25-175``.

The reference's host-side NumPy/SciPy preprocessing as torch functions on
any device (batched over leading axes):

  * ``gcn_normalize``      — D^-1/2 (A+I) D^-1/2 (preprocessing.py:15-30)
  * ``pairwise_distances`` — ``cal_rel_dist`` (input_data.py:145-151)
  * ``zscore``             — ZscoreNormalization (main.py:110-113)
  * ``zero_diagonal``, ``edge_logit_mask``, ``motif_adj_3d``
  * ``dropout_edges``      — symmetric edge dropout, from a ``torch.Generator``
                             where JAX takes a key

and the host-side NumPy ones, copied as they are: ``split_edges`` and
``edge_dropout`` take a ``numpy.random.Generator`` and give the JAX
package's arrays bit for bit; ``pad_graph`` pads one graph.  JAX's
``sparse_to_tuple`` takes scipy sparse matrices and stays out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def gcn_normalize(adj: torch.Tensor, add_self_loops: bool = True) -> torch.Tensor:
    """Symmetric GCN normalization D^-1/2 (A + I) D^-1/2 of [..., N, N]."""
    n = adj.shape[-1]
    a = adj + torch.eye(n, dtype=adj.dtype, device=adj.device) if add_self_loops else adj
    deg = a.sum(-1)
    inv_sqrt = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)), torch.zeros_like(deg))
    return a * inv_sqrt[..., :, None] * inv_sqrt[..., None, :]


def pairwise_distances(coords: torch.Tensor) -> torch.Tensor:
    """[..., N, D] coordinates -> [..., N, N] Euclidean distances."""
    diff = coords[..., :, None, :] - coords[..., None, :, :]
    return torch.sqrt((diff * diff).sum(-1))


def zscore(x: torch.Tensor, mean, std) -> torch.Tensor:
    """Z-score normalization (main.py:110-113)."""
    return (x - mean) / std


def zero_diagonal(adj: torch.Tensor) -> torch.Tensor:
    """Zero the diagonal of [..., N, N] (input_data.py:64-65)."""
    n = adj.shape[-1]
    return adj * (1.0 - torch.eye(n, dtype=adj.dtype, device=adj.device))


def edge_logit_mask(n: int, batch_shape: Tuple[int, ...] = (), dtype=torch.float32,
                    device: Optional[torch.device] = None) -> torch.Tensor:
    """The decoder's off-diagonal mask (model.py:185): ones minus eye."""
    m = 1.0 - torch.eye(n, dtype=dtype, device=device)
    return m.expand(tuple(batch_shape) + (n, n))


def motif_adj_3d(adj: torch.Tensor) -> torch.Tensor:
    """2-hop motif tensor g3d[i,j,k] = A[i,j]·A[j,k] (``generate_adj_3d``,
    input_data.py:40-52), batched."""
    return adj[..., :, :, None] * adj[..., None, :, :]


def dropout_edges(adj: torch.Tensor, keep_prob: float,
                  generator: torch.Generator) -> torch.Tensor:
    """Edge dropout with inverted scaling, the dense analog of the
    reference's ``dropout_sparse`` (layers.py:22-30): a Bernoulli(keep_prob)
    mask drawn from ``generator``, its upper triangle mirrored so that an
    undirected graph stays undirected; kept entries become A / keep_prob."""
    u = torch.rand(adj.shape, generator=generator, device=generator.device).to(adj.device)
    mask = u < keep_prob
    mask = torch.triu(mask) | torch.triu(mask, 1).transpose(-1, -2)
    return torch.where(mask, adj / keep_prob, torch.zeros((), dtype=adj.dtype, device=adj.device))


# ---------------------------------------------------------------------------
# Edge splitting / masking (legacy VGAE capability, preprocessing.py:52-140)
# ---------------------------------------------------------------------------

def split_edges(
    adj: np.ndarray,
    rng: np.random.Generator,
    test_frac: float = 0.1,
    val_frac: float = 0.05,
) -> dict:
    """Randomly split one graph's undirected edges into train/val/test sets
    plus matched false (non-edge) sets (``get_test_edges``,
    preprocessing.py:82-116, vectorized; the train graph is not kept
    connected).  Returns 'adj_train' and edge index arrays [K, 2]."""
    n = adj.shape[0]
    iu, ju = np.triu_indices(n, k=1)
    is_edge = adj[iu, ju] > 0
    edges = np.stack([iu[is_edge], ju[is_edge]], axis=1)
    non_edges = np.stack([iu[~is_edge], ju[~is_edge]], axis=1)

    e = len(edges)
    num_test = int(np.floor(e * test_frac))
    num_val = int(np.floor(e * val_frac))
    perm = rng.permutation(e)
    test_e = edges[perm[:num_test]]
    val_e = edges[perm[num_test: num_test + num_val]]
    train_e = edges[perm[num_test + num_val:]]

    fperm = rng.permutation(len(non_edges))
    test_f = non_edges[fperm[:num_test]]
    val_f = non_edges[fperm[num_test: num_test + num_val]]

    adj_train = np.zeros_like(adj)
    adj_train[train_e[:, 0], train_e[:, 1]] = 1
    adj_train[train_e[:, 1], train_e[:, 0]] = 1
    return {
        "adj_train": adj_train,
        "train_edges": train_e,
        "val_edges": val_e,
        "val_edges_false": val_f,
        "test_edges": test_e,
        "test_edges_false": test_f,
    }


def edge_dropout(adj: np.ndarray, dropout: float, rng: np.random.Generator) -> np.ndarray:
    """Randomly remove a fraction of undirected edges (preprocessing.py:118-140)."""
    n = adj.shape[0]
    iu, ju = np.triu_indices(n, k=1)
    is_edge = adj[iu, ju] > 0
    edges = np.stack([iu[is_edge], ju[is_edge]], axis=1)
    num_drop = int(np.floor(len(edges) * dropout))
    keep = rng.permutation(len(edges))[num_drop:]
    kept = edges[keep]
    out = np.zeros_like(adj)
    out[kept[:, 0], kept[:, 1]] = 1
    out[kept[:, 1], kept[:, 0]] = 1
    return out


# ---------------------------------------------------------------------------
# Padding for variable-N batching
# ---------------------------------------------------------------------------

def pad_graph(
    adj: np.ndarray, features: np.ndarray, coords: np.ndarray, n_pad: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad one graph to ``n_pad`` nodes; returns (adj, feat, coords, mask)."""
    n = adj.shape[0]
    if n > n_pad:
        raise ValueError(f"a graph of {n} nodes does not pad to {n_pad}")
    pad = n_pad - n
    adj_p = np.pad(adj, ((0, pad), (0, pad)))
    feat_p = np.pad(features, ((0, pad), (0, 0)))
    coords_p = np.pad(coords, ((0, pad), (0, 0)))
    mask = np.zeros(n_pad, dtype=adj.dtype)
    mask[:n] = 1
    return adj_p, feat_p, coords_p, mask
