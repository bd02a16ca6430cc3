"""Graph convolutions — the port of ``snd_vae_tpu/nn/graph_conv.py:29-79``.

  * ``GraphConv`` — lrelu(A @ (X W)) (reference layers.py:115-125), the
    encoder's topology branch.  The projection ``x @ W``, the aggregation
    ``A @ xw`` and the lrelu run as one launch of kernel K3 with ``w`` and
    leak 0.2, through its autograd wrapper ``kernels.adj_matmul.adj_matmul``,
    so the kernel gets a gradient.
  * ``GraphConvFull`` — per-channel lrelu(A_c @ (X W)) over a multi-channel
    adjacency [B,N,N,C], the channels concatenated (layers.py:127-139).
  * ``normalized_graph_conv`` — A_norm @ (X W) with a caller-supplied
    normalized adjacency.
  No model calls the last two; they are plain PyTorch products, as the JAX
  package's are XLA einsums.
"""

from __future__ import annotations

import torch
from torch import nn

from . import init as inits
from .basic import acc_dtype, lrelu
from .kernels.adj_matmul import adj_matmul, project


class GraphConv(nn.Module):
    """lrelu(A @ (X W)); W ~ truncated_normal(0.02).  adj [B,N,N], x [B,N,F]."""

    def __init__(self, in_features: int, features: int, generator: torch.Generator,
                 stddev: float = 0.02):
        super().__init__()
        self.kernel = nn.Parameter(
            inits.truncated_normal((in_features, features), stddev, generator)
        )

    def forward(self, adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return adj_matmul(adj.contiguous(), x.contiguous(), leak=0.2, w=self.kernel)


class GraphConvFull(nn.Module):
    """adj [B,N,N,C], x [B,N,F] -> [B,N,C·features]: channel c is
    lrelu(A_c @ (X W)); W ~ truncated_normal(0.02)."""

    def __init__(self, in_features: int, features: int, generator: torch.Generator,
                 stddev: float = 0.02):
        super().__init__()
        self.kernel = nn.Parameter(
            inits.truncated_normal((in_features, features), stddev, generator)
        )

    def forward(self, adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        acc = acc_dtype(x.dtype)
        conv = torch.einsum("bnmc,bmo->bnco", adj.to(acc), project(x, self.kernel).to(acc))
        out = lrelu(conv.to(x.dtype))
        return out.reshape(out.shape[0], out.shape[1], -1)


def normalized_graph_conv(adj_norm: torch.Tensor, x: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """A_norm @ (X W) over [..., N, N] and [..., N, F]."""
    acc = acc_dtype(x.dtype)
    return (adj_norm.to(acc) @ project(x, w).to(acc)).to(x.dtype)
