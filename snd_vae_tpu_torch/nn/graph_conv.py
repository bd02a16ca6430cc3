"""``GraphConv``: lrelu(A @ (X W)) — the port of
``snd_vae_tpu/nn/graph_conv.py:29-45`` (reference layers.py:115-125).

The projection ``x @ W``, the aggregation ``A @ xw`` and the lrelu run as
one launch of kernel K3 with ``w`` and leak 0.2, through its autograd
wrapper ``kernels.adj_matmul.adj_matmul``, so the kernel gets a gradient.
"""

from __future__ import annotations

import torch
from torch import nn

from . import init as inits
from .kernels.adj_matmul import adj_matmul


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
