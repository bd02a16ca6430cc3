"""Large graphs: the node-sharded GCN encoder over the mesh's ``model``
axis — the counterpart of ``snd_vae_tpu/parallel/large_graph.py:48-179``.

The node axis is split over d processes: rank r holds adjacency rows
A[rows_r, :] ([N/d, N]) and feature rows X[rows_r, :] ([N/d, F]), with
rows_r = [r·N/d, (r+1)·N/d).  One layer lrelu(A @ (X W)) projects its rows
locally ([N/d, F] @ [F, H], no communication), all-gathers the [N/d, H]
projections into the full [N, H] and contracts its row block with it
([N/d, N] @ [N, H]).  JAX writes this with ``shard_map`` over global
arrays; here each function takes this rank's blocks and calls the
collectives of ``mesh.get_group(axis)`` itself.

The contraction is ``torch.matmul`` plus lrelu, JAX's default, or with
``use_kernel=True`` (JAX's ``use_pallas``) kernel K3, ``adj_matmul`` with
the lrelu fused: the CUDA kernel on the card, its plain version only for
CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..nn import init as inits
from ..nn.kernels.adj_matmul import adj_matmul, project
from .batch import all_reduce, gather_rows


def sharded_graph_conv(adj_blk: torch.Tensor, x_blk: torch.Tensor, w: torch.Tensor,
                       mesh: DeviceMesh, axis: str = "model", leak: Optional[float] = 0.2,
                       use_kernel: bool = False) -> torch.Tensor:
    """One node-sharded GCN layer, lrelu(A @ (X W)), on this rank's rows:
    adj_blk [N/d, N], x_blk [N/d, F], w [F, H] (the same on every rank);
    returns this rank's rows [N/d, H] in x's dtype."""
    xw = project(x_blk, w)                                    # x @ w in >= f32, x's dtype
    xw_full = gather_rows(xw, mesh.get_group(axis))          # [N, H]
    if use_kernel:
        return adj_matmul(adj_blk, xw_full, leak)
    out = torch.matmul(adj_blk, xw_full)
    return out if leak is None else torch.maximum(out, leak * out)


def sharded_degree(adj_blk: torch.Tensor) -> torch.Tensor:
    """Row degrees [N/d, 1] of this rank's adjacency rows (no
    communication)."""
    return adj_blk.sum(-1, keepdim=True)


def sharded_gcn_normalize(adj_blk: torch.Tensor, mesh: DeviceMesh,
                          axis: str = "model") -> torch.Tensor:
    """D^-1/2 (A + I) D^-1/2 on this rank's rows [N/d, N]: the identity's
    slice at row offset r·N/d, the inverse square root of each row's
    degree (0 where it is 0), one all-gather of the [N/d, 1] scales for the
    columns."""
    group = mesh.get_group(axis)
    rows = adj_blk.shape[0]
    a = adj_blk.clone()
    a.diagonal(dist.get_rank(group) * rows).add_(1)
    deg = a.sum(-1, keepdim=True)
    inv = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)), torch.zeros_like(deg))
    inv_full = gather_rows(inv, group)                        # [N, 1]
    return a.mul_(inv).mul_(inv_full.reshape(1, -1))


def shard_graph(adj, x, mesh: DeviceMesh, axis: str = "model",
                dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad a global graph (adj [n, n], x [n, F]; numpy or tensors) with zero
    nodes to N, the next multiple of the axis size d, and return this
    rank's row blocks [N/d, N] and [N/d, F] in ``dtype`` on the mesh's
    device."""
    group = mesh.get_group(axis)
    d, r = dist.get_world_size(group), dist.get_rank(group)
    adj, x = np.asarray(adj), np.asarray(x)
    n = adj.shape[0]
    pad = (-n) % d
    rows = slice(r * (n + pad) // d, (r + 1) * (n + pad) // d)
    adj_p = np.pad(adj, ((0, pad), (0, pad)))[rows]
    x_p = np.pad(x, ((0, pad), (0, 0)))[rows]
    dev = torch.device(mesh.device_type)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev, dtype)
    return as_t(adj_p), as_t(x_p)


class ShardedGCNEncoder(nn.Module):
    """Stacked ``sharded_graph_conv`` layers with a mean-pooled readout.

    ``kernels`` holds one [F_in, H] matrix per width of ``hidden``, drawn
    as JAX's ``init`` draws them (a normal truncated at ±2, times 0.02)
    from ``generator``; ``params.sharded_gcn_state_dict`` carries JAX's
    list of kernels across."""

    def __init__(self, mesh: DeviceMesh, hidden: Sequence[int], num_features: int,
                 generator: torch.Generator, axis: str = "model", use_kernel: bool = False):
        super().__init__()
        self.mesh, self.axis, self.use_kernel = mesh, axis, use_kernel
        self.hidden = tuple(hidden)
        fans = (num_features,) + self.hidden[:-1]
        self.kernels = nn.ParameterList(
            nn.Parameter(inits.truncated_normal((f, h), 0.02, generator))
            for f, h in zip(fans, self.hidden))

    def forward(self, adj_blk: torch.Tensor, x_blk: torch.Tensor) -> torch.Tensor:
        """The pooled [H] of the graph whose rows this rank holds: the sum
        of every rank's rows over the padded N, as JAX divides by the padded
        adjacency's size (the zero rows of the padding count in the mean)."""
        h = x_blk
        for w in self.kernels:
            h = sharded_graph_conv(adj_blk, h, w, self.mesh, self.axis,
                                   use_kernel=self.use_kernel)
        pooled = all_reduce(h.sum(0), self.mesh.get_group(self.axis))
        return pooled / adj_blk.shape[1]
