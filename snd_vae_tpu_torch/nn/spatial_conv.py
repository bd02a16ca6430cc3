"""Third-order spatial-motif graph convolution — the port of
``snd_vae_tpu/nn/spatial_conv.py:116-260`` (reference layers.py:143-198).

The reference materializes [B,N,N,N,·] motif triples.  The JAX package
factors the masked motif sum into per-node terms, per-pair terms and masked
matmuls (module docstring there); this port keeps that factored form and
computes level 3 in the rank-R arithmetic of the JAX default path
(``spatial_conv.py:220-238``), with the j-only terms folded into
``v_combined``, as one kernel from φ(rel) to the masked j-sum:

    nt = motif_level3(adj, φ(rel), a_i, v_combined, deg, M1d, M1f, bias1)

(``kernels.motif_level3``), so no [B,N,N,h0] tensor is built.  Levels 2 and
1 are the rank-R reassociated sums of ``spatial_conv.py:240-260``.  Public
layouts as in JAX: adj [B,N,N], x [B,N,F], rel [B,N,N,R] -> [B,N,h2].
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from . import init as inits
from .basic import lrelu
from .kernels.motif_level3 import motif_level3


class SpatialGraphConv(nn.Module):
    """Third-order spatial-motif conv.  Params as the reference's:
    Matrix1 [3F+3R, h0], Matrix2 [2F+R+h0, h1], Matrix3 [F+h1, h2]."""

    def __init__(self, in_features: int, rel_features: int,
                 hidden: Tuple[int, int, int], generator: torch.Generator,
                 stddev: float = 0.02, bias_start: float = 0.0,
                 block_rows: Optional[int] = None):
        super().__init__()
        if block_rows is not None:
            raise NotImplementedError(
                "the blocked streamed lowering (motif_block_rows) is not ported yet"
            )
        F, R = in_features, rel_features
        h0, h1, h2 = hidden
        self.Matrix1 = nn.Parameter(inits.normal((3 * F + 3 * R, h0), stddev, generator))
        self.bias1 = nn.Parameter(torch.full((h0,), float(bias_start)))
        self.Matrix2 = nn.Parameter(inits.normal((2 * F + R + h0, h1), stddev, generator))
        self.bias2 = nn.Parameter(torch.full((h1,), float(bias_start)))
        self.Matrix3 = nn.Parameter(inits.normal((F + h1, h2), stddev, generator))
        self.bias3 = nn.Parameter(torch.full((h2,), float(bias_start)))

    def forward(self, adj: torch.Tensor, x: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
        params = {k: getattr(self, k) for k in
                  ("Matrix1", "bias1", "Matrix2", "bias2", "Matrix3", "bias3")}
        return spatial_graph_conv(adj, x, rel, params)


def spatial_graph_conv(adj, x, rel, params: Dict[str, torch.Tensor],
                       block_rows: Optional[int] = None) -> torch.Tensor:
    """Functional factored third-order conv; level 3 through the
    ``motif_level3`` kernel (see the module docstring)."""
    if block_rows is not None:
        raise NotImplementedError(
            "the blocked streamed lowering (block_rows) is not ported yet"
        )
    F, R = x.shape[-1], rel.shape[-1]
    m1, b1 = params["Matrix1"], params["bias1"]
    m2, b2 = params["Matrix2"], params["bias2"]
    m3, b3 = params["Matrix3"], params["bias3"]

    phi_x = lrelu(x)          # [B,N,F]
    phi_r = lrelu(rel)        # [B,N,N,R]

    # --- level 3: masked motif sum --------------------------------------
    a_i = phi_x @ m1[0:F]                                # φ(x_i)@M1a  [B,N,h0]
    b_j = phi_x @ m1[F:2 * F]                            # φ(x_j)@M1b  [B,N,h0]
    # neighbour sums of the raw inputs, reused across levels
    nx = torch.einsum("bjk,bkf->bjf", adj, phi_x)        # Σ_k A[j,k]·φ(x_k)
    nr = torch.einsum("bjk,bjkr->bjr", adj, phi_r)       # Σ_k A[j,k]·φ(rel)[j,k]
    deg = adj.sum(-1)                                    # [B,N]
    neigh_c = nx @ m1[2 * F:3 * F]                       # Σ_k A[j,k]·c_k
    ve = nr @ m1[3 * F + R:3 * F + 2 * R]                # Σ_k A[j,k]·e_jk
    v_combined = deg[..., None] * b_j + neigh_c + ve     # j-only terms
    # nt[i] = Σ_j A[i,j]·lrelu(m3_sum[i,j]), d_ij / f_ik folded in through
    # the R-row slices M1d = m1[3F:3F+R], M1f = m1[3F+2R:]          [B,N,h0]
    nt = motif_level3(adj.contiguous(), phi_r.contiguous(), a_i.contiguous(),
                      v_combined.contiguous(), deg.contiguous(),
                      m1[3 * F:3 * F + R].contiguous(), m1[3 * F + 2 * R:].contiguous(),
                      b1.contiguous())

    # --- level 2: masked pair sum, reassociated --------------------------
    p_i = phi_x @ m2[0:F]
    nq = nx @ m2[F:2 * F]                                # Σ_j A[i,j]·q_j
    m2_sum = (
        deg[..., None] * (p_i + b2)
        + nq
        + nr @ m2[2 * F:2 * F + R]
        + nt @ m2[2 * F + R:]
    )

    # --- level 1: per-node update ---------------------------------------
    return phi_x @ m3[0:F] + lrelu(m2_sum) @ m3[F:] + b3


def spatial_graph_conv_dense_oracle(adj, x, rel, params) -> torch.Tensor:
    """Literal re-materialization of the reference formula (layers.py:143-198)
    for the tests: O(B·N³·h) memory, tiny shapes only."""
    B, N, F = x.shape
    R = rel.shape[-1]
    m1, b1 = params["Matrix1"], params["bias1"]
    m2, b2 = params["Matrix2"], params["bias2"]
    m3, b3 = params["Matrix3"], params["bias3"]

    xi = x[:, :, None, None, :].expand(B, N, N, N, F)
    xj = x[:, None, :, None, :].expand(B, N, N, N, F)
    xk = x[:, None, None, :, :].expand(B, N, N, N, F)
    rij = rel[:, :, :, None, :].expand(B, N, N, N, R)
    rjk = rel[:, None, :, :, :].expand(B, N, N, N, R)
    rik = rel[:, :, None, :, :].expand(B, N, N, N, R)
    m3_in = torch.cat([xi, xj, xk, rij, rjk, rik], dim=-1)
    m3t = torch.einsum("bijkf,fh->bijkh", lrelu(m3_in), m1) + b1
    adj3 = adj[:, :, :, None] * adj[:, None, :, :]
    m3_sum = torch.einsum("bijkh,bijk->bijh", m3t, adj3)

    xi2 = x[:, :, None, :].expand(B, N, N, F)
    xj2 = x[:, None, :, :].expand(B, N, N, F)
    m2_in = torch.cat([xi2, xj2, rel, m3_sum], dim=-1)
    m2t = torch.einsum("bijf,fh->bijh", lrelu(m2_in), m2) + b2
    m2_sum = torch.einsum("bijh,bij->bih", m2t, adj)

    m1_in = torch.cat([x, m2_sum], dim=-1)
    return torch.einsum("bif,fh->bih", lrelu(m1_in), m3) + b3
