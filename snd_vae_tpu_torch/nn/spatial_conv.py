"""Spatial-motif graph convolutions — the port of
``snd_vae_tpu/nn/spatial_conv.py`` (reference layers.py:143-359).

The reference materializes [B,N,N,N,·] motif triples (third order) and
[B,N,N,N,N,·] quadruples (fourth order).  The JAX package factors the masked
motif sums into per-node terms, per-pair terms and masked matmuls (module
docstring there); this port keeps that factored, rank-R form.

Third order (``spatial_conv.py:116-260``): level 3 runs in the rank-R
arithmetic of the JAX default path (``:220-238``), with the j-only terms
folded into ``v_combined``, as one kernel from φ(rel) to the masked j-sum:

    nt = motif_level3(adj, φ(rel), a_i, v_combined, deg, M1d, M1f, bias1)

(``kernels.motif_level3``), so the forward builds no [B,N,N,h0] tensor.
``block_rows`` (JAX ``_blocked_nt``, ``:263-320``) keeps that forward and
makes its backward recompute level 3 one i-row block at a time.  Levels 2
and 1 are the rank-R reassociated sums of ``:240-260``.

Fourth order (``spatial_conv.py:358-637``, the protein and mnist
datasets): levels 4 and 3 are PyTorch ops, as XLA ops are in JAX — the JAX
package has no Pallas kernel there.  The [B,N,N,N,h0] ``m4_sum`` is built
in one buffer that the broadcast adds, the motif mask and lrelu update in
place, so autograd keeps one such tensor per layer (lrelu's output); its
masked k-sum is a batched matmul over that buffer as it lies.
``block_rows`` (``_blocked_nt_3d``, ``:565-637``) computes levels 4 and 3
one i-row block at a time under ``torch.utils.checkpoint``.  The level-4/3
tensors run in ``nn.ckpt.big`` regions (``sgc3.nd4``, ``sgc3.m4_sum``,
``sgc3.tm``, ``sgc3.m3_sum``, JAX's ``checkpoint_name`` tags) for the
``recompute-big`` remat policy.

Public layouts as in JAX: adj [B,N,N], x [B,N,F], rel [B,N,N,R] ->
[B,N,h_last].

Under the mesh's ``model`` axis (``parallel.hints``) both convs compute the
rows i of this rank (``hints.own_block``) and return [B,n,h_last]: level 3
(the K1 window of ``motif_level3``, or ``rows`` of the fourth order), then
levels 2 and 1 on those rows.  What level 3 reads for every node (adj,
φ(x), φ(rel), b_j, the neighbour sums nx / nr, deg; fourth order's beta_jk
and gamma_k) stays whole on every rank, so no collective runs inside a
conv: the model gathers each layer's rows (``parallel.batch.gather_nodes``)
before the next layer, whose b_j, nx and level 3 read every node.  The
JAX package hints the same sites with ``shard_nodes``
(``spatial_conv.py:208-252``, ``:502-544``).  ``rows=(start, n)`` computes
that window in one process, with no mesh: the rank-local computation as a
plain function.  Products accumulate in the inputs' dtype (JAX's
``_acc_dtype``: f32 for bf16 inputs, the input dtype otherwise; cuBLAS
accumulates bf16 products in f32).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as Fn
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import init as inits
from .basic import lrelu
from .ckpt import big
from .kernels.motif_level3 import motif_level3
from ..parallel.hints import own_block, shard_nodes

LEAK = 0.2


def _row_taker(n: int, rows: Optional[Tuple[int, int]]):
    """(start, size, take): the window of rows a conv computes and how it
    takes those rows of a [B,N,...] tensor — this rank's under the ambient
    model axis (``shard_nodes``, which reports the tag), or ``rows``.  A
    tensor that holds the window's rows already is taken as it is."""
    if rows is None:
        start, size = own_block(n)
        return start, size, lambda t, tag: shard_nodes(t, tag=tag, nodes=n)
    start, size = rows
    return start, size, lambda t, tag: t.narrow(1, start, size) if t.shape[1] == n else t


def _check_block_rows(block_rows: int, n: int) -> None:
    if n % block_rows != 0:
        raise ValueError(f"motif block_rows={block_rows} must divide num_nodes={n}")


class SpatialGraphConv(nn.Module):
    """Third-order spatial-motif conv.  Params as the reference's:
    Matrix1 [3F+3R, h0], Matrix2 [2F+R+h0, h1], Matrix3 [F+h1, h2]."""

    def __init__(self, in_features: int, rel_features: int,
                 hidden: Tuple[int, int, int], generator: torch.Generator,
                 stddev: float = 0.02, bias_start: float = 0.0,
                 block_rows: Optional[int] = None):
        super().__init__()
        F, R = in_features, rel_features
        h0, h1, h2 = hidden
        self.block_rows = block_rows
        self.Matrix1 = nn.Parameter(inits.normal((3 * F + 3 * R, h0), stddev, generator))
        self.bias1 = nn.Parameter(torch.full((h0,), float(bias_start)))
        self.Matrix2 = nn.Parameter(inits.normal((2 * F + R + h0, h1), stddev, generator))
        self.bias2 = nn.Parameter(torch.full((h1,), float(bias_start)))
        self.Matrix3 = nn.Parameter(inits.normal((F + h1, h2), stddev, generator))
        self.bias3 = nn.Parameter(torch.full((h2,), float(bias_start)))

    def forward(self, adj: torch.Tensor, x: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
        params = {k: getattr(self, k) for k in
                  ("Matrix1", "bias1", "Matrix2", "bias2", "Matrix3", "bias3")}
        return spatial_graph_conv(adj, x, rel, params, block_rows=self.block_rows)


def spatial_graph_conv(adj, x, rel, params: Dict[str, torch.Tensor],
                       block_rows: Optional[int] = None,
                       rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Functional factored third-order conv; level 3 through the
    ``motif_level3`` kernel (see the module docstring).  ``block_rows``
    must divide N; it changes only the backward's live set.  Returns the
    rows of this rank under a model axis, or the window ``rows`` =
    (start, n) when given: [B,n,h2]."""
    if block_rows is not None:
        _check_block_rows(block_rows, adj.shape[1])
    row0, _, take = _row_taker(adj.shape[1], rows)
    F, R = x.shape[-1], rel.shape[-1]
    m1, b1 = params["Matrix1"], params["bias1"]
    m2, b2 = params["Matrix2"], params["bias2"]
    m3, b3 = params["Matrix3"], params["bias3"]

    phi_x = lrelu(x)          # [B,N,F]
    phi_r = lrelu(rel)        # [B,N,N,R]

    px = take(phi_x, "sgc.x")                            # this window's rows
    # --- level 3: masked motif sum --------------------------------------
    a_i = px @ m1[0:F]                                   # φ(x_i)@M1a  [B,n,h0]
    b_j = phi_x @ m1[F:2 * F]                            # φ(x_j)@M1b  [B,N,h0]
    # neighbour sums of the raw inputs, reused across levels
    nx = torch.einsum("bjk,bkf->bjf", adj, phi_x)        # Σ_k A[j,k]·φ(x_k)
    nr = torch.einsum("bjk,bjkr->bjr", adj, phi_r)       # Σ_k A[j,k]·φ(rel)[j,k]
    deg = adj.sum(-1)                                    # [B,N]
    neigh_c = nx @ m1[2 * F:3 * F]                       # Σ_k A[j,k]·c_k
    ve = nr @ m1[3 * F + R:3 * F + 2 * R]                # Σ_k A[j,k]·e_jk
    v_combined = deg[..., None] * b_j + neigh_c + ve     # j-only terms
    # nt[i] = Σ_j A[i,j]·lrelu(m3_sum[i,j]), d_ij / f_ik folded in through
    # the R-row slices M1d = m1[3F:3F+R], M1f = m1[3F+2R:]; the K1 window of
    # this rank's rows i (rf, d_ij and m3_sum of those rows)        [B,n,h0]
    nt = motif_level3(adj.contiguous(), take(phi_r, "sgc.rf").contiguous(),
                      a_i.contiguous(), v_combined.contiguous(), deg.contiguous(),
                      m1[3 * F:3 * F + R].contiguous(), m1[3 * F + 2 * R:].contiguous(),
                      b1.contiguous(), block_rows=block_rows, row0=row0)

    # --- level 2: masked pair sum, reassociated --------------------------
    p_i = px @ m2[0:F]
    nq = take(nx, "sgc.nx") @ m2[F:2 * F]                # Σ_j A[i,j]·q_j
    m2_sum = (
        take(deg, "sgc.deg")[..., None] * (p_i + b2)
        + nq
        + take(nr, "sgc.nr") @ m2[2 * F:2 * F + R]
        + nt @ m2[2 * F + R:]
    )

    # --- level 1: per-node update ---------------------------------------
    return px @ m3[0:F] + lrelu(take(m2_sum, "sgc.m2_sum")) @ m3[F:] + b3


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


# ---------------------------------------------------------------------------
# Fourth order (3D datasets: protein, mnist) — reference layers.py:200-359
# ---------------------------------------------------------------------------

class SpatialGraphConv3D(nn.Module):
    """Fourth-order spatial-motif conv.  Params as the reference's
    (layers.py:210-225): Matrix0 [4F+3R+2Rd, h0], Matrix1 [3F+2R+h0+Rd, h1],
    Matrix2 [2F+R+h1, h2], Matrix3 [F+h2, h3], with Rd = ``rel_features``
    and R = Rd, or Rd + 1 for ``fully_connected`` (the reference's `_full`
    variant, layers.py:279-359: all-ones masks, rel := concat(rel, adj))."""

    def __init__(self, in_features: int, rel_features: int,
                 hidden: Tuple[int, int, int, int], generator: torch.Generator,
                 stddev: float = 0.02, bias_start: float = 0.0,
                 fully_connected: bool = False, block_rows: Optional[int] = None):
        super().__init__()
        F, Rd = in_features, rel_features
        R = Rd + (1 if fully_connected else 0)
        h0, h1, h2, h3 = hidden
        self.fully_connected, self.block_rows = fully_connected, block_rows
        shapes = (("Matrix0", (4 * F + 3 * R + 2 * Rd, h0)), ("bias0", (h0,)),
                  ("Matrix1", (3 * F + 2 * R + h0 + Rd, h1)), ("bias1", (h1,)),
                  ("Matrix2", (2 * F + R + h1, h2)), ("bias2", (h2,)),
                  ("Matrix3", (F + h2, h3)), ("bias3", (h3,)))
        for name, shape in shapes:
            value = (inits.normal(shape, stddev, generator) if name.startswith("Matrix")
                     else torch.full(shape, float(bias_start)))
            setattr(self, name, nn.Parameter(value))

    def forward(self, adj: torch.Tensor, x: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
        dis = rel
        if self.fully_connected:
            rel = torch.cat([rel, adj[..., None]], dim=-1)
        params = {k: getattr(self, k) for k in
                  ("Matrix0", "bias0", "Matrix1", "bias1", "Matrix2", "bias2",
                   "Matrix3", "bias3")}
        return spatial_graph_conv_3d(adj, x, rel, dis, params,
                                     fully_connected=self.fully_connected,
                                     block_rows=self.block_rows)


def _slices(m: torch.Tensor, widths: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """Consecutive row slices of ``m`` of the given widths, then the rest."""
    out, o = [], 0
    for w in widths:
        out.append(m[o:o + w])
        o += w
    return (*out, m[o:])


def spatial_graph_conv_3d(adj, x, rel, dis, params: Dict[str, torch.Tensor],
                          fully_connected: bool = False,
                          block_rows: Optional[int] = None,
                          rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Functional factored fourth-order conv (JAX ``spatial_conv.py:401-562``).

    ``rel`` feeds the chain relations (r_ij, r_jk, r_kp), ``dis`` the skip
    distances (d_ik, d_ip): the same tensor for the standard variant.
    ``block_rows`` (a divisor of N) computes levels 4 and 3 one i-row block
    at a time (``_blocked_nt_3d``); i-blocking reassociates no sum.  Returns
    the rows of this rank under a model axis, or the window ``rows``:
    [B,n,h3]."""
    if block_rows is not None:
        _check_block_rows(block_rows, adj.shape[1])
    _, _, take = _row_taker(adj.shape[1], rows)
    F, R, Rd = x.shape[-1], rel.shape[-1], dis.shape[-1]
    m0, b0 = params["Matrix0"], params["bias0"]
    m1, b1 = params["Matrix1"], params["bias1"]
    m2, b2 = params["Matrix2"], params["bias2"]
    m3, b3 = params["Matrix3"], params["bias3"]

    mask = torch.ones_like(adj) if fully_connected else adj
    deg = mask.sum(-1)                                   # [B,N]
    phi_x, phi_r, phi_d = lrelu(x), lrelu(rel), lrelu(dis)

    # neighbour sums of the raw inputs, reused at every level (rank-R:
    # masked node-sums contract against the R-channel inputs before the
    # R→h weight matmuls)
    mx = torch.einsum("bkp,bpf->bkf", mask, phi_x)       # Σ_p M[k,p]·φ(x_p)      [B,N,F]
    nr4 = torch.einsum("bkp,bkpr->bkr", mask, phi_r)     # Σ_p M[k,p]·φ(rel)[k,p] [B,N,R]

    # weight slices in the reference's column order (layers.py:210-225)
    m0_a, m0_b, m0_c, m0_p, m0_u, m0_v, m0_w, m0_y, m0_z, _ = _slices(
        m0, (F, F, F, F, R, R, R, Rd, Rd))
    m1_ci, m1_cj, m1_ck, m1_gij, m1_gjk, m1_gik, w_m4 = _slices(
        m1, (F, F, F, R, R, Rd))

    # level-4 and level-3 pieces that do not depend on i
    a_i = phi_x @ m0_a
    a_j = phi_x @ m0_b
    beta_jk = deg[:, None, :, None] * (a_j[:, :, None] + phi_r @ m0_v)   # [B,N,N,h0]
    gamma_k = deg[..., None] * (phi_x @ m0_c + b0) + mx @ m0_p + nr4 @ m0_w  # [B,N,h0]
    c_i = phi_x @ m1_ci
    c_j = phi_x @ m1_cj
    neigh_j = mx @ m1_ck + nr4 @ m1_gjk                  # Σ_k M[j,k]·(c_k + g_jk)

    def level3_rows(mask_i, pr, pd, ai, ci):
        """nt[i] = Σ_j M[i,j]·φ(m3_sum[i,j]) for the i rows given."""
        # level 4: m4[i,j,k] = M[i,j]·M[j,k]·(deg[k]·(a_i+a_j+u_ij+a_k+v_jk+y_ik+b0)
        #                                      + P[k] + Vw[k] + Wz[i,k])
        with big("sgc3.nd4"):
            nd4 = torch.einsum("bkp,bipr->bikr", mask, pd)   # Σ_p M[k,p]·φ(dis)[i,p]
        alpha_ik = deg[:, None, :, None] * (ai[:, :, None] + pd @ m0_y) + nd4 @ m0_z
        with big("sgc3.m4_sum"):
            m4 = deg[:, None, None, :, None] * (pr @ m0_u)[:, :, :, None, :]   # [B,b,N,N,h0]
            m4 += alpha_ik[:, :, None]
            m4 += beta_jk[:, None]
            m4 += gamma_k[:, None, None]
            m4 *= (mask_i[:, :, :, None] * mask[:, None])[..., None]       # M[i,j]·M[j,k]
            # level 3: the masked k-sum of φ(m4) before the h0→h1 matmul
            # (linearity in the weights), as a matmul over m4 as it lies
            Fn.leaky_relu_(m4, LEAK)
        with big("sgc3.tm"):
            tm = torch.matmul(mask[:, None, :, None, :], m4).squeeze(-2)   # [B,b,N,h0]
        with big("sgc3.m3_sum"):
            m3_sum = (
                deg[:, None, :, None] * (ci[:, :, None] + c_j[:, None, :] + pr @ m1_gij + b1)
                + neigh_j[:, None, :]
                + nd4 @ m1_gik
                + tm @ w_m4
            )
            m3_sum = mask_i[..., None] * m3_sum                             # [B,b,N,h1]
        return torch.einsum("bij,bijh->bih", mask_i, lrelu(m3_sum))

    # this window's rows i of what level 4 reads by i (the rest stays whole)
    row_inputs = tuple(take(t, tag) for t, tag in (
        (mask, "sgc3d.mask_i"), (phi_r, "sgc3d.phi_r"), (phi_d, "sgc3d.phi_d"),
        (a_i, "sgc3d.a_i"), (c_i, "sgc3d.c_i")))
    if block_rows is None:
        nt = level3_rows(*row_inputs)                                       # [B,n,h1]
    else:
        nt = _blocked_rows(level3_rows, row_inputs, block_rows)

    # --- level 2: fully reassociated as in the third-order op ------------
    m2_p, m2_q, m2_s, m2_t = _slices(m2, (F, F, R))
    px = take(phi_x, "sgc3d.x")
    m2_sum = (
        take(deg, "sgc3d.deg")[..., None] * (px @ m2_p + b2)
        + take(mx, "sgc3d.mx") @ m2_q
        + take(nr4, "sgc3d.nr4") @ m2_s
        + nt @ m2_t
    )

    # --- level 1 ---------------------------------------------------------
    return px @ m3[0:F] + lrelu(take(m2_sum, "sgc3d.m2_sum")) @ m3[F:] + b3


def _blocked_rows(fn: Callable[..., torch.Tensor], row_inputs: Sequence[torch.Tensor],
                  block_rows: int) -> torch.Tensor:
    """``fn`` of the i-row blocks of ``row_inputs`` (each [B,n,...]; the
    last block short where ``block_rows`` does not divide n, as in a
    rank's rows of an uneven split), concatenated on the row axis: the port
    of ``_blocked_nt_3d``'s checkpointed scan (JAX
    ``spatial_conv.py:565-637``).  Under autograd each
    block runs in ``torch.utils.checkpoint``: the forward keeps only the
    block outputs, and the backward recomputes one block's internals at a
    time.  Tensors ``fn`` closes over (``beta_jk`` [B,N,N,h0] the largest)
    stay resident across blocks, as in JAX."""
    n = row_inputs[0].shape[1]
    outs = []
    for s in range(0, n, block_rows):
        block = [t[:, s:s + block_rows] for t in row_inputs]
        outs.append(checkpoint(fn, *block, use_reentrant=False) if torch.is_grad_enabled()
                    else fn(*block))
    return torch.cat(outs, dim=1)


def spatial_graph_conv_3d_dense_oracle(adj, x, rel, dis, params,
                                       fully_connected: bool = False) -> torch.Tensor:
    """Literal reference formula (layers.py:200-277 / 279-359), the port of
    JAX ``spatial_conv.py:640-687``: O(B·N⁴·h) memory, for the tests at
    N ≤ 6 only."""
    B, N, F = x.shape
    R, Rd = rel.shape[-1], dis.shape[-1]
    m0, b0 = params["Matrix0"], params["bias0"]
    m1, b1 = params["Matrix1"], params["bias1"]
    m2, b2 = params["Matrix2"], params["bias2"]
    m3, b3 = params["Matrix3"], params["bias3"]
    mask = torch.ones_like(adj) if fully_connected else adj

    s4 = (B, N, N, N, N)
    m4_in = torch.cat([
        x[:, :, None, None, None, :].expand(*s4, F),      # x_i
        x[:, None, :, None, None, :].expand(*s4, F),      # x_j
        x[:, None, None, :, None, :].expand(*s4, F),      # x_k
        x[:, None, None, None, :, :].expand(*s4, F),      # x_p
        rel[:, :, :, None, None, :].expand(*s4, R),       # r_ij
        rel[:, None, :, :, None, :].expand(*s4, R),       # r_jk
        rel[:, None, None, :, :, :].expand(*s4, R),       # r_kp
        dis[:, :, None, :, None, :].expand(*s4, Rd),      # d_ik
        dis[:, :, None, None, :, :].expand(*s4, Rd),      # d_ip
    ], dim=-1)
    m4 = torch.einsum("bijkpf,fh->bijkph", lrelu(m4_in), m0) + b0
    mask4 = (mask[:, :, :, None, None] * mask[:, None, :, :, None]
             * mask[:, None, None, :, :])
    m4_sum = torch.einsum("bijkph,bijkp->bijkh", m4, mask4)

    s3 = (B, N, N, N)
    m3_in = torch.cat([
        x[:, :, None, None, :].expand(*s3, F),
        x[:, None, :, None, :].expand(*s3, F),
        x[:, None, None, :, :].expand(*s3, F),
        rel[:, :, :, None, :].expand(*s3, R),
        rel[:, None, :, :, :].expand(*s3, R),
        dis[:, :, None, :, :].expand(*s3, Rd),
        m4_sum,
    ], dim=-1)
    m3t = torch.einsum("bijkf,fh->bijkh", lrelu(m3_in), m1) + b1
    mask3 = mask[:, :, :, None] * mask[:, None, :, :]
    m3_sum = torch.einsum("bijkh,bijk->bijh", m3t, mask3)

    m2_in = torch.cat([x[:, :, None, :].expand(B, N, N, F),
                       x[:, None, :, :].expand(B, N, N, F), rel, m3_sum], dim=-1)
    m2t = torch.einsum("bijf,fh->bijh", lrelu(m2_in), m2) + b2
    m2_sum = torch.einsum("bijh,bij->bih", m2t, mask)

    m1_in = torch.cat([x, m2_sum], dim=-1)
    return torch.einsum("bif,fh->bih", lrelu(m1_in), m3) + b3
