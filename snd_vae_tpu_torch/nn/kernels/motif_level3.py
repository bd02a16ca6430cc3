"""Level 3 of the third-order motif conv in one kernel, in the rank-R
arithmetic of the JAX default path (snd_vae_tpu/nn/spatial_conv.py:220-238):

  rf[b,i,j,r] = sum_k A[b,j,k] * phi[b,i,k,r]
  m3[b,i,j,:] = A[b,i,j] * ( deg[b,j] * (a_i[b,i,:] + bias + sum_r phi[b,i,j,r] * M1d[r,:])
                             + v_j[b,j,:] + sum_r rf[b,i,j,r] * M1f[r,:] )
  nt[b,i,:]   = sum_j A[b,i,j] * lrelu(m3[b,i,j,:])

with phi = lrelu(rel), M1d / M1f the Matrix1 rows of the r_ij / r_ik slices,
and v_j the j-only terms.  It takes the place of the projections
d_ij / f_ik, the motif combine (``motif_combine``, the port of the TPU
kernel ``fused_motif_combine``), the lrelu and the nt einsum.

``fused_motif_level3`` launches ``csrc/motif_level3.cu`` on CUDA tensors and
counts the launch in ``fused_motif_level3.launches``; on CPU tensors, and
only there, it returns ``motif_level3_plain``.  With ``row0`` it computes a
window of rows i in [row0, row0 + n) of nt: φ(rel) and a_i are given for
those rows only ([B,n,N,R], [B,n,h]), A, v_j and deg whole; the rows of
the mesh's ``model`` axis are such windows, and the full launch is the
window (0, N).  ``motif_level3`` is the
differentiable entry point; its backward recomputes the plain level 3,
with ``block_rows`` one i-row block at a time (the port of JAX's
``_blocked_nt``, ``snd_vae_tpu/nn/spatial_conv.py:263-320``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from ..ckpt import big
from ._launch import CUDA_DTYPES, check_inputs, raise_on_error, stream_handle

_SIGNATURES = {
    "motif_level3_launch": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # adj phi a_i v_j
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # deg m1d m1f bias
        ctypes.c_void_p,                                                     # nt
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,              # batch n row0 rows
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                            # r h dtype
        ctypes.c_void_p,                                                     # stream
    )
}
LEAK = 0.2


def motif_level3_plain(adj, phi_r, a_i, v_j, deg, m1d, m1f, bias) -> torch.Tensor:
    """Plain PyTorch version of the formula in the module docstring; bf16 and
    f16 inputs are computed in f32 and the result cast back."""
    return _level3_rows(adj, adj, phi_r, a_i, v_j, deg, m1d, m1f, bias)


def _level3_rows(adj, adj_rows, phi_rows, a_rows, v_j, deg, m1d, m1f, bias) -> torch.Tensor:
    """nt for the i rows given: ``adj_rows``, ``phi_rows``, ``a_rows`` are
    rows [s, e) of adj, φ(rel) and a_i on their second axis; rf reads the
    whole A.  The j and k sums are row-local, so rows [s, e) of the full
    result are this, operation for operation.  The [B,b,N,·] tensors run in
    ``nn.ckpt.big`` regions (JAX's ``sgc.*`` tags)."""
    dt = adj.dtype
    if dt in (torch.bfloat16, torch.float16):
        adj, adj_rows, phi_rows, a_rows, v_j, deg, m1d, m1f, bias = (
            t.float() for t in (adj, adj_rows, phi_rows, a_rows, v_j, deg, m1d, m1f, bias))
    with big("sgc.rf"):
        rf = torch.einsum("bjk,bikr->bijr", adj, phi_rows)
    with big("sgc.d_ij"):
        d_ij = phi_rows @ m1d
    with big("sgc.wf"):
        wf = rf @ m1f
    with big("sgc.m3_sum"):
        m3 = deg[:, None, :, None] * (a_rows[:, :, None] + bias + d_ij) + v_j[:, None] + wf
        m3 = adj_rows[..., None] * m3
    nt = torch.einsum("bij,bijh->bih", adj_rows, torch.maximum(m3, LEAK * m3))
    return nt.to(dt)


def _check_shapes(adj, phi_r, a_i, v_j, deg, m1d, m1f, bias, row0: int) -> None:
    if adj.dim() != 3 or adj.shape[1] != adj.shape[2]:
        raise ValueError(f"motif_level3: adj must be [B,N,N], got {tuple(adj.shape)}")
    B, N = adj.shape[:2]
    R = phi_r.shape[-1] if phi_r.dim() == 4 else -1
    n = phi_r.shape[1] if phi_r.dim() == 4 else -1
    if row0 < 0 or row0 + n > N:
        raise ValueError(f"motif_level3: rows [{row0}, {row0 + n}) are not rows of N = {N}")
    h = bias.shape[-1] if bias.dim() == 1 else -1
    want = {"phi_r": (B, n, N, R), "a_i": (B, n, h), "v_j": (B, N, h), "deg": (B, N),
            "m1d": (R, h), "m1f": (R, h), "bias": (h,)}
    got = {"phi_r": phi_r, "a_i": a_i, "v_j": v_j, "deg": deg, "m1d": m1d, "m1f": m1f,
           "bias": bias}
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(
                f"motif_level3: {name} has shape {tuple(t.shape)}, expected {want[name]}"
            )


def fused_motif_level3(adj, phi_r, a_i, v_j, deg, m1d, m1f, bias, row0: int = 0) -> torch.Tensor:
    """adj [B,N,N]; phi_r [B,n,N,R] and a_i [B,n,h], rows [row0, row0 + n)
    of φ(rel) and a_i; v_j [B,N,h]; deg [B,N]; m1d, m1f [R,h]; bias [h]; all
    of one dtype.  Returns those rows of nt, [B,n,h], in that dtype."""
    dev = check_inputs("motif_level3", adj=adj, phi_r=phi_r, a_i=a_i, v_j=v_j, deg=deg,
                       m1d=m1d, m1f=m1f, bias=bias)
    _check_shapes(adj, phi_r, a_i, v_j, deg, m1d, m1f, bias, row0)
    B, n, N, R = phi_r.shape
    if dev.type == "cpu":
        return _level3_rows(adj, adj[:, row0:row0 + n], phi_r, a_i, v_j, deg, m1d, m1f, bias)

    h = bias.shape[0]
    nt = torch.empty_like(a_i)
    fn = build.load("motif_level3", _SIGNATURES).motif_level3_launch
    with torch.cuda.device(dev):
        code = fn(adj.data_ptr(), phi_r.data_ptr(), a_i.data_ptr(), v_j.data_ptr(),
                  deg.data_ptr(), m1d.data_ptr(), m1f.data_ptr(), bias.data_ptr(),
                  nt.data_ptr(), B, N, row0, n, R, h, CUDA_DTYPES[adj.dtype],
                  stream_handle(dev))
    raise_on_error("motif_level3", code)
    fused_motif_level3.launches += 1
    return nt


fused_motif_level3.launches = 0


class _MotifLevel3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block_rows, row0, *inputs):
        ctx.block_rows, ctx.row0 = block_rows, row0
        ctx.save_for_backward(*inputs)
        return fused_motif_level3(*inputs, row0)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        wanted = [t for t in inputs if t.requires_grad]
        if not wanted:
            return (None,) * (2 + len(inputs))
        adj, phi_r, a_i, *shared = inputs
        n, r0 = phi_r.shape[1], ctx.row0
        step = ctx.block_rows or n
        got = None
        for s in range(0, n, step):
            # one i-row block of the window's plain level 3, recomputed and dropped
            e = min(s + step, n)
            with torch.enable_grad():
                out = _level3_rows(adj, adj[:, r0 + s:r0 + e], phi_r[:, s:e], a_i[:, s:e],
                                   *shared)
            part = torch.autograd.grad(out, wanted, grad[:, s:e])
            got = part if got is None else [g + p for g, p in zip(got, part)]
        got = iter(got)
        return (None, None) + tuple(next(got) if t.requires_grad else None for t in inputs)


def motif_level3(adj, phi_r, a_i, v_j, deg, m1d, m1f, bias,
                 block_rows: Optional[int] = None, row0: int = 0) -> torch.Tensor:
    """The differentiable level 3 of the window of rows [row0, row0 + n)
    that ``phi_r`` and ``a_i`` hold (all N by default): forward
    ``fused_motif_level3``, backward autograd through the plain version.
    The forward saves only its inputs, so the backward recomputes rf and m3
    ([B,n,N,R] and [B,n,N,h]) rather than keeping m3 from the forward: the
    kernel never writes it.  With ``block_rows`` it recomputes them one
    i-row block of the window at a time, [B,block_rows,N,·] (the last block
    short where block_rows does not divide n), summing the blocks'
    gradients; the forward is one launch either way."""
    return _MotifLevel3.apply(block_rows, row0, adj, phi_r, a_i, v_j, deg, m1d, m1f, bias)
