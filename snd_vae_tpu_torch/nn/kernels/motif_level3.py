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
window (0, N).  ``motif_level3`` is the differentiable entry point.

Its backward (the port of JAX's custom VJP ``motif_combine``,
``snd_vae_tpu/nn/pallas/blocked_spmm.py:281-301``) is the closed form of
the gradient.  With g = ∂L/∂nt and lrelu'(x) = 1 for x > 0, 0.2 otherwise:

  P[i,j,:]    = g[i] * A[i,j]^2 * lrelu'(m3[i,j,:])
  ∂a_i[i]     = Σ_j deg[j] P[i,j]            ∂v_j[j] = Σ_i P[i,j]
  ∂deg[j]     = Σ_{i,h} P[i,j,h] (a_i + bias + φ M1d)[i,j,h]
  ∂M1d        = Σ φ ⊗ (deg P)   ∂M1f = Σ rf ⊗ P   ∂bias = Σ deg P
  gd, grf     = (deg P) M1d^T, P M1f^T                        [.,n,N,R]
  ∂φ[i,k,r]   = gd[i,k,r] + Σ_j A[j,k] grf[i,j,r]
  ∂A[j,k]     = Σ_{i,r} grf[i,j,r] φ[i,k,r]
                + on the window's rows i: Σ_h g lrelu(m3) + A Σ_h lrelu'(m3) g c

(c the bracket of m3).  ``fused_motif_level3_backward`` launches
``csrc/motif_level3_backward.cu`` on CUDA tensors (one kernel on the
model's path, a second only when ∂A or ∂φ is asked) as
``motif_level3_backward_plan`` lays it out, and counts each call in
``fused_motif_level3_backward.launches``; on CPU tensors, and only there,
it returns ``motif_level3_backward_plain``, the closed form as PyTorch ops,
with ``block_rows`` one i-row block at a time (the port of JAX's
``_blocked_nt``, ``snd_vae_tpu/nn/spatial_conv.py:263-320``).  Both
compute only the gradients asked for.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from . import build
from ..ckpt import big
from ._launch import (CUDA_DTYPES, check_inputs, election_counters, raise_on_error,
                      stream_handle)

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
_BACKWARD_SIGNATURES = {
    "motif_level3_backward_launch": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # adj phi a_i v_j
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # deg m1d m1f bias
        ctypes.c_void_p,                                                     # grad of nt
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # d: adj phi a_i v_j
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # d: deg m1d m1f bias
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,                   # gd grf loc (f32)
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # pdeg pv pp counter
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,              # batch n row0 rows
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,              # r h tiles clusters
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                            # cluster h_chunk cols4
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,                         # flags dtype stream
    )
}
LEAK = 0.2
NAMES = ("adj", "phi_r", "a_i", "v_j", "deg", "m1d", "m1f", "bias")
# The backward kernel's sizes, mirrored from csrc/motif_level3_backward.cu,
# whose launch refuses a plan that does not match them.
ROW_TILE = 8            # rows i per row tile, one warp each (kTi)
MAX_CLUSTER = 4         # a tree of at most this many row tiles is one cluster (kMaxCluster),
SPLIT_CLUSTER = 2       # a larger one clusters of this many blocks (kSplitCluster)


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


def motif_level3_backward_plain(grad, adj, phi_r, a_i, v_j, deg, m1d, m1f, bias,
                                row0: int = 0, needs=(True,) * 8,
                                block_rows: Optional[int] = None) -> tuple:
    """The gradients of ``motif_level3``'s eight inputs (``NAMES``) for
    ``grad`` = ∂L/∂nt [B,n,h], in the closed form of the module docstring,
    as PyTorch ops (not autograd through the forward); None where ``needs``
    is False.  bf16 and f16 inputs are computed in f32 and the results cast
    back.  ``block_rows`` recomputes rf, m3 and P ([B,block_rows,N,·]) one
    i-row block of the window at a time, the last block short where it does
    not divide n."""
    dt = adj.dtype
    if dt in (torch.bfloat16, torch.float16):
        grad, adj, phi_r, a_i, v_j, deg, m1d, m1f, bias = (
            t.float() for t in (grad, adj, phi_r, a_i, v_j, deg, m1d, m1f, bias))
    need = dict(zip(NAMES, needs))
    n = phi_r.shape[1]
    out = {k: torch.zeros_like(t) for k, t in
           zip(NAMES, (adj, phi_r, a_i, v_j, deg, m1d, m1f, bias)) if need[k]}
    step = block_rows or n
    for s in range(0, n, step):
        e = min(s + step, n)
        a_r, phi, g = adj[:, row0 + s:row0 + e], phi_r[:, s:e], grad[:, s:e]
        rf = torch.einsum("bjk,bikr->bijr", adj, phi)
        base = a_i[:, s:e, None] + bias + phi @ m1d                 # a_i + bias + d_ij
        c = deg[:, None, :, None] * base + v_j[:, None] + rf @ m1f
        slope = torch.full_like(c, LEAK).masked_fill_(a_r[..., None] * c > 0, 1.0)
        p = g[:, :, None] * (a_r * a_r)[..., None] * slope
        dp = deg[:, None, :, None] * p
        if need["a_i"]:
            out["a_i"][:, s:e] = dp.sum(2)
        if need["v_j"]:
            out["v_j"] += p.sum(1)
        if need["deg"]:
            out["deg"] += (p * base).sum((1, 3))
        if need["m1d"]:
            out["m1d"] += torch.einsum("bijr,bijh->rh", phi, dp)
        if need["m1f"]:
            out["m1f"] += torch.einsum("bijr,bijh->rh", rf, p)
        if need["bias"]:
            out["bias"] += dp.sum((0, 1, 2))
        if need["phi_r"] or need["adj"]:
            grf = p @ m1f.T
        if need["phi_r"]:
            out["phi_r"][:, s:e] = dp @ m1d.T + torch.einsum("bjk,bijr->bikr", adj, grf)
        if need["adj"]:
            gs = g[:, :, None]
            out["adj"][:, row0 + s:row0 + e] += ((gs * a_r[..., None] * c * slope).sum(-1)
                                                 + a_r * (gs * slope * c).sum(-1))
            out["adj"] += torch.einsum("bijr,bikr->bjk", grf, phi)
    return tuple(out[k].to(dt) if k in out else None for k in NAMES)


@dataclass(frozen=True)
class Level3BackwardPlan:
    """One call of csrc/motif_level3_backward.cu for B trees of N nodes, a
    window of ``rows`` rows, R channels, h columns and the gradients
    ``needs`` asks for.  The window's rows fall in ``tiles`` row tiles of
    ``ROW_TILE``, one a block; a tree's blocks form ``clusters``
    thread-block clusters of ``cluster`` blocks: one cluster where ``tiles``
    <= ``MAX_CLUSTER``, else clusters of ``SPLIT_CLUSTER``,
    block q of the tree taking row tile q (``rows_of``; a cluster's last
    block may have none).  ``h_chunk`` columns of h per pass (one per lane
    in the model's instance where h <= 32), ``cols`` columns of the
    per-cluster parameter partials ((2R + 1)·h rounded up to 4, for 16-byte
    loads).  ``scratch``: the f32 buffers by name and shape (gd, grf, loc,
    pdeg, pv, pp), only those the gradients asked for need; ``counters``:
    the election counters the launch takes, 0 where it elects no block, 1
    for the sums over trees, 1 + B·cluster where a tree's clusters are
    summed too (one per tree and rank).
    ``kernels``: 1, or 2 where ∂A or ∂φ is asked."""

    rows: int
    tiles: int
    clusters: int
    cluster: int
    h_chunk: int
    cols: int
    kernels: int
    counters: int
    scratch: Dict[str, Tuple[int, ...]]

    def rows_of(self, block: int) -> list:
        """The window's rows that block ``block`` of a tree (``clusters`` ×
        ``cluster`` of them, cluster by cluster) takes: its row tile."""
        return list(range(block * ROW_TILE, min((block + 1) * ROW_TILE, self.rows)))


def motif_level3_backward_plan(batch: int, n: int, rows: int, r: int, h: int,
                               needs=(True,) * 8) -> Level3BackwardPlan:
    """The launch plan of ``fused_motif_level3_backward`` (pure Python)."""
    need = dict(zip(NAMES, needs))
    model = n <= 32 and r == 1 and h <= 64     # the kernel's instance for the model
    tiles = -(-rows // ROW_TILE)
    clusters = 1 if tiles <= MAX_CLUSTER else -(-tiles // SPLIT_CLUSTER)
    cluster = max(1, -(-tiles // clusters))
    params = need["m1d"] or need["m1f"] or need["bias"]
    tree_sum = clusters > 1 and (need["v_j"] or need["deg"])
    cols = -(-(2 * r + 1) * h // 4) * 4
    shapes = {"gd": (need["phi_r"], (batch, rows, n, r)),
              "grf": (need["phi_r"] or need["adj"], (batch, rows, n, r)),
              "loc": (need["adj"], (batch, rows, n)),
              "pdeg": (need["deg"], (batch, clusters, n)),
              "pv": (need["v_j"] and clusters > 1, (batch, clusters, n, h)),
              "pp": (params, (batch, clusters, cols))}
    return Level3BackwardPlan(
        rows=rows, tiles=tiles, clusters=clusters, cluster=cluster,
        h_chunk=32 if model and h <= 32 else 64, cols=cols,
        kernels=2 if need["adj"] or need["phi_r"] else 1,
        counters=(1 + batch * cluster if tree_sum else 1) if params or tree_sum else 0,
        scratch={k: shape for k, (cond, shape) in shapes.items() if cond})


def fused_motif_level3_backward(grad, adj, phi_r, a_i, v_j, deg, m1d, m1f, bias,
                                row0: int = 0, needs=(True,) * 8,
                                block_rows: Optional[int] = None) -> tuple:
    """The gradients of ``fused_motif_level3``'s eight inputs (``NAMES``)
    for ``grad`` = ∂L/∂nt of the window's rows [B,n,h], each in its input's
    dtype, None where ``needs`` is False.  On CUDA tensors:
    ``csrc/motif_level3_backward.cu`` as ``motif_level3_backward_plan``
    lays it out (one kernel, two where ∂A or ∂φ is asked; one count), which
    keeps no [B,n,N,h] tensor, so ``block_rows`` does not apply; on CPU
    tensors ``motif_level3_backward_plain``."""
    dev = check_inputs("motif_level3_backward", grad=grad, adj=adj, phi_r=phi_r, a_i=a_i,
                       v_j=v_j, deg=deg, m1d=m1d, m1f=m1f, bias=bias)
    _check_shapes(adj, phi_r, a_i, v_j, deg, m1d, m1f, bias, row0)
    if grad.shape != a_i.shape:
        raise ValueError(f"motif_level3_backward: grad has shape {tuple(grad.shape)}, "
                         f"expected {tuple(a_i.shape)}")
    if dev.type == "cpu":
        return motif_level3_backward_plain(grad, adj, phi_r, a_i, v_j, deg, m1d, m1f, bias,
                                           row0, needs, block_rows)

    B, n, N, R = phi_r.shape
    h = bias.shape[0]
    inputs = (adj, phi_r, a_i, v_j, deg, m1d, m1f, bias)
    need = dict(zip(NAMES, needs))
    if not any(needs) or B * n * N * h == 0:
        return tuple(torch.zeros_like(t) if need[k] else None for k, t in zip(NAMES, inputs))
    plan = motif_level3_backward_plan(B, N, n, R, h, needs)
    # every gradient asked for is written whole
    grads = {k: torch.empty_like(t) for k, t in zip(NAMES, inputs) if need[k]}
    scratch = {k: torch.empty(*shape, dtype=torch.float32, device=dev)
               for k, shape in plan.scratch.items()}
    stream = stream_handle(dev)
    counter = (election_counters("motif_level3_backward", dev, stream, plan.counters)
               if plan.counters else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    flags = sum(1 << i for i, k in enumerate(NAMES) if need[k])
    fn = build.load("motif_level3_backward", _BACKWARD_SIGNATURES).motif_level3_backward_launch
    with torch.cuda.device(dev):
        code = fn(*(t.data_ptr() for t in inputs), grad.data_ptr(),
                  *(ptr(grads.get(k)) for k in NAMES),
                  *(ptr(scratch.get(k)) for k in ("gd", "grf", "loc", "pdeg", "pv", "pp")),
                  ptr(counter), B, N, row0, n, R, h, plan.tiles, plan.clusters, plan.cluster,
                  plan.h_chunk, plan.cols, flags, CUDA_DTYPES[adj.dtype], stream)
    raise_on_error("motif_level3_backward", code)
    fused_motif_level3_backward.launches += 1
    return tuple(grads.get(k) for k in NAMES)


fused_motif_level3_backward.launches = 0


class _MotifLevel3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block_rows, row0, *inputs):
        ctx.block_rows, ctx.row0 = block_rows, row0
        ctx.save_for_backward(*inputs)
        return fused_motif_level3(*inputs, row0)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[2:]
        if not any(needs):
            return (None,) * (2 + len(needs))
        return (None, None) + fused_motif_level3_backward(
            grad.contiguous(), *ctx.saved_tensors, row0=ctx.row0, needs=needs,
            block_rows=ctx.block_rows)


def motif_level3(adj, phi_r, a_i, v_j, deg, m1d, m1f, bias,
                 block_rows: Optional[int] = None, row0: int = 0) -> torch.Tensor:
    """The differentiable level 3 of the window of rows [row0, row0 + n)
    that ``phi_r`` and ``a_i`` hold (all N by default): forward
    ``fused_motif_level3``, backward ``fused_motif_level3_backward`` for the
    inputs that need a gradient.  The forward saves only its inputs, so the
    backward recomputes rf and m3: the kernel in registers and shared
    memory, the CPU's closed form as [B,n,N,·] tensors, or with
    ``block_rows`` one i-row block of the window at a time,
    [B,block_rows,N,·]; the forward is one launch either way."""
    return _MotifLevel3.apply(block_rows, row0, adj, phi_r, a_i, v_j, deg, m1d, m1f, bias)
