"""K1/K2: the third-order motif combine — the port of the TPU kernel
``fused_motif_combine`` (K1, snd_vae_tpu/nn/pallas/blocked_spmm.py:204) and
of its differentiable wrapper ``motif_combine`` (K2, :282).

  out[b,i,j,:] = A[b,i,j] * ( deg[b,j] * (a_i[b,i,:] + d_ij[b,i,j,:] + bias)
                              + v_j[b,j,:] + sum_k A[b,j,k] * f_ik[b,i,k,:] )

``fused_motif_combine`` launches ``csrc/motif_combine.cu`` on CUDA tensors
and counts the launch in ``fused_motif_combine.launches``; on CPU tensors,
and only there, it returns ``motif_combine_plain``.  ``motif_combine`` is a
``torch.autograd.Function`` whose forward is that wrapper and whose backward
is autograd through the plain version, as the JAX custom VJP takes the VJP
of its reference formula.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from ._launch import CUDA_DTYPES, check_inputs, raise_on_error, stream_handle

_SIGNATURES = {
    "motif_combine_launch": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # adj a_i d_ij v_j
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,                   # f_ik bias out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,              # batch n h dtype
        ctypes.c_void_p,                                                     # stream
    )
}


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    return torch.float32 if dt in (torch.bfloat16, torch.float16) else dt


def motif_combine_plain(adj, a_i, d_ij, v_j, f_ik, bias) -> torch.Tensor:
    """Plain PyTorch version (the JAX ``fused_motif_combine_reference``)."""
    deg = adj.sum(-1)
    acc = _acc_dtype(f_ik.dtype)
    wf = torch.einsum("bjk,bikh->bijh", adj.to(acc), f_ik.to(acc)).to(f_ik.dtype)
    out = (
        deg[:, None, :, None] * (a_i[:, :, None] + d_ij + bias)
        + v_j[:, None, :]
        + wf
    )
    return adj[..., None] * out


def _check_shapes(adj, a_i, d_ij, v_j, f_ik, bias) -> None:
    if adj.dim() != 3 or adj.shape[1] != adj.shape[2]:
        raise ValueError(f"motif_combine: adj must be [B,N,N], got {tuple(adj.shape)}")
    B, N = adj.shape[:2]
    h = bias.shape[-1] if bias.dim() == 1 else -1
    want = {"a_i": (B, N, h), "d_ij": (B, N, N, h), "v_j": (B, N, h),
            "f_ik": (B, N, N, h), "bias": (h,)}
    for name, t in (("a_i", a_i), ("d_ij", d_ij), ("v_j", v_j), ("f_ik", f_ik),
                    ("bias", bias)):
        if tuple(t.shape) != want[name]:
            raise ValueError(
                f"motif_combine: {name} has shape {tuple(t.shape)}, expected {want[name]}"
            )


def fused_motif_combine(adj, a_i, d_ij, v_j, f_ik, bias) -> torch.Tensor:
    """K1: adj [B,N,N]; a_i, v_j [B,N,h]; d_ij, f_ik [B,N,N,h]; bias [h];
    all of one dtype.  Output [B,N,N,h] in f_ik's dtype."""
    dev = check_inputs("motif_combine", adj=adj, a_i=a_i, d_ij=d_ij, v_j=v_j,
                       f_ik=f_ik, bias=bias)
    _check_shapes(adj, a_i, d_ij, v_j, f_ik, bias)
    if dev.type == "cpu":
        return motif_combine_plain(adj, a_i, d_ij, v_j, f_ik, bias)

    B, N = adj.shape[:2]
    h = bias.shape[0]
    out = torch.empty_like(f_ik)
    fn = build.load("motif_combine", _SIGNATURES).motif_combine_launch
    with torch.cuda.device(dev):
        code = fn(adj.data_ptr(), a_i.data_ptr(), d_ij.data_ptr(), v_j.data_ptr(),
                  f_ik.data_ptr(), bias.data_ptr(), out.data_ptr(), B, N, h,
                  CUDA_DTYPES[f_ik.dtype], stream_handle(dev))
    raise_on_error("motif_combine", code)
    fused_motif_combine.launches += 1
    return out


fused_motif_combine.launches = 0


class _MotifCombine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, adj, a_i, d_ij, v_j, f_ik, bias):
        ctx.save_for_backward(adj, a_i, d_ij, v_j, f_ik, bias)
        return fused_motif_combine(adj, a_i, d_ij, v_j, f_ik, bias)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        if not wanted:
            return (None,) * len(inputs)
        with torch.enable_grad():
            out = motif_combine_plain(*inputs)
        got = iter(torch.autograd.grad(out, wanted, grad))
        return tuple(next(got) if t.requires_grad else None for t in inputs)


def motif_combine(adj, a_i, d_ij, v_j, f_ik, bias) -> torch.Tensor:
    """K2: the differentiable motif combine (forward K1, backward autograd
    through the plain version)."""
    return _MotifCombine.apply(adj, a_i, d_ij, v_j, f_ik, bias)
