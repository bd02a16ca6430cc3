"""K3: ``act(A @ X)`` with a fused leaky-ReLU epilogue — the port of the TPU
kernel ``blocked_adj_matmul`` (snd_vae_tpu/nn/pallas/blocked_spmm.py:89).

``blocked_adj_matmul`` launches ``csrc/adj_matmul.cu`` on CUDA tensors and
counts the launch in ``blocked_adj_matmul.launches``; on CPU tensors, and
only there, it returns ``adj_matmul_plain``.  ``adj_matmul`` is a
``torch.autograd.Function`` whose forward is that wrapper and whose backward
is autograd through the plain version (the kernel writes a fresh buffer, so
without it nothing upstream would get a gradient).  ``GraphConv`` computes
its ``lrelu(A @ (X W))`` through ``adj_matmul``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from ._launch import CUDA_DTYPES, check_inputs, raise_on_error, stream_handle

_SIGNATURES = {
    "adj_matmul_launch": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,            # a, x, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,        # batch, n, m, h
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,                # batch strides
        ctypes.c_float, ctypes.c_int, ctypes.c_int,                    # leak, has_leak, dtype
        ctypes.c_void_p,                                               # stream
    )
}


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    return torch.float32 if dt in (torch.bfloat16, torch.float16) else dt


def adj_matmul_plain(adj: torch.Tensor, x: torch.Tensor,
                     leak: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version (the JAX ``adj_matmul_reference``): the product
    accumulated in at least f32, cast to x's dtype, then max(y, leak*y)."""
    acc = _acc_dtype(x.dtype)
    out = torch.matmul(adj.to(acc), x.to(acc)).to(x.dtype)
    if leak is not None:
        out = torch.maximum(out, leak * out)
    return out


def blocked_adj_matmul(adj: torch.Tensor, x: torch.Tensor,
                       leak: Optional[float] = None) -> torch.Tensor:
    """K3: [N,M] @ [M,H], or batched [B,N,M] @ [B,M,H]; ``leak`` fuses
    max(y, leak*y).  Output in x's dtype."""
    dev = check_inputs("adj_matmul", adj=adj, x=x)
    if adj.dim() not in (2, 3) or x.dim() != adj.dim():
        raise ValueError(
            f"adj_matmul: expected [N,M]@[M,H] or [B,N,M]@[B,M,H], got "
            f"{tuple(adj.shape)} @ {tuple(x.shape)}"
        )
    if adj.shape[-1] != x.shape[-2] or adj.shape[:-2] != x.shape[:-2]:
        raise ValueError(
            f"adj_matmul: shapes {tuple(adj.shape)} and {tuple(x.shape)} do not chain"
        )
    if dev.type == "cpu":
        return adj_matmul_plain(adj, x, leak)

    n, m = adj.shape[-2:]
    h = x.shape[-1]
    batch = adj.shape[0] if adj.dim() == 3 else 1
    out = torch.empty(adj.shape[:-1] + (h,), dtype=x.dtype, device=dev)
    fn = build.load("adj_matmul", _SIGNATURES).adj_matmul_launch
    with torch.cuda.device(dev):
        code = fn(adj.data_ptr(), x.data_ptr(), out.data_ptr(), batch, n, m, h,
                  n * m, m * h, n * h, 0.0 if leak is None else float(leak),
                  int(leak is not None), CUDA_DTYPES[x.dtype], stream_handle(dev))
    raise_on_error("adj_matmul", code)
    blocked_adj_matmul.launches += 1
    return out


blocked_adj_matmul.launches = 0


class _AdjMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, adj, x, leak):
        ctx.save_for_backward(adj, x)
        ctx.leak = leak
        return blocked_adj_matmul(adj, x, leak)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        if not wanted:
            return None, None, None
        with torch.enable_grad():
            out = adj_matmul_plain(*inputs, ctx.leak)
        got = iter(torch.autograd.grad(out, wanted, grad))
        return tuple(next(got) if t.requires_grad else None for t in inputs) + (None,)


def adj_matmul(adj: torch.Tensor, x: torch.Tensor,
               leak: Optional[float] = None) -> torch.Tensor:
    """The differentiable A @ X (+ lrelu): forward K3, backward autograd
    through the plain version."""
    return _AdjMatmul.apply(adj, x, leak)
