"""Level 4 of the fourth-order motif conv and its masked k-sum in one
kernel (K4), without the [B,n,N,N,h] tensor m4:

  z[b,i,j,k,:] = M[b,i,j] * M[b,j,k] * ( deg[b,k] * pu[b,i,j,:] + alpha[b,i,k,:]
                                         + beta[b,j,k,:] + gamma[b,k,:] )
  tm[b,i,j,:]  = sum_k M[b,j,k] * lrelu(z[b,i,j,k,:])

for the rows i of a window: ``mask_i`` [B,n,N] holds those rows of the mask
M [B,N,N] (all N by default, a rank's rows under the mesh's ``model`` axis,
one block under ``block_rows``), and pu, alpha their rows [B,n,N,h]; M,
deg [B,N], beta [B,N,N,h] and gamma [B,N,h] stay whole.  The names are
those of ``nn/spatial_conv.py``'s ``level3_rows``: pu = φ(rel) @ M0_u, and
alpha, beta, gamma the i-k, j-k and k terms.  The JAX package has no
kernel here (XLA runs level 4, ``snd_vae_tpu/nn/spatial_conv.py:401-562``).

``fused_motif_level4`` launches ``csrc/motif_level4.cu`` on CUDA tensors
and counts the launch in ``fused_motif_level4.launches``; on CPU tensors,
and only there, it returns ``motif_level4_plain``, the chain of PyTorch
ops the port ran before the kernel.  ``motif_level4`` is the
differentiable entry point; its forward saves only its inputs.

Its backward is the closed form of the gradient.  With g = ∂L/∂tm and
lrelu'(x) = 1 for x > 0, 0.2 otherwise (PyTorch's leaky_relu backward):

  P[i,j,k,:]  = (M[j,k] g[i,j,:]) * lrelu'(z[i,j,k,:]) * (M[i,j] M[j,k])
  ∂pu[i,j]    = Σ_k deg[k] P[i,j,k]          ∂alpha[i,k] = Σ_j P[i,j,k]
  ∂beta[j,k]  = Σ_{i of the window} P[i,j,k]   ∂gamma[k] = Σ_{i,j} P[i,j,k]

The masks and deg are data: they take no gradient, and ``motif_level4``
raises where one requires it.  ``fused_motif_level4_backward`` launches
``csrc/motif_level4_backward.cu`` on CUDA tensors (one launch, each
gradient element summed by one owner lane in a fixed order, no atomics)
and counts it in ``fused_motif_level4_backward.launches``; on CPU tensors
it returns ``motif_level4_backward_plain``, the closed form as PyTorch ops.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as Fn

from . import build
from ..ckpt import big
from ._launch import CUDA_DTYPES, check_inputs, raise_on_error, stream_handle

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "motif_level4_launch": (
        _P, _P, _P, _P, _P, _P, _P,             # mask_i mask deg pu alpha beta gamma
        _P,                                     # tm
        _I, _I, _I, _I, _I,                     # batch n rows h dtype
        _P,                                     # stream
    )
}
_BACKWARD_SIGNATURES = {
    "motif_level4_backward_launch": (
        _P, _P, _P, _P, _P, _P, _P,             # mask_i mask deg pu alpha beta gamma
        _P,                                     # grad of tm
        _P, _P, _P, _P,                         # d: pu alpha beta gamma
        _I, _I, _I, _I, _I,                     # batch n rows h dtype
        _P,                                     # stream
    )
}
LEAK = 0.2
NAMES = ("mask_i", "mask", "deg", "pu", "alpha", "beta", "gamma")
DATA = ("mask_i", "mask", "deg")        # take no gradient


def _f32(ts):
    """bf16 and f16 tensors in f32 (the kernel's arithmetic), others as given."""
    return [t.float() if t.dtype in (torch.bfloat16, torch.float16) else t for t in ts]


def motif_level4_plain(mask_i, mask, deg, pu, alpha, beta, gamma) -> torch.Tensor:
    """The formula of the module docstring as the PyTorch chain: m4
    [B,n,N,N,h] built in one buffer that the broadcast adds, the mask
    product and lrelu update in place, then the masked k-sum as a matmul
    over m4 as it lies.  bf16 and f16 inputs are computed in f32 and the
    result cast back."""
    dt = pu.dtype
    mask_i, mask, deg, pu, alpha, beta, gamma = _f32(
        (mask_i, mask, deg, pu, alpha, beta, gamma))
    with big("sgc3.m4_sum"):
        m4 = deg[:, None, None, :, None] * pu[:, :, :, None, :]          # [B,n,N,N,h]
        m4 += alpha[:, :, None]
        m4 += beta[:, None]
        m4 += gamma[:, None, None]
        m4 *= (mask_i[:, :, :, None] * mask[:, None])[..., None]        # M[i,j]·M[j,k]
        Fn.leaky_relu_(m4, LEAK)
    return torch.matmul(mask[:, None, :, None, :], m4).squeeze(-2).to(dt)


def motif_level4_backward_plain(grad, mask_i, mask, deg, pu, alpha, beta, gamma) -> tuple:
    """(∂pu, ∂alpha, ∂beta, ∂gamma) for ``grad`` = ∂L/∂tm [B,n,N,h], in
    the closed form of the module docstring as PyTorch ops (not autograd
    through the chain), z formed as the forward forms it.  bf16 and f16
    inputs are computed in f32 and the results cast back."""
    dt = pu.dtype
    grad, mask_i, mask, deg, pu, alpha, beta, gamma = _f32(
        (grad, mask_i, mask, deg, pu, alpha, beta, gamma))
    z = deg[:, None, None, :, None] * pu[:, :, :, None, :]
    z += alpha[:, :, None]
    z += beta[:, None]
    z += gamma[:, None, None]
    mm = (mask_i[:, :, :, None] * mask[:, None])[..., None]
    z *= mm
    p = mask[:, None, :, :, None] * grad[:, :, :, None, :]               # M[j,k]·g[i,j]
    p = torch.where(z > 0, p, p * LEAK) * mm
    return tuple(t.to(dt) for t in (
        (p * deg[:, None, None, :, None]).sum(3), p.sum(2), p.sum(1), p.sum((1, 2))))


def _check_shapes(mask_i, mask, deg, pu, alpha, beta, gamma) -> None:
    if mask.dim() != 3 or mask.shape[1] != mask.shape[2]:
        raise ValueError(f"motif_level4: mask must be [B,N,N], got {tuple(mask.shape)}")
    B, N = mask.shape[:2]
    n = mask_i.shape[1] if mask_i.dim() == 3 else -1
    h = gamma.shape[-1] if gamma.dim() == 3 else -1
    want = {"mask_i": (B, n, N), "deg": (B, N), "pu": (B, n, N, h), "alpha": (B, n, N, h),
            "beta": (B, N, N, h), "gamma": (B, N, h)}
    got = {"mask_i": mask_i, "deg": deg, "pu": pu, "alpha": alpha, "beta": beta,
           "gamma": gamma}
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(
                f"motif_level4: {name} has shape {tuple(t.shape)}, expected {want[name]}")
    if n > N:
        raise ValueError(f"motif_level4: a window of {n} rows of N = {N}")


def fused_motif_level4(mask_i, mask, deg, pu, alpha, beta, gamma) -> torch.Tensor:
    """mask_i [B,n,N], mask [B,N,N], deg [B,N], pu and alpha [B,n,N,h],
    beta [B,N,N,h], gamma [B,N,h], all of one dtype.  Returns tm [B,n,N,h]
    in that dtype."""
    inputs = (mask_i, mask, deg, pu, alpha, beta, gamma)
    dev = check_inputs("motif_level4", **dict(zip(NAMES, inputs)))
    _check_shapes(*inputs)
    if dev.type == "cpu":
        return motif_level4_plain(*inputs)

    B, n, N, h = pu.shape
    tm = torch.empty_like(pu)
    fn = build.load("motif_level4", _SIGNATURES).motif_level4_launch
    with torch.cuda.device(dev):
        code = fn(*(t.data_ptr() for t in inputs), tm.data_ptr(), B, N, n, h,
                  CUDA_DTYPES[pu.dtype], stream_handle(dev))
    raise_on_error("motif_level4", code)
    fused_motif_level4.launches += 1
    return tm


fused_motif_level4.launches = 0


def fused_motif_level4_backward(grad, mask_i, mask, deg, pu, alpha, beta, gamma) -> tuple:
    """(∂pu, ∂alpha, ∂beta, ∂gamma) of ``fused_motif_level4`` for ``grad``
    = ∂L/∂tm [B,n,N,h], each in its input's dtype: on CUDA tensors one
    launch of ``csrc/motif_level4_backward.cu``, which writes each whole;
    on CPU tensors ``motif_level4_backward_plain``."""
    inputs = (mask_i, mask, deg, pu, alpha, beta, gamma)
    dev = check_inputs("motif_level4_backward", grad=grad, **dict(zip(NAMES, inputs)))
    _check_shapes(*inputs)
    if grad.shape != pu.shape:
        raise ValueError(f"motif_level4_backward: grad has shape {tuple(grad.shape)}, "
                         f"expected {tuple(pu.shape)}")
    if dev.type == "cpu":
        return motif_level4_backward_plain(grad, *inputs)

    B, n, N, h = pu.shape
    grads = tuple(torch.empty_like(t) for t in (pu, alpha, beta, gamma))
    fn = build.load("motif_level4_backward", _BACKWARD_SIGNATURES).motif_level4_backward_launch
    with torch.cuda.device(dev):
        code = fn(*(t.data_ptr() for t in inputs), grad.data_ptr(),
                  *(t.data_ptr() for t in grads), B, N, n, h, CUDA_DTYPES[pu.dtype],
                  stream_handle(dev))
    raise_on_error("motif_level4_backward", code)
    fused_motif_level4_backward.launches += 1
    return grads


fused_motif_level4_backward.launches = 0


class _MotifLevel4(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *inputs):
        ctx.save_for_backward(*inputs)
        return fused_motif_level4(*inputs)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[len(DATA):]
        if not any(needs):
            return (None,) * len(NAMES)
        grads = fused_motif_level4_backward(grad.contiguous(), *ctx.saved_tensors)
        return (None,) * len(DATA) + tuple(g if need else None for g, need in zip(grads, needs))


def motif_level4(mask_i, mask, deg, pu, alpha, beta, gamma) -> torch.Tensor:
    """The differentiable level 4 and k-sum of the window of rows that
    ``mask_i``, ``pu`` and ``alpha`` hold: forward ``fused_motif_level4``,
    backward ``fused_motif_level4_backward``.  The forward saves only its
    inputs, so no [B,n,N,N,h] tensor outlives it on the card.  Raises
    ValueError where a mask or deg requires a gradient: they are data, and
    the kernel pair computes none for them."""
    for name, t in zip(DATA, (mask_i, mask, deg)):
        if t.requires_grad:
            raise ValueError(f"motif_level4: {name} requires grad; the masks and deg are "
                             f"data and take no gradient")
    return _MotifLevel4.apply(mask_i, mask, deg, pu, alpha, beta, gamma)
