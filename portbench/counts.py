"""The yardstick's arithmetic: the card's peaks, each kernel's least time on
these inputs (its roofline bound) and the model's FLOPs.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet (dense rates): 67 TFLOP/s in
f32 outside the tensor cores (f32 with TF32 off, the configurations'
precision), 989 TFLOP/s in bf16, 3.35 TB/s of HBM.

The kernel bounds are frozen copies of the arithmetic the port's card smoke
holds its kernels to (``bound``, ``level3_bound``, ``level3_backward_bound``,
``adj_backward_bound`` and K3's count): each input byte read once and each
output byte written once; the operations these inputs need (a motif kernel
counts only the trees' edges).  ``adj`` is a host array of 0/1 trees.

The model FLOPs count every product of the plain reference's forward
(``reference/model.py``: matmuls, batched matmuls and convolutions, 2 per
multiply-add; element-wise work is not counted), nothing recomputed; a train
step counts the forward three times (its backward as twice the forward).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}

# the kernel records of each of the port's kernels in a trace, by the
# substring their names share
KERNEL_NAMES = {"motif_level3": "motif_level3_kernel",
                "motif_level3_backward": "motif_l3_grad_",
                "adj_matmul": "adj_matmul_",
                "adj_matmul_backward": "adj_bwd_"}
# the level-3 backward's gradients on the model's path: a_i, v_j, M1d, M1f, bias
L3_NAMES = ("adj", "phi_r", "a_i", "v_j", "deg", "m1d", "m1f", "bias")
L3_MODEL_NEEDS = (False, False, True, True, False, True, True, True)


def bound_s(nbytes: float, ops: float, dtype: str) -> float:
    """The least seconds of ``ops`` operations and ``nbytes`` of memory."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])


def level3_counts(adj: np.ndarray, R: int, h: int, dtype: str) -> Tuple[float, float]:
    """(bytes, operations) of K1 (``motif_level3``) over trees ``adj``
    [T,N,N]: bytes of adj, φ(rel), a_i, v_j, deg, M1d, M1f, bias and nt;
    operations rf at (i,j,k) with A[i,j] and A[j,k] nonzero (2R) and the
    epilogue's 4R + 7 per live (i,j,h)."""
    T, N = adj.shape[:2]
    nz = (adj != 0).astype(np.float64)
    ops = 2 * R * float((nz.sum(1) * nz.sum(2)).sum()) + float(nz.sum()) * h * (4 * R + 7)
    elems = T * N * N + T * N * N * R + 2 * T * N * h + T * N + 2 * R * h + h + T * N * h
    return DTYPE_BYTES[dtype] * elems, ops


def level3_backward_counts(adj: np.ndarray, R: int, h: int, dtype: str,
                           needs: Sequence[bool] = L3_MODEL_NEEDS) -> Tuple[float, float]:
    """(bytes, operations) of K2 (``motif_level3_backward``) for the
    gradients ``needs`` asks for."""
    T, N = adj.shape[:2]
    need = dict(zip(L3_NAMES, needs))
    nz = (adj != 0).astype(np.float64)
    live = float(nz.sum())
    per_live = 4 * R + 7 + sum(c for k, c in (("a_i", 2), ("v_j", 1), ("deg", 2),
                                               ("m1d", 2 * R + 1), ("m1f", 2 * R),
                                               ("bias", 1), ("phi_r", 2 * R + 1),
                                               ("adj", 4)) if need[k])
    per_live += 2 * R if need["phi_r"] or need["adj"] else 0
    ops = 2 * R * float((nz.sum(1) * nz.sum(2)).sum()) + live * h * per_live
    ops += 2 * R * N * live if need["phi_r"] else 0
    ops += 2 * R * N * N * N * T if need["adj"] else 0
    sizes = {"adj": T * N * N, "phi_r": T * N * N * R, "a_i": T * N * h, "v_j": T * N * h,
             "deg": T * N, "m1d": R * h, "m1f": R * h, "bias": h}
    elems = sum(sizes.values()) + T * N * h + sum(v for k, v in sizes.items() if need[k])
    return DTYPE_BYTES[dtype] * elems, ops


def adj_matmul_counts(b: int, n: int, f: int, h: int, dtype: str) -> Tuple[float, float]:
    """(bytes, operations) of K3 forward, GraphConv's lrelu(A @ (x W)):
    A [b,n,n], x [b,n,f], W [f,h]."""
    elems = b * n * n + b * n * f + f * h + b * n * h
    ops = 2 * b * n * n * h + 2 * b * n * f * h + 2 * b * n * h
    return DTYPE_BYTES[dtype] * elems, ops


def adj_matmul_backward_counts(b: int, n: int, f: int, h: int, need_x: bool,
                               dtype: str) -> Tuple[float, float]:
    """(bytes, operations) of K3's backward of a GraphConv for ∂W and, with
    ``need_x``, ∂x: reads A, x, W, the gradient and the output, writes the
    gradients asked for."""
    elems = b * n * n + b * n * f + f * h + 2 * b * n * h + f * h + (b * n * f if need_x else 0)
    ops = 3 * b * n * h + 2 * b * n * n * h + 2 * b * n * f * h * (2 if need_x else 1)
    return DTYPE_BYTES[dtype] * elems, ops


def graph_conv_widths(cfg: dict) -> Sequence[Tuple[int, int]]:
    """(in, out) of each GraphConv of the topology branch."""
    out, c = [], cfg["num_features"]
    for h in cfg["encoder"]["g_conv_hidden"]:
        out.append((c, h))
        c = h + cfg["num_features"]
    return out


def step_kernel_bound(cfg: dict, trees: np.ndarray, train: bool) -> float:
    """The summed bound of the port's kernels in one step (``train``) or one
    forward: the motif kernels on the third-order convs' trees, K3 (and its
    backward) on each GraphConv.  ``trees`` [B,S,N,N]."""
    dtype, R = cfg["compute_dtype"], cfg["rel_dim"]
    B, N = trees.shape[0], cfg["num_nodes"]
    adj = trees.reshape(-1, N, N)
    calls = []
    for hidden in cfg["encoder"]["sg_conv_hidden"]:
        if len(hidden) == 3:
            calls.append(level3_counts(adj, R, hidden[0], dtype))
            if train:
                calls.append(level3_backward_counts(adj, R, hidden[0], dtype))
    for i, (f, h) in enumerate(graph_conv_widths(cfg)):
        calls.append(adj_matmul_counts(B, N, f, h, dtype))
        if train:
            calls.append(adj_matmul_backward_counts(B, N, f, h, i > 0, dtype))
    return sum(bound_s(nbytes, ops, dtype) for nbytes, ops in calls)


# ---------------------------------------------------------------------------
# Model FLOPs
# ---------------------------------------------------------------------------

def _motif3_flops(T: int, N: int, Fi: int, R: int, hidden) -> int:
    h0, h1, h2 = hidden
    nn_ = T * N * N
    return 2 * (nn_ * Fi + nn_ * R                                # nx, nr
                + 3 * T * N * Fi * h0 + T * N * R * h0           # a_i, v_j
                + nn_ * N * R + 2 * nn_ * R * h0 + nn_ * h0      # rf, d_ij, rf M1f, nt
                + 2 * T * N * Fi * h1 + T * N * R * h1 + T * N * h0 * h1
                + T * N * Fi * h2 + T * N * h1 * h2)


def _motif4_flops(T: int, N: int, Fi: int, R: int, hidden) -> int:
    h0, h1, h2, h3 = hidden
    nn_ = T * N * N
    return 2 * (nn_ * Fi + nn_ * R + nn_ * N * R                  # mx, nr, nd
                + 2 * T * N * Fi * h0 + 4 * nn_ * R * h0         # a_i, a_j; alpha, beta, u
                + 2 * T * N * Fi * h0 + T * N * R * h0           # gamma
                + nn_ * N * h0                                   # tm
                + 3 * T * N * Fi * h1 + 2 * nn_ * R * h1 + T * N * R * h1 + nn_ * h0 * h1
                + nn_ * h1                                       # nt
                + 2 * T * N * Fi * h2 + T * N * R * h2 + T * N * h1 * h2
                + T * N * Fi * h3 + T * N * h2 * h3)


def decode_flops(cfg: dict, B: int, S: int) -> int:
    """Products of the decoder on [B, S] latents."""
    enc, dec = cfg["encoder"], cfg["decoder"]
    N, nf, D, nh = cfg["num_nodes"], cfg["num_features"], cfg["spatial_dim"], dec["node_h_size"]
    fl = 2 * N * nh * (B * S * enc["sg_latent_size"] + B * enc["s_latent_size"]
                       + B * enc["g_latent_size"])
    for chans, ks, last in ((dec["n_d_channels"], dec["n_d_kernel_sizes"], nf),
                            (dec["s_d_channels"], dec["s_d_kernel_sizes"], D)):
        c = 2 * nh
        for ch, k in zip(chans, ks):
            fl += 2 * B * N * ch * c * k
            c = ch
        fl += 2 * B * N * c * last
    c = 4 * nh
    for h in dec["e_d_hidden"]:
        fl += 2 * 2 * B * h * N * N * c * N                       # row and column convs
        c = h
    return fl + 2 * B * N * N * c * 2


def forward_flops(cfg: dict, B: int, S: int) -> int:
    """Products of one forward (encode, decode) of B graphs with S trees each."""
    enc = cfg["encoder"]
    N, nf, D, R = cfg["num_nodes"], cfg["num_features"], cfg["spatial_dim"], cfg["rel_dim"]
    T = B * S
    fl = 0
    c = nf
    for f, h in graph_conv_widths(cfg):
        fl += 2 * B * N * f * h + 2 * B * N * N * h
        c = h + nf
    fl += 2 * B * N * c * enc["g_hidden_size"] + 4 * B * enc["g_hidden_size"] * enc["g_latent_size"]
    c, L = D, N
    for ch, k, s in zip(enc["s_channels"], enc["s_kernel_sizes"], enc["s_strides"]):
        L = -(-L // s)
        fl += 2 * B * L * ch * c * k
        c = ch
    fl += 2 * B * L * c * enc["s_hidden_size"] + 4 * B * enc["s_hidden_size"] * enc["s_latent_size"]
    c = nf
    for hidden in enc["sg_conv_hidden"]:
        fl += (_motif3_flops if len(hidden) == 3 else _motif4_flops)(T, N, c, R, hidden)
        c = hidden[-1]
    hid = enc["sg_hidden_size"]
    fl += 2 * T * N * c * hid + 4 * T * hid * enc["sg_latent_size"]
    return fl + decode_flops(cfg, B, S)


def train_step_flops(cfg: dict, B: int, S: int) -> int:
    return 3 * forward_flops(cfg, B, S)
