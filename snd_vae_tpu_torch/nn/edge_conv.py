"""``E2E`` edge-to-edge conv — the port of ``snd_vae_tpu/nn/edge_conv.py:70-251``
(reference layers.py:431-450): a 1xk_h SAME conv plus the same weights
transposed to k_hx1, one shared bias added to each, summed.

Three lowerings, numerically the same function.  On a dense map the JAX auto
rule (``edge_conv.py:139-156``) picks the conv lowering (``F.conv2d``) below
``matmul_threshold`` width and the Toeplitz lowering (one contraction
against the banded expansion of the kernel, ``_toeplitz_weights``) from it
on, unless that expansion would exceed ``matmul_max_bytes``.  Given
``factors=(P, Q, D)`` of a tile-concat map t[b,i,j] = [P[b,i], Q[b,j],
D[b,i,j]], the separable lowering (``E2E._separable``) computes the same
layer without building the map.  Maps are NHWC [B,H,W,C] at the public
boundary, NCHW only around ``F.conv2d``.

Under an ambient mesh that names a ``model`` axis the auto rule takes the
conv lowering, as JAX's does (``edge_conv.py:149-156``): the Toeplitz
expansion is O(N²·C·O) and would sit whole on every rank.  With that
axis above 1 the map is node-sharded: ``E2E`` takes and returns this rank's rows
i of the [B,N,N,C] map (``hints.own_block``).  The row conv (along j) is
local.  The column conv (along i, kernel height k_h) reads rows of every
rank: the port all-gathers the input rows (``batch.gather_nodes``) and
convolves the padded window of rows its output needs, rather than
reduce-scattering each rank's partial products as JAX's GSPMD lowering
does.  Each output row is then computed once, from the same operands in
the same order as in one process, and the gather's backward is the
reduce-scatter; the partial products would cost the same operations but
an [B,N,N,O] buffer per rank for the reduce-scatter where the gather takes
[B,N,N,C], and their sum over ranks reassociates the column conv.  The
separable lowering keeps P and D row-sharded and Q whole, and returns rows
(JAX ``:228-251``): conv1d(P) and D's column conv read P and D gathered.

The rest of the JAX family (``edge_conv.py:254-403``) follows at the end:
``E2N``, ``N2N``, ``N2GAdj``, the transposed ``DeN2G``, ``DeN2N``,
``DeE2N``, ``DeE2E`` and the pooling pair ``N2GPool`` / ``G2NBroadcast``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import init as inits
from ..parallel.batch import gather_nodes
from ..parallel.hints import MODEL_AXIS, ambient_mesh, model_group, own_block, shard_nodes
from .basic import acc_dtype, same_pad


def _row_col_convs(xc: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor]):
    """The SAME row conv of an NCHW map with ``w`` [O, C, 1, k] and the
    column conv with its transpose, each with ``bias``."""
    return _RowColConv.apply(xc, w, bias)


def _pads(H: int, W: int, k: int) -> Tuple[tuple, tuple]:
    """F.pad's SAME padding of the row conv (along W) and of the column
    conv (along H) of an [.., H, W] map with a kernel of k taps."""
    return same_pad(W, k, 1), (0, 0) + same_pad(H, k, 1)


def _conv_grads(g: torch.Tensor, xc: torch.Tensor, kernel: torch.Tensor, pad: tuple,
                need_x: bool, need_w: bool) -> tuple:
    """(∂x, ∂kernel) of ``F.conv2d(F.pad(xc, pad), kernel)`` (stride 1; F.pad's
    pads, which may be negative, as a window's crop) for its output
    gradient ``g``; None where not asked.  ∂x in f32 and f64 is a forward
    convolution: the correlation of g, padded by k - 1 - p for each pad p
    of an axis with k taps (the pads swapped where they are SAME's), with
    the kernel flipped along its taps and its channel axes swapped
    (∂x[t] = Σ_v g[t + p_lo - v]·kernel[v]); in bf16 the library's data
    gradient of the padded map, its pads taken off again.  ∂kernel is the
    library's weight gradient of the padded map."""
    conv_backward = lambda x, mask: torch.ops.aten.convolution_backward(
        g, x, kernel, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1, mask)
    gx = gw = None
    if need_x and g.dtype in (torch.float32, torch.float64):
        g_pad = tuple(kernel.shape[-1 - i // 2] - 1 - p for i, p in enumerate(pad))
        gx = F.conv2d(F.pad(g, g_pad), kernel.flip(-2, -1).transpose(0, 1))
    elif need_x:
        gx = conv_backward(F.pad(xc, pad), [True, False, False])[0]
        gx = F.pad(gx, tuple(-p for p in pad))
    if need_w:
        gw = conv_backward(F.pad(xc, pad), [False, True, False])[1]
    return gx, gw


class _RowColConv(torch.autograd.Function):
    """``_row_col_convs`` with its backward written out (``_conv_grads``).
    The forward is the two F.conv2d calls on the SAME-padded map.  Autograd
    would take cuDNN's data gradient, whose f32 kernel for a 1 x N kernel at
    N = 2048 ran for minutes on an H100 (a forward conv of the same size:
    2.3 s; PERF.md, "Frontier"), so in f32 the map's gradient is a forward
    convolution.
    Only the unpadded map is saved (autograd kept both padded copies, 2 x
    3.4 GB at N = 2048 f32); the gradients re-pad it, one direction at a
    time."""

    @staticmethod
    def forward(ctx, xc, w, bias):
        pad_row, pad_col = _pads(xc.shape[2], xc.shape[3], w.shape[-1])
        ctx.save_for_backward(xc, w)
        ctx.has_bias = bias is not None
        return (F.conv2d(F.pad(xc, pad_row), w, bias),
                F.conv2d(F.pad(xc, pad_col), w.transpose(2, 3), bias))

    @staticmethod
    def backward(ctx, g_row, g_col):
        xc, w = ctx.saved_tensors
        pad_row, pad_col = _pads(xc.shape[2], xc.shape[3], w.shape[-1])
        need_x, need_w, need_b = ctx.needs_input_grad
        gx_r, gw_r = _conv_grads(g_row, xc, w, pad_row, need_x, need_w)
        gx_c, gw_c = _conv_grads(g_col, xc, w.transpose(2, 3), pad_col, need_x, need_w)
        gb = g_row.sum((0, 2, 3)) + g_col.sum((0, 2, 3)) if ctx.has_bias and need_b else None
        return (gx_r + gx_c if need_x else None,
                gw_r + gw_c.transpose(2, 3) if need_w else None, gb)


def _row_col_conv_rows(rows: torch.Tensor, whole: torch.Tensor, start: int,
                       w: torch.Tensor, bias: Optional[torch.Tensor]):
    """``_row_col_convs`` for output rows [start, start + n) of a square
    NCHW map: the row conv of ``rows`` (those rows of the map), the column
    conv of the window of the SAME-padded ``whole`` map that they read."""
    return _RowColConvRows.apply(rows, whole, start, w, bias)


def _window_pads(N: int, n: int, start: int, k: int) -> tuple:
    """F.pad's pads of an [.., N, N] map that give the window of its
    SAME-padded rows that output rows [start, start + n) of the column
    conv read: unpadded rows [start - pl, start + n + pr), each side
    zero-padded past the map and cropped inside it (a negative pad)."""
    pl, pr = same_pad(N, k, 1)
    return (0, 0, pl - start, start + n + pr - N)


class _RowColConvRows(torch.autograd.Function):
    """``_row_col_conv_rows`` with its backward written out, as
    ``_RowColConv`` has it for the whole map: the forward is the two
    F.conv2d calls (this rank's rows; the window of the whole map), and in
    f32 the gradients of the rows and of the whole map are forward
    convolutions (``_conv_grads``), where autograd took cuDNN's data
    gradient of the padded rows and window.  The window's gradient lands on
    rows [start - pl, start + n + pr) of the whole map, clipped to it;
    the all-gather that made ``whole`` sums it over the ranks in its own
    backward.  Only ``rows``, ``whole`` and the kernel are saved (autograd
    kept the padded rows and the window); the gradients pad them again."""

    @staticmethod
    def forward(ctx, rows, whole, start, w, bias):
        n, N, k = rows.shape[2], whole.shape[2], w.shape[-1]
        ctx.save_for_backward(rows, whole, w)
        ctx.start, ctx.has_bias = start, bias is not None
        return (F.conv2d(F.pad(rows, same_pad(N, k, 1)), w, bias),
                F.conv2d(F.pad(whole, _window_pads(N, n, start, k)), w.transpose(2, 3), bias))

    @staticmethod
    def backward(ctx, g_row, g_col):
        rows, whole, w = ctx.saved_tensors
        n, N, k = rows.shape[2], whole.shape[2], w.shape[-1]
        need_rows, need_whole, _, need_w, need_b = ctx.needs_input_grad
        g_rows, gw_r = _conv_grads(g_row, rows, w, same_pad(N, k, 1), need_rows, need_w)
        g_whole, gw_c = _conv_grads(g_col, whole, w.transpose(2, 3),
                                    _window_pads(N, n, ctx.start, k), need_whole, need_w)
        gb = g_row.sum((0, 2, 3)) + g_col.sum((0, 2, 3)) if ctx.has_bias and need_b else None
        return (g_rows, g_whole, None, gw_r + gw_c.transpose(2, 3) if need_w else None, gb)


def _conv1d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME stride-1 conv of an NWC map [B, W, C] with ``w`` [O, C, k]."""
    xc = F.pad(x.transpose(1, 2), same_pad(x.shape[1], w.shape[-1], 1))
    return F.conv1d(xc, w).transpose(1, 2)


def _toeplitz_weights(w: torch.Tensor, width: int) -> torch.Tensor:
    """``w`` [k_h, C, O] -> ``Mt`` [width, width, C, O] with
    ``Mt[t, j] = w[t - j + pad_left]`` (zero outside the kernel), so a SAME
    stride-1 window conv over a width-``width`` map is
    ``out[b,i,j,o] = Σ_{t,c} x[b,i,t,c]·Mt[t,j,c,o]``."""
    k_h = w.shape[0]
    pl = (k_h - 1) // 2
    ar = torch.arange(width, device=w.device)
    idx = pl + ar[:, None] - ar[None, :]                       # [t, j]
    valid = (idx >= 0) & (idx < k_h)
    g = w[idx.clamp(0, k_h - 1)]                               # [W, W, C, O]
    return torch.where(valid[..., None, None], g, torch.zeros((), dtype=w.dtype,
                                                                 device=w.device))


class E2E(nn.Module):
    """Edge-to-edge conv on an NHWC map [B,N,N,C] -> [B,N,N,O].

    ``w1`` is stored as the row conv's torch kernel [O, C, 1, k_h]; the
    column conv uses its transpose [O, C, k_h, 1].  ``use_matmul`` None =
    the auto rule."""

    def __init__(self, in_features: int, features: int, k_h: int,
                 generator: torch.Generator, stddev: float = 0.02,
                 use_matmul: Optional[bool] = None, matmul_threshold: int = 96,
                 matmul_max_bytes: int = 2 << 30):
        super().__init__()
        self.k_h = k_h
        self.use_matmul = use_matmul
        self.matmul_threshold = matmul_threshold
        self.matmul_max_bytes = matmul_max_bytes
        w = inits.truncated_normal((1, k_h, in_features, features), stddev, generator)
        self.w1 = nn.Parameter(w.permute(3, 2, 0, 1).contiguous())   # [O, C, 1, k_h]
        self.biases1 = nn.Parameter(inits.zeros((features,)))

    def uses_matmul(self, x: torch.Tensor) -> bool:
        """The lowering of ``x``: ``use_matmul`` when set, else JAX's auto
        rule, which takes the conv lowering under any ambient mesh that names
        a ``model`` axis."""
        if self.use_matmul is not None:
            return self.use_matmul
        mesh = ambient_mesh()
        if mesh is not None and MODEL_AXIS in (mesh.mesh_dim_names or ()):
            return False
        mt_bytes = x.shape[2] ** 2 * x.shape[-1] * self.w1.shape[0] * x.element_size()
        return x.shape[2] >= self.matmul_threshold and mt_bytes <= self.matmul_max_bytes

    def forward(self, x: Optional[torch.Tensor] = None, *,
                factors: Optional[Tuple] = None) -> torch.Tensor:
        if (x is None) == (factors is None):
            raise ValueError("E2E takes a dense map x or factors=(P, Q, D), one of them")
        if factors is not None:
            return self._separable(*factors)
        if model_group() is not None:
            return self._rows(x)
        if self.uses_matmul(x):
            if x.shape[1] != x.shape[2]:
                raise ValueError(
                    f"E2E matmul lowering requires square maps, got H={x.shape[1]} "
                    f"W={x.shape[2]}; pass use_matmul=False"
                )
            w = self.w1[:, :, 0, :].permute(2, 1, 0)                  # [k_h, C, O]
            mt = _toeplitz_weights(w, x.shape[2])                     # [t, j, C, O]
            conv1 = torch.einsum("bitc,tjco->bijo", x, mt) + self.biases1
            conv2 = torch.einsum("btjc,tico->bijo", x, mt) + self.biases1
            return conv1 + conv2
        row, col = _row_col_convs(x.permute(0, 3, 1, 2), self.w1, self.biases1)
        return (row + col).permute(0, 2, 3, 1)

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """Under a model axis above 1: this rank's rows of the output, from
        ``x`` whole or this rank's rows of it ([B,n,N,C]; see the module
        docstring)."""
        N = x.shape[2]
        start, n = own_block(N)
        rows = shard_nodes(x, tag="e2e.in", nodes=N)
        whole = x if x.shape[1] == N else gather_nodes(rows, N)
        if self.uses_matmul(whole):
            w = self.w1[:, :, 0, :].permute(2, 1, 0)                  # [k_h, C, O]
            mt = _toeplitz_weights(w, N)                              # [t, j, C, O]
            conv1 = torch.einsum("bitc,tjco->bijo", rows, mt) + self.biases1
            conv2 = torch.einsum("btjc,tico->bijo", whole, mt[:, start:start + n]) + self.biases1
            out = conv1 + conv2
        else:
            row, col = _row_col_conv_rows(rows.permute(0, 3, 1, 2), whole.permute(0, 3, 1, 2),
                                          start, self.w1, self.biases1)
            out = (row + col).permute(0, 2, 3, 1)
        return shard_nodes(out, tag="e2e.out", nodes=N)

    def _separable(self, P: torch.Tensor, Q: torch.Tensor,
                   D: Optional[torch.Tensor]) -> torch.Tensor:
        """E2E over the implicit map t[b,i,j] = [P[b,i], Q[b,j], D[b,i,j]]
        (P [B,N,cP], Q [B,N,cQ], D [B,N,N,d] or None), as
        ``snd_vae_tpu/nn/edge_conv.py:189-251`` computes it:

            row conv = P[b,i] @ SP[j] + conv1d(Q)[b,j]
            col conv = conv1d(P)[b,i] + Q[b,j] @ SQ[i]

        with S[j] = Σ_{t in window(j)} w[t] the per-position window sums of
        the kernel, and D's channels through their own 2-D row and column
        convs.  O(B·N²·C·O) where the dense map costs O(B·N³·C·O).

        Under a model axis above 1, P and D may hold this rank's rows (or be
        whole), Q is whole, and the result is this rank's rows."""
        W = Q.shape[1]
        start, n = own_block(W)
        if P.shape[1] not in (W, n):
            raise ValueError(
                f"separable E2E factor node axes disagree: P {tuple(P.shape)} "
                f"vs Q {tuple(Q.shape)}"
            )
        sharded = model_group() is not None
        P_rows = shard_nodes(P, tag="e2e.sepP", nodes=W)
        if P.shape[1] != W:
            P = gather_nodes(P_rows, W)
        k_h, pl = self.k_h, (self.k_h - 1) // 2
        cP, cQ = P.shape[-1], Q.shape[-1]
        dt = P.dtype
        acc = acc_dtype(dt)
        w1 = self.w1                                                  # [O, C, 1, k_h]
        # window sums through a cumulative sum over the taps, in at least f32
        w = w1[:, :, 0, :].permute(2, 1, 0).to(acc_dtype(w1.dtype))  # [k_h, C, O]
        ar = torch.arange(W, device=w.device)
        lo = (pl - ar).clamp(min=0)                                   # first valid tap
        hi = (W - 1 - ar + pl).clamp(max=k_h - 1)                     # last valid tap
        cs = torch.cat([torch.zeros_like(w[:1]), torch.cumsum(w, dim=0)])
        S = (cs[hi + 1] - cs[lo]).to(dt)                              # [W, C, O]
        SP, SQ = S[:, :cP], S[:, cP:cP + cQ]
        y = torch.einsum("bic,jco->bijo", P_rows.to(acc), SP.to(acc))
        y = y + torch.einsum("bjc,ico->bijo", Q.to(acc), SQ[start:start + n].to(acc))
        convQ = _conv1d_same(Q, w1[:, cP:cP + cQ, 0, :].to(dt)).to(acc)
        convP = _conv1d_same(P, w1[:, :cP, 0, :].to(dt)).to(acc)[:, start:start + n]
        y = y + convQ[:, None, :, :] + convP[:, :, None, :]
        if D is not None:
            wD = w1[:, cP + cQ:].to(dt)
            if sharded:
                D_rows = shard_nodes(D, tag="e2e.sepD", nodes=W)
                D_whole = D if D.shape[1] == W else gather_nodes(D_rows, W)
                row, col = _row_col_conv_rows(D_rows.permute(0, 3, 1, 2),
                                              D_whole.permute(0, 3, 1, 2), start, wD, None)
            else:
                row, col = _row_col_convs(D.permute(0, 3, 1, 2), wD, None)
            y = y + row.permute(0, 2, 3, 1).to(acc) + col.permute(0, 2, 3, 1).to(acc)
        return shard_nodes((y + 2.0 * self.biases1.to(acc)).to(dt), tag="e2e.sep", nodes=W)


# ---------------------------------------------------------------------------
# The rest of the family (``snd_vae_tpu/nn/edge_conv.py:254-403``, reference
# layers.py:362-564).  No model calls them; the JAX package exports them.
# Maps are NHWC at the boundary.  A 4-D ``w`` / ``w1`` is stored in torch's
# layout: the flax [H, W, I, O] kernel permuted to [O, I, H, W], which is
# F.conv2d's weight for the VALID convs and, for the transposed convs (flax
# [h, w, features, C], tf.nn.conv2d_transpose's [h, w, out, in]),
# F.conv_transpose2d's [C, features, h, w].
# ---------------------------------------------------------------------------

def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _conv_param(shape, init) -> nn.Parameter:
    """A flax-layout [H, W, I, O] kernel drawn by ``init``, stored as
    [O, I, H, W]."""
    return nn.Parameter(init(shape).permute(3, 2, 0, 1).contiguous())


class E2N(nn.Module):
    """Edge-to-node 1 x k_h VALID conv: [B,N,N,C] -> [B,N,N-k_h+1,F]
    (k_h = N gives [B,N,1,F])."""

    def __init__(self, in_features: int, features: int, k_h: int,
                 generator: torch.Generator, stddev: float = 0.02):
        super().__init__()
        self.w = _conv_param((1, k_h, in_features, features),
                             lambda s: inits.truncated_normal(s, stddev, generator))
        self.biases = nn.Parameter(inits.zeros((features,)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(F.conv2d(_nchw(x), self.w)) + self.biases


class N2N(nn.Module):
    """Node-to-node 1 x k_h VALID conv."""

    def __init__(self, in_features: int, features: int, k_h: int,
                 generator: torch.Generator, stddev: float = 0.02):
        super().__init__()
        self.w = _conv_param((1, k_h, in_features, features),
                             lambda s: inits.truncated_normal(s, stddev, generator))
        self.bias = nn.Parameter(inits.zeros((features,)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(F.conv2d(_nchw(x), self.w)) + self.bias


class N2GAdj(nn.Module):
    """Node-to-graph N x 1 VALID conv of a one-channel [B,N,W,1] map:
    returns (out [B,1,W,features], w), ``w`` in the flax layout [N,1,1,1]
    as the JAX module returns it."""

    def __init__(self, num_nodes: int, features: int, generator: torch.Generator,
                 stddev: float = 0.02):
        super().__init__()
        self.w = _conv_param((num_nodes, 1, 1, 1),
                             lambda s: inits.truncated_normal(s, stddev, generator))
        self.biases = nn.Parameter(inits.zeros((features,)))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out = _nhwc(F.conv2d(_nchw(x), self.w)) + self.biases
        return out, self.w.permute(2, 3, 1, 0)


class DeN2G(nn.Module):
    """Transposed node-to-graph conv: a [B,1,W,C] map back to [B,height,W,
    features] through a [height,1,1,1] kernel (C = 1)."""

    def __init__(self, height: int, generator: torch.Generator, features: int = 1,
                 stddev: float = 0.02):
        super().__init__()
        self.w = _conv_param((height, 1, 1, 1), lambda s: inits.normal(s, stddev, generator))
        self.biases = nn.Parameter(inits.zeros((features,)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(F.conv_transpose2d(_nchw(x), self.w)) + self.biases


class DeN2N(nn.Module):
    """Transposed node-to-node conv (1 x k_h)."""

    def __init__(self, in_features: int, features: int, k_h: int,
                 generator: torch.Generator, stddev: float = 0.02):
        super().__init__()
        self.w = _conv_param((1, k_h, features, in_features),
                             lambda s: inits.normal(s, stddev, generator))
        self.biases1 = nn.Parameter(inits.zeros((features,)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(F.conv_transpose2d(_nchw(x), self.w)) + self.biases1


class DeE2N(nn.Module):
    """Transposed edge-to-node conv: the deconvolution of the map plus that
    of its spatial transpose with the kernel transposed, one shared bias
    added to each."""

    def __init__(self, in_features: int, features: int, k_h: int,
                 generator: torch.Generator, stddev: float = 0.02):
        super().__init__()
        self.w1 = _conv_param((1, k_h, features, in_features),
                              lambda s: inits.normal(s, stddev, generator))
        self.biases1 = nn.Parameter(inits.zeros((features,)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d1 = _nhwc(F.conv_transpose2d(_nchw(x), self.w1)) + self.biases1
        d2 = _nhwc(F.conv_transpose2d(_nchw(x.transpose(1, 2)),
                                      self.w1.transpose(2, 3))) + self.biases1
        return d1 + d2


class DeE2E(nn.Module):
    """Transposed edge-to-edge conv: the map's column sums and row sums
    ([B,k_h,k_h,C] in, k_h = N) deconvolved back to full edge maps along
    each axis, averaged."""

    def __init__(self, in_features: int, features: int, k_h: int,
                 generator: torch.Generator, stddev: float = 0.02):
        super().__init__()
        self.k_h = k_h
        self.w1 = _conv_param((1, k_h, features, in_features),
                              lambda s: inits.normal(s, stddev, generator))
        self.biases1 = nn.Parameter(inits.zeros((features,)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1]
        x1 = x.sum(1).reshape(B, self.k_h, 1, C)
        x2 = x.sum(2).reshape(B, 1, self.k_h, C)
        d1 = _nhwc(F.conv_transpose2d(_nchw(x1), self.w1)) + self.biases1
        d2 = _nhwc(F.conv_transpose2d(_nchw(x2), self.w1.transpose(2, 3))) + self.biases1
        return (d1 + d2) / 2.0


class N2GPool(nn.Module):
    """Node -> graph pooling with a diagonal mask: relu((W @ x) ∘ I) for x
    [B, hidden, T], W [input_dim, hidden] (products in at least f32)."""

    def __init__(self, input_dim: int, generator: torch.Generator, hidden: int = 20):
        super().__init__()
        self.weights = nn.Parameter(inits.truncated_normal((input_dim, hidden), 0.1, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = acc_dtype(x.dtype)
        y = torch.einsum("io,bot->bit", self.weights.to(acc), x.to(acc)).to(x.dtype)
        eye = torch.eye(self.weights.shape[0], dtype=x.dtype, device=x.device)
        return torch.relu(y * eye[None, :y.shape[1], :y.shape[2]])


class G2NBroadcast(nn.Module):
    """Graph -> node broadcast: relu(W @ x) for x [B, input_dim, T], W
    [hidden, input_dim] (products in at least f32)."""

    def __init__(self, input_dim: int, generator: torch.Generator, hidden: int = 20):
        super().__init__()
        self.weights = nn.Parameter(inits.truncated_normal((hidden, input_dim), 0.1, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = acc_dtype(x.dtype)
        return torch.relu(torch.einsum("ho,bot->bht", self.weights.to(acc),
                                       x.to(acc)).to(x.dtype))
