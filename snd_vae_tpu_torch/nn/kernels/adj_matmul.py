"""K3: ``act(A @ X)``, or GraphConv's ``act(A @ (X W))``, with a fused
leaky-ReLU epilogue — the port of the TPU kernel ``blocked_adj_matmul``
(snd_vae_tpu/nn/pallas/blocked_spmm.py:89).

``blocked_adj_matmul`` launches ``csrc/adj_matmul.cu`` on CUDA tensors and
counts the launch in ``blocked_adj_matmul.launches``; on CPU tensors, and
only there, it returns ``adj_matmul_plain``.  ``adj_matmul_plan`` picks the
kernel's variant and sizes from the shapes alone (pure Python, so the CPU
tests hold it); the wrapper passes the plan to the launch, which checks it
against the kernel's sizes and launches it as it stands.

``adj_matmul`` is a ``torch.autograd.Function`` whose forward is that
wrapper and whose backward is ``fused_adj_matmul_backward``: with g =
∂L/∂out, s = 1 where out > 0, leak where out < 0 or is -0.0, and (1 + leak)/2
where out is +0.0 (``torch.maximum``'s backward splits a tie),

  gy = g·s,  gxw = round(Aᵀ gy),  gx = round(gxw Wᵀ) (gxw without W),
  gW = round(Σ_b x_bᵀ gxw_b),  gA = round(gy xwᵀ),

each product summed in at least f32 and rounded to its input's dtype, the
roundings of autograd through ``adj_matmul_plain``.  The forward saves its
output, from which s is read, so nothing of it is recomputed.  On CUDA
tensors the wrapper launches ``csrc/adj_matmul_backward.cu`` as
``adj_matmul_backward_plan`` lays it out (one kernel, a second where ∂A is
asked) and counts the call in ``fused_adj_matmul_backward.launches``; on
CPU tensors, and only there, it returns ``adj_matmul_backward_plain``, the
closed form above as PyTorch ops.  The TPU kernel has no backward (JAX
differentiates its GraphConv's einsums); the tests hold both against
``jax.vjp``.  ``GraphConv`` computes its ``lrelu(A @ (X W))`` through
``adj_matmul`` with ``w``: one launch forward, one backward.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..basic import acc_dtype
from . import build
from ._launch import (CUDA_DTYPES, check_inputs, election_counters, raise_on_error,
                      stream_handle)

# The kernel's sizes, mirrored from csrc/adj_matmul.cu, whose launch
# refuses a plan that does not match them.
SMALL_COLS, SMALL_THREADS, SMALL_MAX_NM, SMALL_MAX_SMEM = 32, 512, 64, 48 * 1024
SIMT_TILE, SIMT_STAGES, SIMT_STAGES_W, SIMT_THREADS = (64, 64, 64), 4, 3, 256
SIMT_MIN_SMEM = 116 * 1024   # more than half an SM's: one block per SM
TC_TILE, TC_STAGES, TC_STAGES_W, TC_THREADS = (64, 128, 64), 4, 3, 256
MAX_FUSED_F = 16          # W fused in the tiled kernels up to this F: the projection
                          # runs on CUDA cores, F/64 of the tile's work per k-tile
MAX_SPLIT = 8             # the k-split is a portable thread-block cluster
SMEM_PER_BLOCK = 232_448  # 227 KB
GRID_YZ_MAX = 65_535
VARIANTS = ("small", "simt", "tc")
# The most clusters of 1, 2, 4 and 8 blocks of each tiled variant an H100
# SXM holds at once (cudaOccupancyMaxActiveClusters; simt one block per SM,
# tc two): clusters of 4 and 8 reach only 120 of the 132 SMs, since a
# cluster lies in one GPC.  The wrapper plans with what the card it runs on
# reports (``cluster_capacity``); the CPU tests plan for this card.
H100_CLUSTERS = {"simt": {1: 132, 2: 66, 4: 30, 8: 15}, "tc": {1: 264, 2: 132, 4: 62, 8: 30}}


class LaunchPlan(ctypes.Structure):
    """A plan as ``adj_matmul_launch`` takes it (``struct LaunchPlan`` in
    csrc/adj_matmul.cu): rank r of the cluster sums k in
    [k_bound[r], k_bound[r+1])."""

    _fields_ = [("variant", ctypes.c_int), ("split", ctypes.c_int),
                ("grid", ctypes.c_int * 3), ("threads", ctypes.c_int),
                ("smem", ctypes.c_int), ("stages", ctypes.c_int), ("tile", ctypes.c_int * 3),
                ("k_bound", ctypes.c_int * (MAX_SPLIT + 1)),
                ("tma_a", ctypes.c_int), ("tma_x", ctypes.c_int)]


_SIGNATURES = {
    "adj_matmul_launch": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # a, x, w, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # batch, n, m, h, f
        ctypes.c_float, ctypes.c_int, ctypes.c_int,                            # leak, has_leak, dtype
        ctypes.POINTER(LaunchPlan), ctypes.c_void_p,                           # plan, stream
    ),
    "adj_matmul_max_clusters": (ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)),
}


@dataclass(frozen=True)
class AdjMatmulPlan:
    """One launch of csrc/adj_matmul.cu.  ``variant``: "small" (one block
    per graph and 32-column tile), "simt" (f32 tiles on CUDA cores) or "tc"
    (bf16 tiles on tensor cores).  ``tile`` is (rows, columns, k) of one
    block's output tile and k step; ``split`` blocks of one cluster share
    each tile's k range, rank r taking ``k_slices[r]`` = [start, end);
    ``grid`` is (x, y, z) blocks.  ``fuse_w``: W is applied in the kernel;
    otherwise the wrapper forms x @ w first.  ``tma_a`` / ``tma_x``: the
    tiled kernel loads that operand with TMA (else with 4-byte cp.async)."""

    variant: str
    fuse_w: bool
    tile: Tuple[int, int, int]
    split: int
    stages: int
    threads: int
    smem: int
    grid: Tuple[int, int, int]
    k_slices: Tuple[Tuple[int, int], ...]
    tma_a: bool = False
    tma_x: bool = False

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def as_c(self) -> LaunchPlan:
        bounds = [s for s, _ in self.k_slices] + [self.k_slices[-1][1]]
        return LaunchPlan(VARIANTS.index(self.variant), self.split, self.grid, self.threads,
                          self.smem, self.stages, self.tile,
                          (*bounds, *[0] * (MAX_SPLIT + 1 - len(bounds))),
                          self.tma_a, self.tma_x)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round8(v: int) -> int:
    return _cdiv(v, 8) * 8


def split_k(m: int, k_step: int, split: int) -> Tuple[Tuple[int, int], ...]:
    """[0, m) in ``split`` slices of whole k-steps, balanced, in rank order."""
    k_tiles = _cdiv(m, k_step)
    return tuple((r * k_tiles // split * k_step, min(m, (r + 1) * k_tiles // split * k_step))
                 for r in range(split))


def adj_matmul_plan(batch: int, n: int, m: int, h: int, f: Optional[int] = None,
                    dtype: torch.dtype = torch.float32, aligned: bool = True,
                    clusters: Optional[dict] = None) -> AdjMatmulPlan:
    """The variant and sizes for [batch,n,m] @ [batch,m,h], or with ``f``
    [batch,n,m] @ ([batch,m,f] @ [f,h]).  ``aligned``: the operands' data
    start on 16-byte boundaries (TMA needs it).
    ``clusters``: how many clusters of each size the card holds at once, per
    tiled variant (default: an H100 SXM's).

    A graph whose A, X and W fit one block's 48 KB (n, m <= 64) takes the
    small variant.  Larger ones take tiles; k is split over up to 8 blocks
    of a cluster while every tile's cluster still fits the card at once."""
    if dtype not in CUDA_DTYPES:
        raise TypeError(f"adj_matmul: no kernel for {dtype}")
    esz = 2 if dtype == torch.bfloat16 else 4
    xcols = h if f is None else f
    small_smem = m * SMALL_COLS * 4 + esz * (   # xw in f32; A, x and W staged
        _round8(n * m + 2) + _round8(m * xcols + 2) + (0 if f is None else _round8(f * h + 2)))
    if n <= SMALL_MAX_NM and m <= SMALL_MAX_NM and small_smem <= SMALL_MAX_SMEM:
        col_tiles = _cdiv(h, SMALL_COLS)
        return AdjMatmulPlan("small", f is not None, (n, SMALL_COLS, m), 1, 1, SMALL_THREADS,
                             small_smem, (batch * col_tiles, 1, 1), ((0, m),))

    fuse_w = f is not None and f <= MAX_FUSED_F
    if dtype == torch.bfloat16:
        variant, tile, threads = "tc", TC_TILE, TC_THREADS
        stages = TC_STAGES_W if fuse_w else TC_STAGES
        stage_bytes = (tile[0] * tile[2] + tile[2] * tile[1]) * 2
        smem = (1024 + stages * stage_bytes
                + (tile[2] * tile[1] * 2 + f * tile[1] * 4 if fuse_w else 0)
                + 2 * stages * 8)
    else:
        variant, tile, threads = "simt", SIMT_TILE, SIMT_THREADS
        stages = SIMT_STAGES_W if fuse_w else SIMT_STAGES
        smem = max(1024 + 4 * (stages * (tile[0] * tile[2] + tile[2] * tile[1])
                               + (f * tile[1] + tile[2] * tile[1] if fuse_w else 0)
                               + tile[0] * (tile[1] + 4))   # received rows
                   + 8 * stages, SIMT_MIN_SMEM)
    tiles = _cdiv(n, tile[0]) * _cdiv(h, tile[1])
    if tiles > GRID_YZ_MAX or batch > GRID_YZ_MAX:
        raise ValueError(f"adj_matmul: {tiles} tiles x batch {batch} exceed the grid")
    held = (clusters or H100_CLUSTERS)[variant]
    split = 1
    while (split * 2 <= MAX_SPLIT and split * 2 <= _cdiv(m, tile[2])
           and tiles * batch <= held[split * 2]):
        split *= 2
    return AdjMatmulPlan(
        variant, fuse_w, tile, split, stages, threads, smem, (split, tiles, batch),
        split_k(m, tile[2], split),
        tma_a=aligned and m > 0 and m % (16 // esz) == 0,   # TMA: 16-byte rows
        tma_x=aligned and m > 0 and not fuse_w and h % (16 // esz) == 0)


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w accumulated in at least f32 and rounded to x's dtype (JAX's
    ``xw.astype(x.dtype)``): a plain product, as the JAX package leaves it
    to XLA."""
    acc = acc_dtype(x.dtype)
    return torch.matmul(x.to(acc), w.to(acc)).to(x.dtype)


def adj_matmul_plain(adj: torch.Tensor, x: torch.Tensor, leak: Optional[float] = None,
                     w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version (the JAX ``adj_matmul_reference``, and with
    ``w`` JAX's GraphConv): xw = x @ w rounded to x's dtype, the product
    accumulated in at least f32, cast to x's dtype, then max(y, leak*y)."""
    if w is not None:
        x = project(x, w)
    acc = acc_dtype(x.dtype)
    out = torch.matmul(adj.to(acc), x.to(acc)).to(x.dtype)
    if leak is not None:
        out = torch.maximum(out, leak * out)
    return out


def _check(adj: torch.Tensor, x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.device:
    tensors = {"adj": adj, "x": x} if w is None else {"adj": adj, "x": x, "w": w}
    dev = check_inputs("adj_matmul", **tensors)
    if adj.dim() not in (2, 3) or x.dim() != adj.dim():
        raise ValueError(
            f"adj_matmul: expected [N,M]@[M,H] or [B,N,M]@[B,M,H], got "
            f"{tuple(adj.shape)} @ {tuple(x.shape)}"
        )
    if adj.shape[-1] != x.shape[-2] or adj.shape[:-2] != x.shape[:-2]:
        raise ValueError(
            f"adj_matmul: shapes {tuple(adj.shape)} and {tuple(x.shape)} do not chain"
        )
    if w is not None and (w.dim() != 2 or w.shape[0] != x.shape[-1]):
        raise ValueError(
            f"adj_matmul: w must be [F,H] with F = x's last axis {x.shape[-1]}, "
            f"got {tuple(w.shape)}"
        )
    return dev


def blocked_adj_matmul(adj: torch.Tensor, x: torch.Tensor, leak: Optional[float] = None,
                       w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: [N,M] @ [M,H], or batched [B,N,M] @ [B,M,H]; with ``w`` [F,H],
    x is [.., M, F] and the product is A @ (x @ w).  ``leak`` fuses
    max(y, leak*y).  Output in x's dtype.  One kernel launch."""
    dev = _check(adj, x, w)
    if dev.type == "cpu":
        return adj_matmul_plain(adj, x, leak, w)

    n, m = adj.shape[-2:]
    batch = adj.shape[0] if adj.dim() == 3 else 1
    h = x.shape[-1] if w is None else w.shape[1]
    f = None if w is None else w.shape[0]
    held = cluster_capacity(dev)
    plan = adj_matmul_plan(batch, n, m, h, f, x.dtype, clusters=held)
    if w is not None and not plan.fuse_w:   # a wide F: the projection is a plain product
        x, w, f = project(x, w), None, None
    aligned = all(t.data_ptr() % 16 == 0 for t in (adj, x))
    plan = adj_matmul_plan(batch, n, m, h, f, x.dtype, aligned, held)
    out = torch.empty(adj.shape[:-1] + (h,), dtype=x.dtype, device=dev)
    fn = build.load("adj_matmul", _SIGNATURES).adj_matmul_launch
    with torch.cuda.device(dev):
        code = fn(*launch_args(adj, x, w, out, leak, plan))
    raise_on_error("adj_matmul", code)
    blocked_adj_matmul.launches += 1
    return out


def launch_args(adj: torch.Tensor, x: torch.Tensor, w: Optional[torch.Tensor],
                out: torch.Tensor, leak: Optional[float], plan: AdjMatmulPlan) -> tuple:
    """The arguments of ``adj_matmul_launch`` for ``plan`` (w given only
    where the plan fuses it)."""
    n, m = adj.shape[-2:]
    batch = adj.shape[0] if adj.dim() == 3 else 1
    return (adj.data_ptr(), x.data_ptr(), None if w is None else w.data_ptr(), out.data_ptr(),
            batch, n, m, out.shape[-1], 0 if w is None else w.shape[0],
            0.0 if leak is None else float(leak), int(leak is not None),
            CUDA_DTYPES[x.dtype], ctypes.pointer(plan.as_c()), stream_handle(out.device))


@functools.lru_cache(maxsize=None)
def _capacity(index: int) -> dict:
    lib = build.load("adj_matmul", _SIGNATURES)
    held = {}
    with torch.cuda.device(index):
        for dtype, variant in ((0, "simt"), (1, "tc")):
            held[variant] = {}
            for split in (1, 2, 4, 8):
                count = ctypes.c_int(0)
                raise_on_error("adj_matmul", lib.adj_matmul_max_clusters(dtype, split,
                                                                         ctypes.byref(count)))
                held[variant][split] = count.value
    return held


def cluster_capacity(device: torch.device) -> dict:
    """How many clusters of 1, 2, 4 and 8 blocks of each tiled variant the
    card holds at once, as ``H100_CLUSTERS`` (cudaOccupancyMaxActiveClusters,
    asked once per card)."""
    return _capacity(torch.cuda.current_device() if device.index is None else device.index)


blocked_adj_matmul.launches = 0


# The backward kernel's sizes, mirrored from csrc/adj_matmul_backward.cu,
# whose launch refuses a plan that does not match them.
BWD_THREADS = 256                 # small and ∂A
BWD_SIMT_TILE = (64, 64, 64)      # simt (f32): gxw tile rows k, columns h, and the i step
BWD_TC_TILE = (128, 128, 64)      # tc (bf16)
BWD_SIMT_THREADS, BWD_TC_THREADS = 256, 384   # four groups of 64; two consumer + one producer warpgroup
BWD_STAGES = 4
# the tiled variants' dynamic shared memory: 1024-byte alignment slack, a
# ring of BWD_STAGES stages of A, g and out tiles and its mbarriers; simt
# also a gy tile, tc two mbarriers a stage (full, empty)
BWD_SIMT_SMEM = 1024 + (BWD_STAGES * 3 + 1) * 64 * 64 * 4 + BWD_STAGES * 8
BWD_TC_SMEM = 1024 + BWD_STAGES * 3 * 64 * 128 * 2 + 2 * BWD_STAGES * 8
BWD_VARIANTS = ("small", "simt", "tc")
DA_TILE = (64, 64, 32)       # ∂A: tile rows i, columns k, and the h step
DA_STRIDE = 64 + 4           # row stride of ∂A's transposed operands
# The most clusters of 1, 2, 4 and 8 blocks of each tiled backward variant
# an H100 SXM holds at once (cudaOccupancyMaxActiveClusters; one block per
# SM for both), as H100_CLUSTERS; the wrapper plans with what its card
# reports (``backward_cluster_capacity``).
H100_BWD_CLUSTERS = {"simt": {1: 132, 2: 66, 4: 30, 8: 15}, "tc": {1: 132, 2: 66, 4: 30, 8: 15}}


class BackwardPlan(ctypes.Structure):
    """A plan as ``adj_matmul_backward_launch`` takes it (``struct
    BackwardPlan`` in csrc/adj_matmul_backward.cu)."""

    _fields_ = [("variant", ctypes.c_int), ("fuse_w", ctypes.c_int),
                ("threads", ctypes.c_int), ("smem", ctypes.c_int),
                ("grid", ctypes.c_int * 3), ("split", ctypes.c_int),
                ("tile", ctypes.c_int * 3), ("i_bound", ctypes.c_int * (MAX_SPLIT + 1)),
                ("stages", ctypes.c_int), ("tma_a", ctypes.c_int), ("tma_g", ctypes.c_int),
                ("k_tiles", ctypes.c_int), ("h_tiles", ctypes.c_int), ("parts", ctypes.c_int),
                ("da_grid", ctypes.c_int * 3), ("da_smem", ctypes.c_int)]


_BACKWARD_SIGNATURES = {
    "adj_matmul_backward_launch": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # a, x, w, out
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # g, gx, gw, ga
        ctypes.c_void_p, ctypes.c_void_p,                                      # part, counter
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # batch n m h f
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # leak has_leak flags dtype
        ctypes.POINTER(BackwardPlan), ctypes.c_void_p,                         # plan, stream
    ),
    "adj_matmul_backward_max_clusters": (ctypes.c_int, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int)),
}


@dataclass(frozen=True)
class AdjMatmulBackwardPlan:
    """One call of csrc/adj_matmul_backward.cu for [batch,n,m] @ [batch,m,h]
    (with ``f``: x [batch,m,f] and W [f,h]) and the gradients ``needs``
    asks for.  ``variant``: "small" (one block per graph, W always fused),
    "simt" (f32 gxw tiles on CUDA cores) or "tc" (bf16 gxw tiles on tensor
    cores).  A tiled variant's ``tile`` is (rows k, columns h, i step) of one
    block's gxw tile, over ``k_tiles`` x ``h_tiles`` tiles; the ``split``
    blocks of a cluster share each tile's sum over i, rank r taking
    ``i_slices[r]`` = [start, end); ``stages`` is the ring's depth;
    ``tma_a`` / ``tma_g``: A / g and out loaded by TMA (else by 4-byte
    copies).  W is fused up to ``MAX_FUSED_F`` rows where h is one column
    tile.  ``grid`` / ``smem``: the main kernel's (gx, gxw or gW; zeros
    where only ∂A is asked); ``da_grid`` / ``da_smem``: the ∂A kernel's
    (zeros where ∂A is not asked).  ``parts``: rows of the f32 workspace of
    partial gW, [parts, f·h], summed in the launch, which then takes one
    election counter (0 where gW is not fused or not asked).  ``kernels``:
    1, or 2 where ∂A is asked beside gx or gW."""

    variant: str
    fuse_w: bool
    threads: int
    smem: int
    grid: Tuple[int, int, int]
    k_tiles: int
    h_tiles: int
    parts: int
    da_grid: Tuple[int, int, int]
    da_smem: int
    split: int = 1
    tile: Tuple[int, int, int] = (0, 0, 0)
    i_slices: Tuple[Tuple[int, int], ...] = ()
    stages: int = 0
    tma_a: bool = False
    tma_g: bool = False

    @property
    def kernels(self) -> int:
        return int(self.grid != (0, 0, 0)) + int(self.da_grid != (0, 0, 0))

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def as_c(self) -> BackwardPlan:
        bounds = [s for s, _ in self.i_slices] + [self.i_slices[-1][1]]
        return BackwardPlan(BWD_VARIANTS.index(self.variant), self.fuse_w, self.threads,
                            self.smem, self.grid, self.split, self.tile,
                            (*bounds, *[0] * (MAX_SPLIT + 1 - len(bounds))), self.stages,
                            self.tma_a, self.tma_g, self.k_tiles, self.h_tiles, self.parts,
                            self.da_grid, self.da_smem)


def _small_floats(n: int, m: int, h: int, f: int) -> int:
    return n * (m | 1) + n * h + m * h + m * f + f * h


def adj_matmul_backward_plan(batch: int, n: int, m: int, h: int, f: Optional[int] = None,
                             dtype: torch.dtype = torch.float32,
                             needs=(False, True, True), aligned: bool = True,
                             clusters: Optional[dict] = None) -> AdjMatmulBackwardPlan:
    """The launch plan of ``fused_adj_matmul_backward`` (pure Python) for
    the shapes of ``adj_matmul_plan`` and the gradients ``needs`` (∂A, ∂x,
    ∂W) asks for.  ``aligned``: A, g and out start on 16-byte boundaries
    (TMA needs it).  ``clusters``: how many clusters of each size the card
    holds at once, per tiled variant (default: an H100 SXM's).

    A graph whose A, gy, gxw, x and W fit one block's 48 KB (n, m <= 64)
    takes the small variant: the model's path.  Larger ones take gxw tiles,
    "simt" in f32 and "tc" in bf16; the sum over i is split over up to 8
    blocks of a cluster while every tile's cluster still fits the card at
    once."""
    if dtype not in CUDA_DTYPES:
        raise TypeError(f"adj_matmul_backward: no kernel for {dtype}")
    need_a, need_x, need_w = needs[0], needs[1], needs[2] and f is not None
    main = need_x or need_w
    if (need_a or main) and batch > GRID_YZ_MAX:
        raise ValueError(f"adj_matmul_backward: batch {batch} exceeds the grid")
    small = (n <= SMALL_MAX_NM and m <= SMALL_MAX_NM
             and 4 * _small_floats(n, m, h, f or 0) <= SMALL_MAX_SMEM)
    bf16 = dtype == torch.bfloat16
    tile = BWD_TC_TILE if bf16 else BWD_SIMT_TILE
    fuse = f is not None and (small or (f <= MAX_FUSED_F and h <= tile[1]))
    fk = f if fuse else 0
    da = dict(da_grid=(_cdiv(n, DA_TILE[0]) * _cdiv(m, DA_TILE[1]), batch, 1) if need_a
              else (0, 0, 0),
              da_smem=4 * (2 * DA_TILE[2] * DA_STRIDE + (DA_TILE[1] + DA_TILE[2]) * fk)
              if need_a else 0)
    if small:
        return AdjMatmulBackwardPlan(
            "small", fuse, BWD_THREADS, 4 * _small_floats(n, m, h, fk) if main else 0,
            (batch, 1, 1) if main else (0, 0, 0), 0, 0, batch if need_w else 0,
            i_slices=((0, n),), **da)

    variant = "tc" if bf16 else "simt"
    k_tiles, h_tiles = _cdiv(m, tile[0]), _cdiv(h, tile[1])
    tiles = k_tiles * h_tiles
    if main and tiles > GRID_YZ_MAX:
        raise ValueError(f"adj_matmul_backward: {tiles} tiles exceed the grid")
    held = (clusters or H100_BWD_CLUSTERS)[variant]
    split = 1
    while (split * 2 <= MAX_SPLIT and split * 2 <= _cdiv(n, tile[2])
           and tiles * batch <= held[split * 2]):
        split *= 2
    per16 = 8 if bf16 else 4   # TMA: 16-byte rows
    return AdjMatmulBackwardPlan(
        variant, fuse, BWD_TC_THREADS if bf16 else BWD_SIMT_THREADS,
        (BWD_TC_SMEM if bf16 else BWD_SIMT_SMEM) if main else 0,
        (split, tiles, batch) if main else (0, 0, 0), k_tiles, h_tiles,
        split * tiles * batch if need_w and fuse else 0, split=split, tile=tile,
        i_slices=split_k(n, tile[2], split), stages=BWD_STAGES,
        tma_a=aligned and m % per16 == 0, tma_g=aligned and h % per16 == 0, **da)


def lrelu_grad(grad: torch.Tensor, out: torch.Tensor, leak: float) -> torch.Tensor:
    """∂L/∂y of max(y, leak·y) from the output ``out`` (whose sign is y's,
    leak > 0), rounded as ``torch.maximum``'s backward rounds it: g where
    out > 0, g·leak where out < 0 or is -0.0, g/2 + (g/2)·leak where out is
    +0.0 (the tie, y == 0)."""
    half = grad / 2
    return torch.where(out > 0, grad,
                       torch.where(torch.signbit(out), grad * leak, half + half * leak))


def adj_matmul_backward_plain(grad: torch.Tensor, adj: torch.Tensor, x: torch.Tensor,
                              out: Optional[torch.Tensor], leak: Optional[float] = None,
                              w: Optional[torch.Tensor] = None,
                              needs=(True, True, True)) -> tuple:
    """Plain PyTorch version of K3's backward: (∂A, ∂x, ∂W) of
    ``adj_matmul_plain(adj, x, leak, w)`` for ``grad`` = ∂L/∂out, in the
    closed form of the module docstring (not autograd through the
    forward); ``out`` is the forward's output (read only with ``leak``).
    None where ``needs`` is False or there is no W."""
    need_a, need_x, need_w = needs
    acc = acc_dtype(x.dtype)
    gy = (grad if leak is None else lrelu_grad(grad, out, leak)).to(acc)
    ga = gx = gw = None
    if need_a:
        xw = x if w is None else project(x, w)
        ga = torch.matmul(gy, xw.to(acc).transpose(-1, -2)).to(adj.dtype)
    if need_x or (need_w and w is not None):
        gxw = torch.matmul(adj.to(acc).transpose(-1, -2), gy).to(x.dtype)
        if w is None:
            gx = gxw if need_x else None
        else:
            gx, gw = _w_products(gxw, x, w, need_x, need_w)
    return ga, gx, gw


def _w_products(gxw: torch.Tensor, x: torch.Tensor, w: torch.Tensor, need_x: bool,
                need_w: bool) -> tuple:
    """gx = round(gxw Wᵀ) and gW = round(Σ_b x_bᵀ gxw_b), summed in at
    least f32: plain products, as the JAX package leaves x @ W to XLA."""
    acc = acc_dtype(x.dtype)
    g = gxw.to(acc)
    gx = torch.matmul(g, w.to(acc).transpose(0, 1)).to(x.dtype) if need_x else None
    gw = (torch.matmul(x.to(acc).reshape(-1, x.shape[-1]).transpose(0, 1),
                       g.reshape(-1, g.shape[-1])).to(w.dtype) if need_w else None)
    return gx, gw


def fused_adj_matmul_backward(grad: torch.Tensor, adj: torch.Tensor, x: torch.Tensor,
                              out: Optional[torch.Tensor], leak: Optional[float] = None,
                              w: Optional[torch.Tensor] = None,
                              needs=(False, True, True)) -> tuple:
    """K3's backward: (∂A, ∂x, ∂W) of ``blocked_adj_matmul(adj, x, leak,
    w)`` for ``grad`` = ∂L/∂out [.., N, H], given the forward's output
    ``out`` (needed only with ``leak``), each in its input's dtype, None
    where ``needs`` (∂A, ∂x, ∂W) is False or there is no W.  On CUDA
    tensors: ``csrc/adj_matmul_backward.cu`` as ``adj_matmul_backward_plan``
    lays it out (one kernel, two where ∂A is asked; one count), where W is
    not fused gx and gW as plain products of the kernel's gxw; on CPU
    tensors ``adj_matmul_backward_plain``."""
    dev = _check(adj, x, w)
    tensors = {"grad": grad, "adj": adj} | ({} if leak is None else {"out": out})
    check_inputs("adj_matmul_backward", **tensors)
    h = x.shape[-1] if w is None else w.shape[1]
    want = adj.shape[:-1] + (h,)
    for name, t in tensors.items():
        if name != "adj" and t.shape != want:
            raise ValueError(f"adj_matmul_backward: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(want)}")
    if dev.type == "cpu":
        return adj_matmul_backward_plain(grad, adj, x, out, leak, w, needs)

    need_a, need_x, need_w = needs[0], needs[1], needs[2] and w is not None
    n, m = adj.shape[-2:]
    batch = adj.shape[0] if adj.dim() == 3 else 1
    f = None if w is None else w.shape[0]
    zeros = lambda t, need: torch.zeros_like(t) if need else None
    if not (need_a or need_x or need_w) or batch * n * m * h == 0:
        return zeros(adj, need_a), zeros(x, need_x), zeros(w, need_w) if w is not None else None
    aligned = all(t.data_ptr() % 16 == 0 for t in (adj, grad) + (() if leak is None else (out,)))
    plan = adj_matmul_backward_plan(batch, n, m, h, f, x.dtype, (need_a, need_x, need_w),
                                    aligned, backward_cluster_capacity(dev))
    fn = build.load("adj_matmul_backward", _BACKWARD_SIGNATURES).adj_matmul_backward_launch
    ga, gx, gw = backward_call(fn, grad, adj, x, out, leak, w, (need_a, need_x, need_w), plan)
    fused_adj_matmul_backward.launches += 1
    if w is not None and not plan.fuse_w:
        gx, gw = _w_products(gx, x, w, need_x, need_w)
    return ga, gx, gw


def backward_call(fn, grad: torch.Tensor, adj: torch.Tensor, x: torch.Tensor,
                  out: Optional[torch.Tensor], leak: Optional[float], w: Optional[torch.Tensor],
                  needs, plan: AdjMatmulBackwardPlan) -> tuple:
    """One call of ``adj_matmul_backward_launch`` (``fn``) for ``plan``, the
    outputs and scratch allocated here: (∂A, ∂x, ∂W) where the plan fuses W,
    else (∂A, gxw, None).  Raises on a launch error."""
    need_a, need_x, need_w = needs
    dev, h = adj.device, grad.shape[-1]
    n, m = adj.shape[-2:]
    batch = adj.shape[0] if adj.dim() == 3 else 1
    f = None if w is None else w.shape[0]
    ga = torch.empty_like(adj) if need_a else None
    if plan.fuse_w:
        gx = torch.empty_like(x) if need_x else None
        gw = torch.empty_like(w) if need_w else None
        xk, wk, flags = x, w, 2 * need_x + 4 * need_w
    else:   # the kernel's gxw; a wide F's products with W are plain products
        gx = (torch.empty(x.shape[:-1] + (h,), dtype=x.dtype, device=dev)
              if need_x or need_w else None)
        gw = None
        xk = x if w is None else (project(x, w) if need_a else None)
        wk, flags = None, 2 * (gx is not None)
    flags += int(need_a)
    part = (torch.empty(plan.parts, f * h, dtype=torch.float32, device=dev)
            if plan.parts else None)
    stream = stream_handle(dev)
    counter = election_counters("adj_matmul_backward", dev, stream, 1) if plan.parts else None
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        code = fn(adj.data_ptr(), ptr(xk), ptr(wk), ptr(out), grad.data_ptr(), ptr(gx),
                  ptr(gw), ptr(ga), ptr(part), ptr(counter), batch, n, m, h, f or 0,
                  0.0 if leak is None else float(leak), int(leak is not None), flags,
                  CUDA_DTYPES[x.dtype], ctypes.pointer(plan.as_c()), stream)
    raise_on_error("adj_matmul_backward", code)
    return ga, gx, gw


fused_adj_matmul_backward.launches = 0


@functools.lru_cache(maxsize=None)
def _backward_capacity(index: int) -> dict:
    lib = build.load("adj_matmul_backward", _BACKWARD_SIGNATURES)
    held = {}
    with torch.cuda.device(index):
        for dtype, variant in ((0, "simt"), (1, "tc")):
            held[variant] = {}
            for split in (1, 2, 4, 8):
                count = ctypes.c_int(0)
                raise_on_error("adj_matmul_backward", lib.adj_matmul_backward_max_clusters(
                    dtype, split, ctypes.byref(count)))
                held[variant][split] = count.value
    return held


def backward_cluster_capacity(device: torch.device) -> dict:
    """How many clusters of 1, 2, 4 and 8 blocks of each tiled backward
    variant the card holds at once, as ``H100_BWD_CLUSTERS``
    (cudaOccupancyMaxActiveClusters, asked once per card)."""
    return _backward_capacity(torch.cuda.current_device() if device.index is None
                              else device.index)


class _AdjMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, adj, x, w, leak):
        out = blocked_adj_matmul(adj, x, leak, w)
        ctx.save_for_backward(adj, x, w, None if leak is None else out)
        ctx.leak = leak
        return out

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[:3]
        if not any(needs):
            return None, None, None, None
        adj, x, w, out = ctx.saved_tensors
        return fused_adj_matmul_backward(grad.contiguous(), adj, x, out, ctx.leak, w,
                                         needs) + (None,)


def adj_matmul(adj: torch.Tensor, x: torch.Tensor, leak: Optional[float] = None,
               w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The differentiable A @ X, or A @ (X W) (+ lrelu): forward K3
    (``blocked_adj_matmul``), backward ``fused_adj_matmul_backward`` for the
    inputs that need a gradient."""
    return _AdjMatmul.apply(adj, x, w, leak)
