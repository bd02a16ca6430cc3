#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (snd_vae_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one output line each:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds every kernel from csrc/ (sm_90a), in parallel;
 2b. native  — the native data-path library (utils/native.py) built with
               the host's C++ compiler (which one, and the seconds): S =
               10 spanning trees per graph of the synthetic2 and protein
               train splits (N = 25, 50), each inside A, symmetric, with N
               - c edges for A's c components and spanning each (a forest
               where A is disconnected), two calls bit-equal, the host ms
               of the native and numpy samplers; pairwise_distances within
               1e-12 of numpy in float64;
  3. kernels — the timing floor (a one-element fill_ timed the same way);
               each kernel against its plain PyTorch version on the card at
               the shapes the paths give it (and large ones), with its
               median device time over 100 launches, the plain version's,
               the least time the card could take (bound), for K3 the
               library calls' (torch.matmul for x @ W, torch.bmm / torch.mm,
               leaky_relu), and the time of the chain each replaced: for
               motif_level3 the projections, motif_combine, lrelu and j-sum;
               for K3 with W the separate x @ W and K3.  motif_level3 also
               at the joint model's shapes over synthetic2 truth graphs and
               at scene's over a directed A of integer weights 0..4; the
               level-3 backward against its closed-form plain version and
               the autograd chain it replaced, all eight gradients, at those
               shapes, the mesh's row windows and larger ones, with each of
               its kernels' device ms (profiler), its kernels per call (1 on
               the model's path, 2 where dA or dphi is asked) and two calls
               bit-equal; K3's backward at every K3 shape and a graph with
               zero rows (the tie), for the gradients {W} and {x, W} (no
               W: {x}), against its closed-form plain version (f32 within
               each gradient's float64 summation bound, bf16 within 2e-2),
               two calls bit-equal, with the replaced autograd chain's ms
               and kernels timed in turns with it, the plan that ran
               (small / simt / tc, the i-split, TMA flags) and the
               library's ms (torch.matmul(A^T, gy) on a precomputed gy,
               and the W products where W is fused);
  4. serve   — synthetic2 at full width: reconstruct 5 batches of
               10 graphs x 10 trees and sample 100 graphs, counting the
               kernel launches (motif_level3 and adj_matmul twice per
               batch, motif_combine and the level-3 backward never), each
               entry point turning TF32 off itself; one batch against the same
               weights on the CPU (plain versions); graphs/s in float32
               and bfloat16;
  5. train   — synthetic2 at full width on the generated train split (200
               graphs, 20 steps an epoch), f32 and bf16 with f32 masters:
               Trainer.run for 2 epochs with Adam from the seed weights,
               counting the launches (motif_level3, adj_matmul and their
               backwards twice per step, motif_combine and K3's plain
               version never), finite
               losses falling from the
               first epoch to the second; in f32 one step on the card
               against the same step on the CPU (loss, every gradient and
               updated parameter); steps/s and graphs/s over 2 epochs after
               a warm-up epoch, the peak of allocated memory, and a profile
               of 5 steps: kernels and device-busy ms per step, device ms of
               the forward, backward and optimizer ranges, the device
               events no host op launched, the level-3 backward (K2's
               kernel), K3's backward and the top backward kernels; then
               each backward kernel against the autograd chain it
               replaced, in turns: kernels, device-busy and the backward's
               ms and kernels per step;
 5b. graphs  — the default dispatch of Trainer.run (the first step eager,
               every later one a replay of its CUDA graph) against
               per_step=True, from the seed weights, for synthetic2 f32
               and bf16, the joint model with dropout (keep 0.8), protein
               (100 graphs) and synthetic2 with remat: 2 epochs of each
               from identical Trainers equal bit for bit (every aux value,
               parameter, Adam moment and count, the step, the
               generator), the wrappers' launches (per step: 2 a step;
               graphs: the eager step and the capture), a profiled
               replayed epoch's kernel records by name (2 each of K1, K2,
               K3 and K3's backward a synthetic2 step, protein 0/2/0/2,
               remat 4/2/2/2 as K1/K3/K2/K3b, no motif_combine; the
               model's kernels equal per step's), 3 timed epochs of each
               in turns (steps/s, graphs/s, device-busy ms and busy share,
               the capture's seconds, peak memory); for synthetic2 f32
               also cuDNN's deterministic algorithms against its default
               picks (per-step steps/s in turns), epoch_chunk=2 over 4
               epochs against 4 one-epoch dispatches, and 3 epochs
               against 2, a checkpoint and a resume, bit for bit;
  6. joint_serve — the joint model ("base") at synthetic2 width, as 4. (2
               motif_level3 per batch, no adj_matmul, no motif_combine);
  7. joint_train — the joint model: Trainer.run for 2 epochs in f32 (2
               motif_level3 per step), the loss falling, one step on the
               card against the CPU's, one step at dropout keep 0.8 run
               twice from one generator seed, a profile of 5 steps;
  8. scene   — the scene preset (joint model, K-way edges, categorical
               node head) on the seeded fallback data: one reconstructed
               batch on the card against the CPU, 3 train steps;
  9. geoGCN, posGCN — one reconstructed batch each at synthetic2 width on
               the card against the CPU (adj_matmul twice, no motif conv);
 10. separable — the disentangled synthetic2 widths at num_nodes 128: the
               separable adjacency head against the dense one on the card,
               the card against the CPU, both heads' device ms;
 11. protein — the disentangled model at the protein preset (B = 50 x S =
               10 trees, N = 50, the fourth-order conv) on the seeded
               fallback: serve 2 batches f32 and bf16 (adj_matmul and K4
               twice per batch), the card against the CPU on 2 graphs, each
               motif conv's device ms (sg_conv.<i> ranges) beside the
               chain's bound, peak memory; K4 and its backward at both
               layers' shapes against the plain pair, with their bounds
               (kernel lines); Trainer.run on 100
               graphs (2 steps an epoch), a counted and a timed epoch, f32
               and bf16, the card's step against the CPU's;
 12. protein_blocked — layer 2 of the protein conv unblocked against
               block_rows=10, and the third-order layer 2 at synthetic2
               against block_rows=5: outputs equal, gradients as close to
               float64 as the unblocked ones, peak memory (the blocked one
               lower; the third order's backward keeps no [B,n,N,h] tensor,
               below the replaced backward's peaks) and device ms of each;
 13. protein_joint, mnist — the joint model on protein (K4 twice) and
               the disentangled model at the mnist preset (adj_matmul and
               K4 twice):
               one batch against the CPU, 3 train steps, the card's step
               against the CPU's;
 14. eval    — synthetic2, disentangled, f32: Trainer.run for 2 epochs
               with eval_every=1 on the test split (2 + 2 launches per step
               and per eval batch), the best checkpoint and best.json, one
               evaluate_heldout counted and timed, its metrics against a CPU
               Trainer's on the same weights (edge AUC/AP within 1e-4, MSEs
               at rtol 1e-4);
 15. remat   — one f32 step without remat, with --remat, recompute-big and
               dots-no-batch for synthetic2 (disentangled and joint) and
               protein: the loss at rtol 1e-6, every gradient held to a
               float64 step on the CPU (at most twice the unremat error,
               plus 1e-7 of the largest gradient), the launches (4 of
               motif_level3, and on protein of K4, with remat: the
               recompute launches again); at
               protein's full batch each variant and --remat
               --motif-block-rows 10: ms per step and peak memory;
 16. cli_eval — the CLI in-process: train with --eval-every, then
               test_reconstruct, test_generation, test_disentangle (each
               mode), the joint model's test_disentangle and sweep, every
               metric and grid finite; the figures test_reconstruct and
               test_disentangle draw (figures/reconstruct_, latent_ and
               traverse_synthetic2.png) decoded with zlib (IHDR / IDAT /
               IEND and their CRCs), at matplotlib's pixel size for the
               figure, with drawn pixels; the ms each drawing took;
 16b. cli_profile — the CLI's --type train --epochs 2 --profile at
               synthetic2 full width in a process of its own, on the
               default dispatch: the torch.profiler trace of epoch 1 holds
               one train_epoch range over its 20 replays and 40
               motif_level3, 40 of its backward, 40 adj_matmul, 40 of its
               backward and no motif_combine kernel events; the counts
               written beside it the trace's own (20 replays, each with a
               record of every kernel, memcpy and memset node of the
               graph, none missing); the traced epoch's wall time and its
               train_epoch range against an untraced replayed f32 epoch
               of phase 5b;
 16c. trace_twice — in this process, which has traced before: eight
               Trainers' Trainer.run(profile_dir=...) on 40 graphs (the
               first per step, seven on the default dispatch, tracing
               replays), each trace's kernel events equal to the wrappers'
               launches in the traced epoch, and the counts Trainer.run
               wrote beside it equal to the trace's own, none missing; a
               bare profiler (no warm-up) and one warmed
               up on four tiny kernels beside them, reported; host
               launches without a kernel record and when they ran;
 17. large_graph — in an NCCL process group of one (a FileStore in a
               temporary directory) and ``make_mesh(1, 1)``: the
               node-sharded GCN encoder (hidden 128, 128) on symmetric
               graphs of density 0.01 at N = 2048 and 8192, F = 128,
               normalized by ``sharded_gcn_normalize``, with K3 (2 launches
               per apply) and with the library contraction (none), f32 and
               bf16: each f32 layer within the summation bound of a float64
               run, bf16 within 2e-2 of the library path, the card against
               the CPU at N = 2048; device ms per apply and per layer with
               each layer's bound, K3 alone beside its plain version and
               torch.mm + leaky_relu, the normalize's ms, peak memory; the
               kernels' gradients through K3's backward (2 launches) against
               the library path's;
 18. dp      — the data-parallel Trainer on that mesh at synthetic2 full
               width, 2 epochs f32 per step: 2 + 2 launches per step,
               per-epoch losses equal to a mesh-less Trainer's at rtol
               1e-6, the steps/s of both in turns; and its default
               dispatch on the mesh (CUDA-graph replays, the NCCL
               collectives in the graph): 2 epochs from a fresh Trainer
               bit-equal to the per-step run, epoch_chunk=2 and a resume
               bit-equal, 2 / 2 / 2 / 2 kernel records a replayed step,
               steps/s and busy share of both dispatches in turns, the
               capture's seconds and peak memory;
 18b. tp     — the mesh's model axis: K1's row windows at m = 2 and 4
               ([100,25,25,50] f32 and bf16, [4,256,256,50] f32; every
               rank's window against ``_level3_rows`` on its rows, the
               windows put together against the full launch, device ms per
               window, each a ``kernel`` line); one rank's rows of the
               third-order conv's layer 2 at N = 256 for m = 1, 2, 4 (peak
               memory, device ms); E2E layer 2 of the frontier on rank 0's
               and rank 3's rows at m = 4, f32 and bf16 (at N = 512 held
               against the whole map's rows and gradients; at N = 2048
               device ms and device-busy ms, the backward's kernels and the
               peak, each f32 rank faster than the whole map's forward and
               backward);
               the Trainer at synthetic2 full width on
               that mesh through the model-axis code, 2 + 2 launches per
               step (per step: the hint sites' reports come from its
               steps), per-epoch losses equal to a mesh-less Trainer's at
               rtol 1e-6 beside two mesh-less runs' spread; its default
               dispatch against it, as in the dp phase;
 19. cli_dp  — ``torchrun --standalone --nproc_per_node 1 -m
               snd_vae_tpu_torch.cli --type train --dp 1 --distributed
               --epochs 1 --profile`` in a subprocess: it joins, says it
               dispatches CUDA-graph replays, trains to a finite loss and
               writes one checkpoint; its trace of the one epoch (the eager
               step, the capture, 19 replays) misses no device record;
 19b. frontier — the JAX package's single-chip frontier configuration
               (benchmarks/frontier_2048.py:43-47: synthetic2's widths,
               num_nodes N, B = 2 graphs x S = 2 trees, the separable head
               by the auto rule) through the port's entry points: (a) at N
               = 256 f32 one train step on the card against the CPU's
               (phase 5's tolerances) and one reconstructed batch; for each
               variant, N = 1024 f32 and bf16, N = 2048 bf16 and f32 with
               --remat and --motif-block-rows 256, first one train step
               without remat from the seed weights (2 launches of each
               kernel; its loss terms and peak memory), then (b)
               Trainer.run: 2 epochs on 4 graphs at N = 1024, one step on
               2 graphs at N = 2048, where the untrained loss is not finite
               and any later step would run on NaN weights (2 launches a
               step of each kernel, motif_level3 4 with remat; K3's plain
               version never; the losses finite but at N = 2048, f32's
               epoch mean falling; ms per step, device-busy ms and kernels
               per step from a profile of the last epoch; the peak of
               allocated memory); (c) where the first step's loss is not
               finite (allowed at N = 2048 alone), the first tensor that is
               not, by module, and the CPU's graph KL on the same weights
               and batch, which must not be finite either; (d) every call
               the first step makes of the four kernels (its arguments kept
               in host memory), held against its plain version on the card
               (f32 within the float64 summation bound, bf16 within 2e-2,
               two calls bit-equal; a backward whose step's gradient is not
               finite on a seeded one) with the plan that ran; (e) a kernel
               line for each: median device ms over 100 launches, the
               bound, the plain version's ms (10 calls) and, for K3 and its
               backward, the library's; (f) serve.reconstruct of one batch
               and serve.sample of 2 graphs at N = 2048 f32 (2 + 2 launches
               a batch, finite outputs, peak memory, the call's ms); (g)
               the remat run's loss terms against the first step's without
               remat (rtol 1e-6), both peaks; the phase's seconds;
 20. the launches per path (profile_train: the kernel events in the
               trace of 16b) and the kernels line (JSON); 21. the result
               line (JSON), last.

NCCL refuses two ranks on one card, so this script runs the parallel
layer's collectives in a group of one; runs with more than one rank
happen in the CPU tests (gloo: tests/test_torch_parallel.py,
test_torch_large_graph.py, test_torch_dp_train.py).

Each path's launches are counted from 0 just before it runs and read just
after; K3's plain version is counted too (a wrapper this script installs)
and no path may call it.  Any failed check raises: the script then exits non-zero without a
result line.  Without a CUDA card, or without the rest of the repository beside it,
it fails before printing anything.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import torch

ROOT = Path(__file__).resolve().parent
REPS = 100
SPIN_CYCLES = 1_000_000   # a device-side spin before each timed launch hides the host's enqueue
HBM_BYTES_PER_S = 3.35e12                                      # H100 SXM, data sheet
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}  # f32 CUDA cores; bf16 tensor cores
SERVE_BATCHES = 5
SAMPLE_GRAPHS = 100
SHORT_TRAIN_STEPS = 3     # scene, protein_joint and mnist
PROTEIN_SERVE_BATCHES = 2
PROTEIN_TRAIN_GRAPHS = 100
SEPARABLE_NODES = 128
TRAIN_EPOCHS = 2          # the counted run; then 1 warm-up and 2 timed epochs
GRAPH_EPOCHS = 2          # graphs: the epochs each dispatch trains from the seed weights
PROFILE_STEPS = 5
L3_SOURCE = "snd_vae_tpu_torch/nn/kernels/csrc/motif_level3.cu"
L3B_SOURCE = "snd_vae_tpu_torch/nn/kernels/csrc/motif_level3_backward.cu"
K1_SOURCE = "snd_vae_tpu_torch/nn/kernels/csrc/motif_combine.cu"
K3_SOURCE = "snd_vae_tpu_torch/nn/kernels/csrc/adj_matmul.cu"
K1_REPLACES = "snd_vae_tpu/nn/pallas/blocked_spmm.py:204"
K2_REPLACES = "snd_vae_tpu/nn/pallas/blocked_spmm.py:295"
# kernels per call of the level-3 backward: on the model's path, and where
# ∂A or ∂φ is asked (the contractions' second kernel)
BACKWARD_KERNELS = 1
BACKWARD_KERNELS_CONTRACT = 2
# the level-3 backward's gradients on the model's path: a_i, v_j, M1d, M1f, bias
MODEL_NEEDS = (False, False, True, True, False, True, True, True)
K3_REPLACES = "snd_vae_tpu/nn/pallas/blocked_spmm.py:89"
K3B_SOURCE = "snd_vae_tpu_torch/nn/kernels/csrc/adj_matmul_backward.cu"
K3B_TPU_FN = "blocked_adj_matmul (no backward in JAX: jax.vjp of GraphConv)"
K3B_REPLACED = "autograd through adj_matmul_plain (snd_vae_tpu_torch/nn/kernels/adj_matmul.py)"
K4_SOURCE = "snd_vae_tpu_torch/nn/kernels/csrc/motif_level4.cu"
K4B_SOURCE = "snd_vae_tpu_torch/nn/kernels/csrc/motif_level4_backward.cu"
K4_TPU_FN = "none: XLA ops (levels 4 and 3 of spatial_graph_conv_3d)"
K4_REPLACES = "snd_vae_tpu/nn/spatial_conv.py:401-562"


# wall seconds by phase: the time up to each emitted line from the line
# before (the first from the import), summed over the phase's lines
PHASE_SECONDS: dict = {}
_LAST_EMIT = [time.perf_counter()]


def emit(phase: str, payload) -> None:
    print(f"{phase}: {json.dumps(payload)}", flush=True)
    now = time.perf_counter()
    PHASE_SECONDS[phase] = PHASE_SECONDS.get(phase, 0.0) + now - _LAST_EMIT[0]
    _LAST_EMIT[0] = now


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def count_plain_calls(am) -> None:
    """Wrap ``adj_matmul_plain`` so that ``read_counts`` sees its calls: K3's
    plain version, which no path on the card may call (its backward was
    autograd through it before it had a kernel).  Installed by ``main``
    only; the package has no such switch."""
    plain = am.adj_matmul_plain

    def counted(*args, **kwargs):
        counted.calls += 1
        return plain(*args, **kwargs)

    counted.calls = 0
    am.adj_matmul_plain = counted


def zero_counts(ml, mc, am) -> None:
    from snd_vae_tpu_torch.nn.kernels import motif_level4 as m4

    ml.fused_motif_level3.launches = mc.fused_motif_combine.launches = 0
    ml.fused_motif_level3_backward.launches = am.blocked_adj_matmul.launches = 0
    am.fused_adj_matmul_backward.launches = 0
    m4.fused_motif_level4.launches = m4.fused_motif_level4_backward.launches = 0
    if hasattr(am.adj_matmul_plain, "calls"):
        am.adj_matmul_plain.calls = 0


def read_counts(ml, mc, am) -> dict:
    from snd_vae_tpu_torch.nn.kernels import motif_level4 as m4

    torch.cuda.synchronize()
    return {"motif_level3": ml.fused_motif_level3.launches,
            "motif_level3_backward": ml.fused_motif_level3_backward.launches,
            "motif_combine": mc.fused_motif_combine.launches,
            "adj_matmul": am.blocked_adj_matmul.launches,
            "adj_matmul_backward": am.fused_adj_matmul_backward.launches,
            "adj_matmul_plain": getattr(am.adj_matmul_plain, "calls", 0),
            "motif_level4": m4.fused_motif_level4.launches,
            "motif_level4_backward": m4.fused_motif_level4_backward.launches}


def per(n: int, ml3: int = 0, k3: int = 0, bwd: int = 0, k3b: int = 0, k4: int = 0,
        k4b: int = 0) -> dict:
    """The launches n batches or steps should count (``bwd``: calls of
    the level-3 backward; ``k3b``: of K3's backward; ``k4``, ``k4b``: of
    K4 and its backward); K3's plain version is never called."""
    return {"motif_level3": n * ml3, "motif_level3_backward": n * bwd, "motif_combine": 0,
            "adj_matmul": n * k3, "adj_matmul_backward": n * k3b, "adj_matmul_plain": 0,
            "motif_level4": n * k4, "motif_level4_backward": n * k4b}


def device_ms(fn, reps: int = REPS) -> float:
    """Median device time of one call, from CUDA events around each call;
    a spin kernel queued before each call keeps the card from waiting on
    the host, so the events time the device work alone."""
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def busy_ms(fn, reps: int = 5) -> dict:
    """The device-busy ms (the sum of kernel times, from the profiler) and
    the kernels of one call, over ``reps`` calls after a warm-up: where a
    call launches many kernels, ``device_ms``'s events also count the
    card's waits on the host between them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    return {"busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3 / reps,
            "kernels": sum(e.count for e in kernels) / reps}


def host_top_ops(fn, reps: int = 5, k: int = 8) -> list:
    """The host ops with the most self CPU time per call (profiler, CPU
    activity; the profiler's own cost inflates them), over ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    return [[e.key[:70], e.self_cpu_time_total / 1e3 / reps, e.count / reps]
            for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:k]]


def bound(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(got, want, dtype) -> float:
    """f32: rtol/atol 1e-5 (the sums run in another order); bf16: max abs
    error within 2e-2 of the reference's largest magnitude."""
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        check(err <= 2e-2 * want.float().abs().max().item(), f"bf16 error {err}")
    return err


def compare_f64_bound(got, inputs, n_terms: int, plain) -> tuple:
    """An f32 kernel against its plain version in float64 on the same
    inputs: the error must stay within (n_terms + 8)·2^-24 times the sum of
    the terms' magnitudes (the plain version on |inputs|), the worst-case
    rounding of an f32 sum of that many terms.  K1 sums N terms over k.
    motif_level3 sums N terms into rf, R + 1 into each of the deg and the
    v_j sides of m3 and then N over j; lrelu is 1-Lipschitz and passes an
    error on unchanged, and each product by A or deg adds one rounding, so
    n_terms = 2N + 2R + 2.  On a dense large graph the terms reach ~10², so a
    fixed atol of 1e-5 would only measure the f32 plain version's own
    rounding; its error against float64 is returned beside the kernel's."""
    x64 = [t.double() for t in inputs]
    want = plain(*x64)
    mag = plain(*[t.abs() for t in x64])
    err = (got.double() - want).abs()
    check(bool((err <= (n_terms + 8) * 2.0 ** -24 * mag).all()),
          f"f32 error {err.max().item()} beyond the f32 summation bound")
    plain_err = (plain(*inputs).double() - want).abs().max().item()
    return err.max().item(), plain_err


def motif_inputs(B, N, h, dtype, gen, density):
    adj = (torch.rand(B, N, N, generator=gen, device="cuda") < density).float().triu(1)
    adj = adj + adj.transpose(1, 2)
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    return [t.to(dtype).contiguous() for t in
            (adj, rn(B, N, h), rn(B, N, N, h), rn(B, N, h), rn(B, N, N, h), rn(h))]


def level3_inputs(B, N, h, R, dtype, gen, density, weighted=False, adj=None, rel=None):
    """adj, φ(rel), a_i, v_j, deg, M1d, M1f, bias; weights at 0.3 so m3 stays
    near the served layer's magnitudes.  ``weighted``: A's edges carry
    weights in [0, 1).  ``adj`` / ``rel`` given: those, as they are."""
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    if adj is None:
        adj = (torch.rand(B, N, N, generator=gen, device="cuda") < density).float().triu(1)
        if weighted:
            adj = adj * torch.rand(B, N, N, generator=gen, device="cuda")
        adj = adj + adj.transpose(1, 2)
    if rel is None:
        rel = rn(B, N, N, R)
    return [t.to(dtype).contiguous() for t in
            (adj, torch.maximum(rel, 0.2 * rel), rn(B, N, h), rn(B, N, h), adj.sum(-1),
             0.3 * rn(R, h), 0.3 * rn(R, h), 0.3 * rn(h))]


def replaced_chain(mc, adj, phi_r, a_i, v_j, deg, m1d, m1f, bias):
    """What the served path ran at level 3 before motif_level3: the d_ij /
    f_ik projections, the motif_combine kernel, lrelu and the j-sum."""
    m3 = mc.fused_motif_combine(adj, a_i, phi_r @ m1d, v_j, phi_r @ m1f, bias)
    return torch.einsum("bij,bijh->bih", adj, torch.maximum(m3, 0.2 * m3))


class _MotifLevel3Autograd(torch.autograd.Function):
    """The level-3 backward that the backward kernel replaced, for the
    measurements that compare it with the kernel and for nothing else: the forward
    is the package's (one ``motif_level3`` launch), the backward autograd
    through the plain level 3 (``_level3_rows``), recomputed one i-row block
    of ``block_rows`` at a time."""

    @staticmethod
    def forward(ctx, block_rows, row0, *inputs):
        from snd_vae_tpu_torch.nn.kernels import motif_level3 as ml

        ctx.block_rows, ctx.row0 = block_rows, row0
        ctx.save_for_backward(*inputs)
        return ml.fused_motif_level3(*inputs, row0)

    @staticmethod
    def backward(ctx, grad):
        from snd_vae_tpu_torch.nn.kernels import motif_level3 as ml

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
            e = min(s + step, n)
            with torch.enable_grad():
                out = ml._level3_rows(adj, adj[:, r0 + s:r0 + e], phi_r[:, s:e], a_i[:, s:e],
                                      *shared)
            part = torch.autograd.grad(out, wanted, grad[:, s:e])
            got = part if got is None else [g + p for g, p in zip(got, part)]
        got = iter(got)
        return (None, None) + tuple(next(got) if t.requires_grad else None for t in inputs)


class replaced_backward:
    """A context in which the third-order conv's level 3 runs the replaced
    backward (``_MotifLevel3Autograd``), for measurements in turns."""

    def __enter__(self):
        import snd_vae_tpu_torch.nn.spatial_conv as sc

        self.saved = sc.motif_level3
        sc.motif_level3 = lambda *x, block_rows=None, row0=0: _MotifLevel3Autograd.apply(
            block_rows, row0, *x)

    def __exit__(self, *exc):
        import snd_vae_tpu_torch.nn.spatial_conv as sc

        sc.motif_level3 = self.saved


def level3_bound(x, dtype, row0: int = 0):
    """Bytes: every input once, nt once.  Operations: what these inputs
    need, i.e. rf only at pairs with A[i,j] != 0 and over k with
    A[j,k] != 0, and the epilogue's 4R+7 FLOP per (i,j,h) with A[i,j] != 0.
    A row window (φ(rel) and a_i holding rows [row0, row0 + n)) counts the
    pairs of its rows i."""
    adj, phi_r, a_i = x[0], x[1], x[2]
    R, h, n = phi_r.shape[-1], a_i.shape[-1], phi_r.shape[1]
    nz = (adj != 0).double()
    rows = nz[:, row0:row0 + n]
    rf_ops = 2 * R * (rows.sum(1) * nz.sum(2)).sum().item()
    epi_ops = rows.sum().item() * h * (4 * R + 7)
    nbytes = sum(t.numel() for t in x) * x[0].element_size() + a_i.numel() * a_i.element_size()
    return bound(nbytes, rf_ops + epi_ops, dtype)


def adj_inputs(a_shape, x_shape, dtype, gen, density):
    adj = (torch.rand(*a_shape, generator=gen, device="cuda") < density).float()
    x = torch.randn(*x_shape, generator=gen, device="cuda")
    return adj.to(dtype), x.to(dtype)


def check_kernels(ml, mc, am):
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    # motif_level3: the served path's two layers (h = 20, 50 at B·S = 100
    # trees of N = 25, R = 1), bf16, a dense large graph held against
    # float64, and two cases off the served path for the general code: R = 2
    # with a weighted A at ragged N and h, and several j-tiles, k-chunks and
    # h chunks with 16-byte copies
    for B, N, h, R, dt, served, ref64, weighted in (
            (100, 25, 20, 1, torch.float32, True, False, False),
            (100, 25, 50, 1, torch.float32, True, False, False),
            (100, 25, 50, 1, torch.bfloat16, False, False, False),
            (4, 256, 50, 1, torch.float32, False, True, False),
            (3, 29, 37, 2, torch.float32, False, True, True),
            (2, 72, 75, 2, torch.float32, False, True, False)):
        x = level3_inputs(B, N, h, R, dt, gen, 0.4, weighted)
        got = ml.fused_motif_level3(*x)
        extra = {"R": R, "weighted": weighted}
        if ref64:
            err, extra["plain_f32_err_vs_f64"] = compare_f64_bound(
                got, x, 2 * N + 2 * R + 2, ml.motif_level3_plain)
        else:
            err = compare(got, ml.motif_level3_plain(*x), dt)
        extra["max_abs_diff_vs_replaced"] = (
            got.float() - replaced_chain(mc, *x).float()).abs().max().item()
        b_ms, b_by = level3_bound(x, dt)
        rows.append(dict(kernel="motif_level3", shape=[B, N, h], dtype=str(dt)[6:],
                         served=served, batch_shape=served, max_abs_err=err,
                         ms=device_ms(lambda: ml.fused_motif_level3(*x)),
                         plain_ms=device_ms(lambda: ml.motif_level3_plain(*x)),
                         replaced_ms=device_ms(lambda: replaced_chain(mc, *x)),
                         bound_ms=b_ms, bound_by=b_by, library_ms=None, **extra))
    rows += check_level3_new_inputs(ml, mc, gen)
    rows += check_level3_backward(ml, gen)
    # K1, off the served path since motif_level3: the shapes the served
    # layers would give it (h = 20, 50 at B·S = 100 trees of N = 25), bf16,
    # and a dense large graph held against float64
    for B, N, h, dt, layer, ref64 in ((100, 25, 20, torch.float32, True, False),
                                      (100, 25, 50, torch.float32, True, False),
                                      (100, 25, 50, torch.bfloat16, False, False),
                                      (4, 256, 50, torch.float32, False, True)):
        x = motif_inputs(B, N, h, dt, gen, 0.4)
        got = mc.fused_motif_combine(*x)
        extra = {}
        if ref64:
            err, extra["plain_f32_err_vs_f64"] = compare_f64_bound(
                got, x, N, mc.motif_combine_plain)
        else:
            err = compare(got, mc.motif_combine_plain(*x), dt)
        isz = x[0].element_size()
        b_ms, b_by = bound(isz * (B * N * N + 2 * B * N * h + 3 * B * N * N * h + h),
                           2 * B * N ** 3 * h + 6 * B * N * N * h + B * N * N, dt)
        rows.append(dict(kernel="motif_combine", shape=[B, N, h], dtype=str(dt)[6:],
                         served=False, batch_shape=layer, max_abs_err=err,
                         ms=device_ms(lambda: mc.fused_motif_combine(*x)),
                         plain_ms=device_ms(lambda: mc.motif_combine_plain(*x)),
                         bound_ms=b_ms, bound_by=b_by, library_ms=None, **extra))
    rows += check_adj_matmul(am, gen)
    rows += check_adj_matmul_backward(am, gen)
    torch.cuda.synchronize()
    return rows


def check_level3_new_inputs(ml, mc, gen):
    """motif_level3 on the inputs the joint model gives it: its two layers
    (h = 20, 50) over B = 10 synthetic2 truth graphs and their distances
    (denser than spanning trees), f32 at rtol/atol 1e-5; and scene's
    [2,10,10,20|50] over a directed A of integer weights 0..4 (zero
    diagonal; the kernel reads row j of A for rf and row i for the mask and
    the j-sum, so an asymmetric A shows any assumed symmetry), f32 against
    float64 within the summation bound, and bf16."""
    from snd_vae_tpu_torch.config import synthetic2_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset

    truth = load_dataset(synthetic2_preset(dataset_path=str(ROOT / "dataset")), "test",
                         num_graphs=10, device="cuda")
    rows = []
    scene_adj = torch.randint(0, 5, (2, 10, 10), generator=gen, device="cuda").float()
    scene_adj *= 1.0 - torch.eye(10, device="cuda")
    check(not torch.equal(scene_adj, scene_adj.transpose(1, 2)), "scene A is asymmetric")
    scene_rel = 10.0 * torch.rand(2, 10, 10, 1, generator=gen, device="cuda")
    for path, h, dt in (("joint", 20, torch.float32), ("joint", 50, torch.float32),
                        ("scene", 20, torch.float32), ("scene", 50, torch.float32),
                        ("scene", 50, torch.bfloat16)):
        adj, rel = (truth.adj, truth.rel) if path == "joint" else (scene_adj, scene_rel)
        B, N, R = adj.shape[0], adj.shape[1], rel.shape[-1]
        x = level3_inputs(B, N, h, R, dt, gen, None, adj=adj, rel=rel)
        got = ml.fused_motif_level3(*x)
        extra = {"R": R, "density": (adj != 0).float().mean().item(),
                 "symmetric": bool(torch.equal(adj, adj.transpose(1, 2))),
                 "weights": sorted(set(adj.unique().tolist()))}
        if path == "scene" and dt == torch.float32:
            err, extra["plain_f32_err_vs_f64"] = compare_f64_bound(
                got, x, 2 * N + 2 * R + 2, ml.motif_level3_plain)
        else:
            err = compare(got, ml.motif_level3_plain(*x), dt)
        b_ms, b_by = level3_bound(x, dt)
        rows.append(dict(kernel="motif_level3", path=path, shape=[B, N, h], dtype=str(dt)[6:],
                         served=False, batch_shape=False, max_abs_err=err,
                         ms=device_ms(lambda: ml.fused_motif_level3(*x)),
                         plain_ms=device_ms(lambda: ml.motif_level3_plain(*x)),
                         replaced_ms=device_ms(lambda: replaced_chain(mc, *x)),
                         bound_ms=b_ms, bound_by=b_by, library_ms=None, **extra))
    return rows


GRAD_NAMES = ("adj", "phi_r", "a_i", "v_j", "deg", "m1d", "m1f", "bias")


def grad_terms(name, B, n, N, R, h) -> int:
    """The longest f32 sum behind one element of a level-3 gradient: rf's N
    terms and m3's 2R + 2 feed every P; then ∂a_i sums N, ∂v_j n, ∂deg
    n·h, the parameters B·n·N, ∂φ N (over j) beside grf's h, ∂A n·R beside
    the local terms' h."""
    depth = N + 2 * R + 8
    return depth + {"adj": n * R + h, "phi_r": N + h, "a_i": N, "v_j": n, "deg": n * h,
                    "m1d": B * n * N, "m1f": B * n * N, "bias": B * n * N}[name]


def replaced_grads(ml, g, x, row0, needs):
    """The replaced chain: autograd through the plain level 3 of the
    window's rows, for the inputs ``needs`` asks for."""
    xs = [t.detach().requires_grad_(nd) for t, nd in zip(x, needs)]
    n = x[1].shape[1]
    with torch.enable_grad():
        out = ml._level3_rows(xs[0], xs[0][:, row0:row0 + n], *xs[1:])
    got = iter(torch.autograd.grad(out, [t for t in xs if t.requires_grad], g))
    return [next(got) if nd else None for nd in needs]


def level3_peaks(ml, x, g) -> dict:
    """Peak allocated bytes above the inputs of level 3's forward plus
    backward (the model's gradients) with the backward kernel and with the
    replaced backward (``_MotifLevel3Autograd``), unblocked and at
    block_rows=5."""
    out = {}
    for name, fn in (("kernel", ml.motif_level3),
                     ("replaced", lambda *a, block_rows: _MotifLevel3Autograd.apply(
                         block_rows, 0, *a))):
        for block in (None, 5):
            leaves = [t.detach().requires_grad_(need) for t, need in zip(x, MODEL_NEEDS)]
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            torch.autograd.grad(fn(*leaves, block_rows=block),
                                [t for t in leaves if t.requires_grad], g)
            torch.cuda.synchronize()
            out[f"{name}_block_{block}"] = torch.cuda.max_memory_allocated() - base
    check(max(out["kernel_block_None"], out["kernel_block_5"]) < out["replaced_block_None"],
          f"level-3 forward + backward peaks {out}")
    return out


def backward_kernels_ms(ml, fn, calls: int = 20, takes: int = 3):
    """The level-3 backward's kernels that calls of ``fn`` launch, by
    name: device ms per launch and launches per call (profiler, over
    ``calls`` calls; the wrapper's count is restored after), and the traces
    taken.  The profiler first takes a discarded warm-up step, one call of
    ``fn``, as the Trainer's tracing warms up on its epoch's first step's
    kernels: a trace in a process that has traced before may lose the
    records of the first kernels launched after the device's tracing
    turns on (PERF.md, faults 3.2 and 3.5).  A trace of this phase that
    holds no kernel record at all while the wrapper counted its launches
    is taken again, up to ``takes`` traces."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    before = ml.fused_motif_level3_backward.launches
    fn()
    torch.cuda.synchronize()
    for take in range(1, takes + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True,
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()                 # the warm-up ends, the trace starts
            start = ml.fused_motif_level3_backward.launches
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {e.key.split("<")[0].split("::")[-1]: {
            "ms": e.self_device_time_total / 1e3 / e.count, "launches": e.count / calls}
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and TRACE_KERNEL_NAMES["motif_level3_backward"] in e.key}
        if out or ml.fused_motif_level3_backward.launches - start != calls:
            break
    ml.fused_motif_level3_backward.launches = before
    return out, take


def check_level3_backward(ml, gen):
    """The level-3 backward (``fused_motif_level3_backward``) against
    its closed-form plain version and against the autograd chain it
    replaced, for all eight gradients: f32 within the float64 summation
    bound of each gradient's longest sum (``grad_terms``) against the plain
    version in float64, and within twice that against the chain; bf16
    within 2e-2 of the largest magnitude of the f32 plain version on the
    same inputs, and the chain within 4e-2 of it.  Shapes: synthetic2's two
    layers at [100,25,25] (R = 1, h = 20, 50; f32 and bf16), the joint
    model's at [10,25,25] over synthetic2 truth graphs, scene's [2,10,10]
    over a directed A of weights 0..4, the mesh's row windows (m = 2, 4) at
    [100,25,25,50], and off the path [4,256,256,50] at density 0.4, a
    ragged weighted R = 2 case, several j-tiles and h chunks at R = 2, and
    R = 5 (two channel groups).  Two calls for the model's gradients are
    bit-equal.  Each row: ms for the model's gradients and for all eight,
    each of the backward's kernels' device ms per call by name (profiler;
    ``BACKWARD_KERNELS`` kernels a call for the model's gradients,
    ``BACKWARD_KERNELS_CONTRACT`` for all eight), the plain version's and
    the chain's ms for the model's gradients, the bound of the model's
    gradients, and the calls per train step (one per layer) and per served
    batch (none); at synthetic2's shapes the peak memory of level 3's
    forward plus backward (``level3_peaks``)."""
    from snd_vae_tpu_torch.config import synthetic2_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset
    from snd_vae_tpu_torch.parallel.mesh import node_block

    truth = load_dataset(synthetic2_preset(dataset_path=str(ROOT / "dataset")), "test",
                         num_graphs=10, device="cuda")
    scene_adj = torch.randint(0, 5, (2, 10, 10), generator=gen, device="cuda").float()
    scene_adj *= 1.0 - torch.eye(10, device="cuda")
    scene_rel = 10.0 * torch.rand(2, 10, 10, 1, generator=gen, device="cuda")
    cases = [("synthetic2", 100, 25, 20, 1, torch.float32, True, None, None),
             ("synthetic2", 100, 25, 50, 1, torch.float32, True, None, None),
             ("synthetic2", 100, 25, 50, 1, torch.bfloat16, False, None, None),
             ("joint", 10, 25, 20, 1, torch.float32, False, truth.adj, truth.rel),
             ("joint", 10, 25, 50, 1, torch.float32, False, truth.adj, truth.rel),
             ("scene", 2, 10, 20, 1, torch.float32, False, scene_adj, scene_rel),
             ("scene", 2, 10, 50, 1, torch.float32, False, scene_adj, scene_rel),
             ("scene", 2, 10, 50, 1, torch.bfloat16, False, scene_adj, scene_rel)]
    cases += [(f"tp_window_m{m}", 100, 25, 50, 1, torch.float32, False, None, None, m)
              for m in (2, 4)]
    cases += [("large", 4, 256, 50, 1, torch.float32, False, None, None),
              ("ragged_weighted", 3, 29, 37, 2, torch.float32, False, "weighted", None),
              ("tiles", 2, 72, 75, 2, torch.float32, False, None, None),
              ("channel_groups", 2, 40, 70, 5, torch.float32, False, None, None)]
    rows = []
    for path, B, N, h, R, dt, served, adj, rel, *m in cases:
        weighted = isinstance(adj, str)
        full = level3_inputs(B, N, h, R, dt, gen, 0.4, weighted,
                             adj=None if weighted else adj, rel=rel)
        windows = [node_block(N, m[0], k) for k in range(m[0])] if m else [(0, N)]
        for row0, n in windows:
            x = [full[0], full[1][:, row0:row0 + n].contiguous(),
                 full[2][:, row0:row0 + n].contiguous(), *full[3:]]
            g = torch.randn(B, n, h, generator=gen, device="cuda").to(dt)
            got = ml.fused_motif_level3_backward(g, *x, row0=row0)
            chain = replaced_grads(ml, g, x, row0, (True,) * 8)
            errs = {}
            if dt == torch.float32:
                x64, g64 = [t.double() for t in x], g.double()
                want = ml.motif_level3_backward_plain(g64, *x64, row0=row0)
                mag = ml.motif_level3_backward_plain(g64.abs(), *[t.abs() for t in x64],
                                                     row0=row0)
                plain32 = ml.motif_level3_backward_plain(g, *x, row0=row0)
                for name, k, w, mg, c, p32 in zip(GRAD_NAMES, got, want, mag, chain, plain32):
                    lim = (grad_terms(name, B, n, N, R, h) + 8) * 2.0 ** -24 * mg
                    err = (k.double() - w).abs()
                    check(bool((err <= lim).all()),
                          f"backward {path} {[B, N, h]} {name}: f32 error {err.max().item()} "
                          "beyond the summation bound")
                    diff = (k.double() - c.double()).abs()
                    check(bool((diff <= 2 * lim).all()),
                          f"backward {path} {[B, N, h]} {name}: {diff.max().item()} from the "
                          "replaced chain")
                    errs[name] = {"vs_f64": err.max().item(),
                                  "plain_f32_vs_f64": (p32.double() - w).abs().max().item(),
                                  "vs_replaced": diff.max().item()}
            else:
                want = ml.motif_level3_backward_plain(g.float(), *[t.float() for t in x],
                                                      row0=row0)
                for name, k, w, c in zip(GRAD_NAMES, got, want, chain):
                    top = w.abs().max().item()
                    err = (k.float() - w).abs().max().item()
                    diff = (k.float() - c.float()).abs().max().item()
                    check(err <= 2e-2 * top, f"backward {path} bf16 {name}: error {err}")
                    check(diff <= 4e-2 * top, f"backward {path} bf16 {name}: {diff} from the "
                          "replaced chain")
                    errs[name] = {"vs_f32_plain": err, "vs_replaced": diff}
            model = lambda: ml.fused_motif_level3_backward(g, *x, row0=row0, needs=MODEL_NEEDS)
            first, again = model(), model()
            check(all(a is None or torch.equal(a, c) for a, c in zip(first, again)),
                  f"backward {path} {[B, N, h]}: two calls differ")
            traced = {need: backward_kernels_ms(ml, lambda: ml.fused_motif_level3_backward(
                g, *x, row0=row0, needs=need)) for need in (MODEL_NEEDS, (True,) * 8)}
            kernels = {need: k for need, (k, _) in traced.items()}
            for need, want in ((MODEL_NEEDS, BACKWARD_KERNELS),
                               ((True,) * 8, BACKWARD_KERNELS_CONTRACT)):
                plan = ml.motif_level3_backward_plan(B, N, n, R, h, need)
                check(len(kernels[need]) == want == plan.kernels and all(
                    k["launches"] <= 1 for k in kernels[need].values()),
                    f"backward {path} {[B, N, h]}: kernels {kernels[need]}, expected {want} "
                    "a call")
            b = level3_backward_bound(x[0], R, h, MODEL_NEEDS, dt, row0, n)
            on_path = path in ("synthetic2", "joint", "scene") or path.startswith("tp_")
            rows.append(dict(
                kernel="motif_level3_backward", path=path, shape=[B, N, h], window=[row0, n],
                dtype=str(dt)[6:], R=R, served=served, batch_shape=served,
                max_abs_err=max(e["vs_f64" if dt == torch.float32 else "vs_f32_plain"]
                                for e in errs.values()), errors=errs,
                ms=device_ms(model), two_calls_bit_equal=True,
                kernels_ms=kernels[MODEL_NEEDS], kernels_ms_all_eight=kernels[(True,) * 8],
                kernel_traces_taken=[t for _, t in traced.values()],
                ms_all_eight=device_ms(lambda: ml.fused_motif_level3_backward(g, *x, row0=row0)),
                plain_ms=device_ms(lambda: ml.motif_level3_backward_plain(
                    g, *x, row0=row0, needs=MODEL_NEEDS)),
                replaced_ms=device_ms(lambda: replaced_grads(ml, g, x, row0, MODEL_NEEDS)),
                bound_ms=b["bound_ms"], bound_by=b["bound_by"], library_ms=None,
                launches_per_step=1 if on_path else 0, launches_per_served_batch=0,
                **({"peak_bytes": level3_peaks(ml, x, g)} if path == "synthetic2" else {})))
    return rows


# K3 cases: A shape, x shape, W's width H (None: no W), leak, dtype, served,
# density of A, and the path a row belongs to when it is not synthetic2's.
# GraphConv's two served layers with W (x [.,25,1] @ [1,10] and the skip
# concat [.,25,11] @ [11,20]), the second in bf16; the same layers at
# protein's B = 50 and mnist's B = 2 graphs of N = 50 (density 0.3, as
# their truth graphs), f32 and bf16; the synthetic2 model at N = 1024
# (B = 2); the large-graph contraction at N = 2048 (f32 without epilogue,
# kept to compare with earlier versions) and 8192 (density 0.01, as
# benchmarks/large_graph_bench.py); ragged shapes for every edge of the
# tiles.
K3_3D_CASES = tuple(
    ((b, 50, 50), (b, 50, f), h, 0.2, dt, False, 0.3, path)
    for path, b in (("protein", 50), ("mnist", 2))
    for f, h in ((1, 10), (11, 20))
    for dt in (torch.float32, torch.bfloat16))
K3_CASES = (
    ((10, 25, 25), (10, 25, 1), 10, 0.2, torch.float32, True, 0.15),
    ((10, 25, 25), (10, 25, 11), 20, 0.2, torch.float32, True, 0.15),
    ((10, 25, 25), (10, 25, 11), 20, 0.2, torch.bfloat16, False, 0.15),
    ((2, 1024, 1024), (2, 1024, 11), 20, 0.2, torch.float32, False, 0.01),
    ((2, 1024, 1024), (2, 1024, 11), 20, 0.2, torch.bfloat16, False, 0.01),
    ((2048, 2048), (2048, 128), None, None, torch.float32, False, 0.05),
    ((2048, 2048), (2048, 128), None, 0.2, torch.bfloat16, False, 0.05),
    ((8192, 8192), (8192, 128), None, 0.2, torch.float32, False, 0.01),
    ((8192, 8192), (8192, 128), None, 0.2, torch.bfloat16, False, 0.01),
    ((3, 45, 70), (3, 70, 33), None, 0.2, torch.float32, False, 0.3),
    ((3, 45, 70), (3, 70, 33), None, 0.2, torch.bfloat16, False, 0.3),
    ((2047, 2047), (2047, 100), None, 0.2, torch.float32, False, 0.05),
    ((2047, 2047), (2047, 100), None, 0.2, torch.bfloat16, False, 0.05),
) + K3_3D_CASES


def check_adj_matmul(am, gen):
    """K3 at each case against its plain version: f32 with M >= 1024
    against float64 within the summation bound of M + F terms (the
    projection's F, then A's M), other f32 at rtol/atol 1e-5, bf16 within
    2e-2 of the largest magnitude.  W rows also time the pair they replace
    (torch.matmul for x @ W, then K3 without W)."""
    rows = []
    for a_shape, x_shape, hw, leak, dt, served, density, *path in K3_CASES:
        a, x = adj_inputs(a_shape, x_shape, dt, gen, density)
        w = (None if hw is None else
             (0.3 * torch.randn(x_shape[-1], hw, generator=gen, device="cuda")).to(dt))
        n, m = a_shape[-2:]
        b = a_shape[0] if len(a_shape) == 3 else 1
        f, hh = (None, x_shape[-1]) if w is None else (x_shape[-1], hw)
        kern = lambda: am.blocked_adj_matmul(a, x, leak, w)
        plain = lambda: am.adj_matmul_plain(a, x, leak, w)
        got = kern()
        extra = {}
        if dt == torch.float32 and m >= 1024:
            err, extra["plain_f32_err_vs_f64"] = compare_f64_bound(
                got, [a, x] + ([] if w is None else [w]), m + (f or 0),
                lambda aa, xx, *ww: am.adj_matmul_plain(aa, xx, leak, *ww))
        else:
            err = compare(got, plain(), dt)
        isz = a.element_size()
        b_ms, b_by = bound(isz * (b * n * m + b * m * x_shape[-1] + (0 if w is None else f * hh)
                                  + b * n * hh),
                           2 * b * n * m * hh + (0 if w is None else 2 * b * m * f * hh)
                           + (2 * b * n * hh if leak else 0), dt)
        mm = torch.bmm if len(a_shape) == 3 else torch.mm
        xw = lambda: x if w is None else torch.matmul(x, w)
        lib = ((lambda: torch.nn.functional.leaky_relu(mm(a, xw()), leak)) if leak
               else (lambda: mm(a, xw())))
        if w is not None:
            extra["replaced_ms"] = device_ms(
                lambda: am.blocked_adj_matmul(a, torch.matmul(x, w), leak))
        plan = am.adj_matmul_plan(b, n, m, hh, f, dt)
        shape = [list(a_shape), list(x_shape)] + ([] if w is None else [list(w.shape)])
        if path:
            extra["path"] = path[0]
        rows.append(dict(kernel="adj_matmul", shape=shape, dtype=str(dt)[6:], served=served,
                         batch_shape=served, leak=leak, density=density,
                         plan={"variant": plan.variant, "split": plan.split,
                               "blocks": plan.blocks, "smem": plan.smem, "fuse_w": plan.fuse_w,
                               "tma_a": plan.tma_a, "tma_x": plan.tma_x},
                         max_abs_err=err, ms=device_ms(kern), plain_ms=device_ms(plain),
                         bound_ms=b_ms, bound_by=b_by, library_ms=device_ms(lib), **extra))
    return rows


# K3's backward: the gradient subsets (∂A, ∂x, ∂W) each K3 case is held
# at: with W, {W} (GraphConv 1, whose x is the data) and {x, W} (GraphConv
# 2); without W, {x}.  Beside K3_CASES, GraphConv 2's shape with 3 rows of
# A all zero (y = 0 there: the tie), f32 and bf16.
K3B_NEEDS_W = ((False, False, True), (False, True, True))
K3B_NEEDS = ((False, True, False),)
K3B_TIE_CASES = tuple(((10, 25, 25), (10, 25, 11), 20, 0.2, dt, False, 0.15, "zero_rows")
                      for dt in (torch.float32, torch.bfloat16))
K3B_ZERO_ROWS = 3


class _AdjMatmulAutograd(torch.autograd.Function):
    """K3's backward as it was before it had a kernel, for the measurements
    that compare it with the kernel and for nothing else: the forward is the
    package's (one ``blocked_adj_matmul`` launch), the backward autograd
    through ``adj_matmul_plain``, which recomputes the forward."""

    @staticmethod
    def forward(ctx, adj, x, w, leak):
        from snd_vae_tpu_torch.nn.kernels import adj_matmul as am

        ctx.save_for_backward(adj, x, w)
        ctx.leak = leak
        return am.blocked_adj_matmul(adj, x, leak, w)

    @staticmethod
    def backward(ctx, grad):
        from snd_vae_tpu_torch.nn.kernels import adj_matmul as am

        got = replaced_adj_grads(am, *ctx.saved_tensors, ctx.leak, grad,
                                 ctx.needs_input_grad[:3])
        return (*got, None)


class replaced_adj_backward:
    """A context in which GraphConv runs K3's replaced backward
    (``_AdjMatmulAutograd``), for measurements in turns."""

    def __enter__(self):
        import snd_vae_tpu_torch.nn.graph_conv as gc

        self.saved = gc.adj_matmul
        gc.adj_matmul = lambda adj, x, leak=None, w=None: _AdjMatmulAutograd.apply(
            adj, x, w, leak)

    def __exit__(self, *exc):
        import snd_vae_tpu_torch.nn.graph_conv as gc

        gc.adj_matmul = self.saved


def replaced_adj_grads(am, a, x, w, leak, g, needs):
    """The replaced chain: autograd through ``adj_matmul_plain``, the
    forward recomputed, for the inputs ``needs`` (∂A, ∂x, ∂W) asks for."""
    ts = [None if t is None else t.detach().requires_grad_(bool(nd))
          for t, nd in zip((a, x, w), needs)]
    with torch.enable_grad():
        out = am.adj_matmul_plain(ts[0], ts[1], leak, ts[2])
    wanted = [t for t in ts if t is not None and t.requires_grad]
    got = iter(torch.autograd.grad(out, wanted, g))
    return [next(got) if t is not None and t.requires_grad else None for t in ts]


def adj_backward_terms(k: int, b: int, n: int, m: int, f: Optional[int], h: int) -> int:
    """The longest f32 sum behind one element of K3's gradient k (∂A, ∂x,
    ∂W): ∂A sums H products of gy with xw, itself a sum of F; ∂x sums N
    into gxw, then H into gx (gxw alone without W); ∂W N into gxw, then the
    B·M rows of x."""
    return (h + (f or 0), n + (0 if f is None else h), n + b * m)[k]


def adj_backward_bound(a, x, w, leak, needs, dtype) -> tuple:
    """The least time of one call of K3's backward on these tensors:
    bytes of A, x, W, the gradient and (with act) the output read once and
    the asked-for gradients written once; operations (every product dense,
    as the kernel computes it): gy 3 per output element with act, gxw
    2·B·N·M·H, ∂x 2·B·M·F·H with W, ∂W 2·B·M·F·H, ∂A 2·B·N·M·H (and xw's
    recompute 2·B·M·F·H)."""
    n, m = a.shape[-2:]
    b = a.shape[0] if a.dim() == 3 else 1
    f = None if w is None else w.shape[0]
    h = x.shape[-1] if w is None else w.shape[1]
    need_a, need_x, need_w = needs
    isz = a.element_size()
    elems = a.numel() + x.numel() + (0 if w is None else w.numel()) + b * n * h * (
        2 if leak is not None else 1)
    elems += (a.numel() if need_a else 0) + (x.numel() if need_x else 0) + (
        w.numel() if need_w and w is not None else 0)
    ops = (3 * b * n * h if leak is not None else 0) + (
        2 * b * n * m * h if need_x or need_w else 0)
    if w is not None:
        ops += (2 * b * m * f * h if need_x else 0) + (2 * b * m * f * h if need_w else 0)
    if need_a:
        ops += 2 * b * n * m * h + (0 if w is None else 2 * b * m * f * h)
    return bound(isz * elems, ops, dtype)


def library_adj_backward(a, x, w, gy, needs, fuse_w):
    """The library's yardstick for K3's backward (used nowhere in the port):
    gxw = A^T gy as one ``torch.matmul`` on a precomputed gy, and where the
    kernel fuses W the asked-for products gxw W^T and x^T gxw."""
    gxw = torch.matmul(a.mT, gy)
    if w is None or not fuse_w:
        return gxw
    return (torch.matmul(gxw, w.T) if needs[1] else None,
            torch.matmul(x.reshape(-1, x.shape[-1]).T, gxw.reshape(-1, gxw.shape[-1]))
            if needs[2] else None)


def check_adj_matmul_backward(am, gen):
    """K3's backward (``fused_adj_matmul_backward``) at every K3 case and a
    graph with zero rows (the tie), for the subsets K3B_NEEDS(_W) asks,
    against its closed form ``adj_matmul_backward_plain``: f32 within the
    float64 summation bound of each gradient's longest sum
    (``adj_backward_terms``), bf16 within 2e-2 of the largest magnitude;
    two calls bit-equal.  Each row: the kernel's and the replaced chain's
    (autograd through the plain forward) ms, timed in turns (kernel, chain,
    chain, kernel: events behind the spin, 50 calls a turn, each the mean
    of its two), their kernels and device-busy ms per call (profiler), the
    plain version's ms, the bound; GraphConv 1 ({W}) and 2 ({x, W}) of
    synthetic2 in f32 are the train step's rows (one call each a step).
    Each row records the plan that ran (variant, the i-split, TMA flags) and
    the library's ms: one ``torch.matmul(A^T, gy)`` on a precomputed gy,
    plus the products with W asked for where the plan fuses W."""
    names = ("adj", "x", "w")
    rows = []
    held = am.backward_cluster_capacity(torch.device("cuda"))
    emit("k3_backward_clusters", {"held": held, "plan_table": am.H100_BWD_CLUSTERS})
    for a_shape, x_shape, hw, leak, dt, served, density, *path in K3_CASES + K3B_TIE_CASES:
        a, x = adj_inputs(a_shape, x_shape, dt, gen, density)
        tie = bool(path) and path[0] == "zero_rows"
        if tie:
            a[:, :K3B_ZERO_ROWS] = 0
        w = (None if hw is None else
             (0.3 * torch.randn(x_shape[-1], hw, generator=gen, device="cuda")).to(dt))
        n, m = a_shape[-2:]
        b = a_shape[0] if len(a_shape) == 3 else 1
        f, hh = (None, x_shape[-1]) if w is None else (x_shape[-1], hw)
        out = am.blocked_adj_matmul(a, x, leak, w)
        g = torch.randn(out.shape, generator=gen, device="cuda").to(dt)
        for needs in (K3B_NEEDS if w is None else K3B_NEEDS_W):
            kern = lambda: am.fused_adj_matmul_backward(g, a, x, out, leak, w, needs)
            plain = lambda: am.adj_matmul_backward_plain(g, a, x, out, leak, w, needs)
            chain = lambda: replaced_adj_grads(am, a, x, w, leak, g, needs)
            got, again = kern(), kern()
            check(all(u is None or torch.equal(u, v) for u, v in zip(got, again)),
                  f"K3 backward {a_shape} {needs}: two calls differ")
            want = plain()
            errs = {}
            for k, name in enumerate(names):
                if want[k] is None:
                    check(got[k] is None, f"K3 backward {a_shape} {needs}: {name} not asked")
                    continue
                if dt == torch.float32:
                    # act's slopes read the output's sign: held as it is in
                    # the reference, as |out| in the magnitudes (an upper bound)
                    inputs = [g, a, x] + ([] if leak is None else [out]) + (
                        [] if w is None else [w])
                    fn = (lambda gg, aa, xx, *rest, k=k: am.adj_matmul_backward_plain(
                        gg, aa, xx, rest[0] if leak is not None else None, leak,
                        rest[-1] if w is not None else None, needs)[k])
                    err, p32 = compare_f64_bound(got[k], inputs,
                                                 adj_backward_terms(k, b, n, m, f, hh), fn)
                    errs[name] = {"vs_f64": err, "plain_f32_vs_f64": p32}
                else:
                    errs[name] = {"vs_bf16_plain": compare(got[k], want[k], dt)}
            turns = {"kernel": [], "chain": []}
            for name in ("kernel", "chain", "chain", "kernel"):
                turns[name].append(device_ms(kern if name == "kernel" else chain,
                                             reps=REPS // 2))
            k_busy, c_busy = busy_ms(kern), busy_ms(chain)
            b_ms, b_by = adj_backward_bound(a, x, w, leak, needs, dt)
            on_step = served and dt == torch.float32 and needs == (
                (False, False, True) if f == 1 else (False, True, True))
            shape = [list(a_shape), list(x_shape)] + ([] if w is None else [list(w.shape)])
            aligned = all(t.data_ptr() % 16 == 0 for t in (a, g, out))
            plan = am.adj_matmul_backward_plan(b, n, m, hh, f, dt, needs, aligned, held)
            gy = (g if leak is None else am.lrelu_grad(g, out, leak)).contiguous()
            library_ms = device_ms(lambda: library_adj_backward(a, x, w, gy, needs, plan.fuse_w))
            rows.append(dict(
                kernel="adj_matmul_backward", shape=shape, dtype=str(dt)[6:],
                needs=[nm for nm, nd in zip(names, needs) if nd], served=on_step,
                batch_shape=on_step, leak=leak, density=density,
                **({"path": path[0]} if path else {}),
                zero_rows=K3B_ZERO_ROWS if tie else 0,
                plan={"variant": plan.variant, "fuse_w": plan.fuse_w, "split": plan.split,
                      "grid": plan.grid, "blocks": plan.blocks, "smem": plan.smem,
                      "tma_a": plan.tma_a, "tma_g": plan.tma_g, "parts": plan.parts,
                      "kernels": plan.kernels},
                max_abs_err=max(e["vs_f64" if dt == torch.float32 else "vs_bf16_plain"]
                                for e in errs.values()), errors=errs,
                two_calls_bit_equal=True,
                ms=statistics.mean(turns["kernel"]), replaced_ms=statistics.mean(turns["chain"]),
                turns_ms=turns, kernels_per_call=k_busy["kernels"],
                busy_ms=k_busy["busy_ms"], replaced_kernels_per_call=c_busy["kernels"],
                replaced_busy_ms=c_busy["busy_ms"],
                plain_ms=device_ms(plain), bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                launches_per_step=1 if on_step else 0, launches_per_served_batch=0))
    return rows


def serve_rate(fn, graphs: int, iters: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return graphs * iters / (time.perf_counter() - t0)


def range_device_ms(prof, prefix: str, n: int) -> dict:
    """Device ms per call of the kernels launched under each profiler range
    whose name starts with ``prefix``, by range name."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        r = e
        while r is not None and not r.name.startswith(prefix):
            r = r.cpu_parent
        if r is not None:
            out[r.name] = out.get(r.name, 0.0) + sum(k.duration for k in e.kernels)
    return {k: v / 1e3 / n for k, v in sorted(out.items())}


def label_convs(model) -> list:
    """A profiler range ``sg_conv.<i>`` around each motif conv's forward;
    returns the hook handles."""
    from torch.profiler import record_function

    handles, ranges = [], {}
    for i, conv in enumerate(model.sg_convs):
        def enter(_m, _args, i=i):
            ranges[i] = record_function(f"sg_conv.{i}")
            ranges[i].__enter__()

        def leave(_m, _args, _out, i=i):
            ranges.pop(i).__exit__(None, None, None)

        handles += [conv.register_forward_pre_hook(enter), conv.register_forward_hook(leave)]
    return handles


def profile_batches(fn, batches) -> dict:
    """One profiled pass over the batches: wall time, device busy time (the
    sum of kernel times; one stream, so kernels do not overlap), kernels
    launched, the kernels that take the most device time, the host ops
    (with their input shapes) whose own launches take the most, and the
    device ms under each ``sg_conv.<i>`` range (``label_convs``), all per
    batch.  The profiler's own host cost inflates the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for b in batches:
            fn(b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the ranges' own device-side spans (user annotations) are not kernels
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("sg_conv.")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    n = len(batches)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    top_ops = sorted(ops, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "wall_ms_per_batch": wall * 1e3 / n,
        "device_busy_ms_per_batch": busy_us / 1e3 / n,
        "device_busy_share": busy_us / 1e6 / wall if wall > 0 else None,
        "kernels_per_batch": sum(e.count for e in kernels) / n,
        "top_kernels": [[e.key[:70], e.self_device_time_total / 1e3 / n, e.count / n]
                        for e in top],
        "top_ops": [[e.key, str(e.input_shapes)[:120], e.self_device_time_total / 1e3 / n,
                     e.count / n] for e in top_ops],
        "conv_device_ms_per_batch": range_device_ms(prof, "sg_conv.", n),
    }


def serve_phase(ml, mc, am, cfg, per_batch, dtypes=("float32", "bfloat16"),
                n_batches=SERVE_BATCHES, sample_graphs=SAMPLE_GRAPHS, num_graphs=None,
                timed=True, cpu_graphs=None):
    """Serve ``cfg`` from the seed weights: reconstruct ``n_batches`` of the
    test split and sample ``sample_graphs`` graphs from the prior in each
    dtype, counting the launches (``per_batch`` per reconstructed batch;
    decoding launches none) and reading the peak of allocated memory over
    that run; the outputs' shapes and finiteness; in f32 one batch (its
    first ``cpu_graphs`` graphs, when given) against the same weights on the
    CPU (plain versions) at rtol 1e-4 / atol 1e-5; with ``timed``, graphs/s
    and profiles, the motif convs under ``sg_conv.<i>`` ranges."""
    from snd_vae_tpu_torch.data.loaders import load_dataset
    from snd_vae_tpu_torch.models import build_model
    from snd_vae_tpu_torch.serve import reconstruct, sample

    B, N, K = cfg.train.batch_size, cfg.num_nodes, cfg.decoder.num_edge_feature
    scene = cfg.dataset == "scene"
    F = 1 if scene else cfg.num_features           # scene: the shape's class index
    data = load_dataset(cfg, "test", num_graphs=num_graphs, device="cuda")
    batches = [data.slice_batch(i * B, B) for i in range(n_batches)]
    out = {"model_type": cfg.model_type, "dataset": cfg.dataset,
           "batch": [B, 1 if cfg.model_type in ("base", "geoGCN", "posGCN")
                     else data.num_samples, N], "batches": n_batches,
           "adj_head_factored": cfg.adj_factored_engaged}
    ref_out = None

    for dtype_name in dtypes:
        model = build_model(cfg.with_(compute_dtype=dtype_name), device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(cfg.train.seed)
        # warm-up (cuDNN plans, caches), each entry point from TF32 on: it
        # must turn TF32 off itself
        warm = [lambda: reconstruct(model, batches[0])]
        if sample_graphs:
            warm.append(lambda: sample(model, sample_graphs, gen))
        for fn in warm:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            fn()
            check(not (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32),
                  "a serving entry point left TF32 on")
        torch.cuda.synchronize()

        # the path, counted: the reconstructed batches and the samples
        torch.cuda.reset_peak_memory_stats()
        zero_counts(ml, mc, am)
        outs = [reconstruct(model, b) for b in batches]
        drawn = sample(model, sample_graphs, gen) if sample_graphs else None
        launches = read_counts(ml, mc, am)
        peak = torch.cuda.max_memory_allocated()
        check(launches == per(n_batches, **per_batch),
              f"{cfg.model_type}/{cfg.dataset} {dtype_name}: launches {launches}, expected "
              f"{per_batch} per batch over {n_batches}")

        for o in outs:
            d = o.decoded
            check(d.adj_prob.shape == (B, N, N, K) and d.coords.shape == (B, N, cfg.spatial_dim)
                  and d.node_feat.shape == (B, N, F), "reconstruct shapes")
            for t in (d.adj_prob, d.coords, d.node_feat, o.stats.mean_sg):
                check(bool(torch.isfinite(t).all()), "reconstruct outputs finite")
        if drawn is not None:
            check(drawn.adj.shape == (sample_graphs, N, N)
                  and drawn.coords.shape == (sample_graphs, N, cfg.spatial_dim)
                  and drawn.node_feat.shape == (sample_graphs, N, F), "sample shapes")
            for t in (drawn.adj_prob, drawn.coords, drawn.node_feat):
                check(bool(torch.isfinite(t).all()), "sample outputs finite")
            check(bool(((drawn.adj >= 0) & (drawn.adj < K)).all()), "sampled adj classes")

        res = {"launches": launches, "peak_allocated_bytes": peak}
        if dtype_name == "float32":
            ref_out = outs[0]
            # the same weights on the CPU, where the wrappers run the plain versions
            cpu = build_model(cfg, device="cpu")
            cpu.load_state_dict(model.state_dict())
            held = batches[0] if cpu_graphs is None else batches[0].slice_batch(0, cpu_graphs)
            got = outs[0] if cpu_graphs is None else reconstruct(model, held)
            res["cpu_graphs"] = held.batch_size
            res["cpu_max_abs_err"] = held_to_cpu(got, reconstruct(cpu, held.to("cpu")), scene)
        else:
            res["max_abs_diff_vs_f32"] = {
                "adj_prob": (outs[0].decoded.adj_prob.float()
                             - ref_out.decoded.adj_prob).abs().max().item(),
                "coords": (outs[0].decoded.coords.float()
                           - ref_out.decoded.coords).abs().max().item()}
        if timed:
            res["reconstruct_graphs_per_s"] = serve_rate(
                lambda: [reconstruct(model, b) for b in batches], B * n_batches, 20)
            res["sample_graphs_per_s"] = serve_rate(
                lambda: sample(model, sample_graphs, gen), sample_graphs, 20)
            handles = label_convs(model)
            res["reconstruct_profile"] = profile_batches(lambda b: reconstruct(model, b),
                                                         batches)
            for h in handles:
                h.remove()
            # beside the launch check: all kernels of one reconstructed batch
            res["kernels_per_batch"] = res["reconstruct_profile"]["kernels_per_batch"]
            res["sample_profile"] = profile_batches(
                lambda _: sample(model, sample_graphs, gen), [None] * n_batches)
        out[dtype_name] = res
    return out


def held_to_cpu(got, want, scene) -> dict:
    """The card's f32 outputs against the CPU's at rtol 1e-4 / atol 1e-5:
    every posterior mean the model has and the decoded heads (scene: the
    node logits, not their argmax); returns the largest errors."""
    pairs = [(f, getattr(got.stats, f), getattr(want.stats, f))
             for f in ("mean_sg", "mean_s", "mean_g") if getattr(want.stats, f) is not None]
    pairs += [(f, getattr(got.decoded, f), getattr(want.decoded, f))
              for f in ("adj_prob", "coords", "node_feat_prob" if scene else "node_feat")]
    errs = {}
    for name, g, w in pairs:
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-5,
                                   msg=lambda m, name=name: f"{name}: {m}")
        errs[name] = (g.cpu() - w).abs().max().item()
    return errs


def step_phase(event) -> str:
    """The train_step range a profiled op ran under: forward, backward (the
    autograd engine's ops, on its own thread for CUDA tensors) or
    optimizer."""
    while event is not None:
        if event.name.startswith("train_step."):
            return event.name[len("train_step."):]
        if event.name.startswith("autograd::engine::evaluate_function"):
            return "backward"
        event = event.cpu_parent
    return "other"


def autograd_node(event):
    """The autograd node whose backward an event ran under: the outermost
    one, so that a backward which runs autograd itself (a nested
    ``torch.autograd.grad``, as the replaced level-3 backward and K3's
    backward through its plain version do) is charged with all of it."""
    node = None
    while event is not None:
        if event.name.startswith("autograd::engine::evaluate_function: "):
            node = event.name.split(": ", 1)[1]
        event = event.cpu_parent
    return node


def profile_steps(step, batches, steps: Optional[int] = None) -> dict:
    """One profiled pass of train steps over the batches: wall and
    device-busy ms and kernels per step; the device ms of the kernels each
    train_step range launched; the device ms and kernels of the level-3
    and K3 backwards (their autograd nodes, with any autograd nested in
    them); the backward's top kernels by device time, all per step.
    ``steps``: the train steps the calls make in all, where a call makes
    more than one (default: one a batch)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            step(b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = steps or len(batches)
    # the ranges' own device-side spans (user annotations) are not kernels
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("train_step.")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    phase_us, node_us, node_kernels, bwd, attributed = {}, {}, {}, {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        us = sum(k.duration for k in e.kernels)
        phase = step_phase(e)
        phase_us[phase] = phase_us.get(phase, 0.0) + us
        node = autograd_node(e)
        if node is not None:
            node_us[node] = node_us.get(node, 0.0) + us
            node_kernels[node] = node_kernels.get(node, 0) + len(e.kernels)
        for k in e.kernels:
            attributed[k.name] = attributed.get(k.name, 0.0) + k.duration
            if phase == "backward":
                t, c = bwd.get(k.name, (0.0, 0))
                bwd[k.name] = (t + k.duration, c + 1)
    per = lambda us: us / 1e3 / n
    top = sorted(bwd.items(), key=lambda kv: -kv[1][0])[:8]
    # device events that no host op launched, by name
    loose = sorted(((e.key, e.self_device_time_total - attributed.get(e.key, 0.0), e.count)
                    for e in kernels), key=lambda r: -r[1])[:4]
    return {
        "wall_ms_per_step": wall * 1e3 / n,
        "device_busy_ms_per_step": per(busy_us),
        "device_busy_share": busy_us / 1e6 / wall if wall > 0 else None,
        "kernels_per_step": sum(e.count for e in kernels) / n,
        "device_ms_per_step_by_range": {k: per(v) for k, v in sorted(phase_us.items())},
        "unattributed_device_ms_per_step": per(busy_us - sum(phase_us.values())),
        "unattributed_top": [[k[:70], per(us), c / n] for k, us, c in loose],
        "level3_backward_ms_per_step": per(sum(us for k, us in node_us.items()
                                               if k.startswith("_MotifLevel3"))),
        "level3_backward_kernels_per_step": sum(c for k, c in node_kernels.items()
                                                if k.startswith("_MotifLevel3")) / n,
        "adj_matmul_backward_ms_per_step": per(sum(us for k, us in node_us.items()
                                                   if k.startswith("_AdjMatmul"))),
        "adj_matmul_backward_kernels_per_step": sum(c for k, c in node_kernels.items()
                                                    if k.startswith("_AdjMatmul")) / n,
        "top_backward_kernels": [[name[:70], per(t), c / n] for name, (t, c) in top],
    }


def level3_backward_bound(adj, R: int, h: int, needs, dtype, row0: int = 0,
                          n: Optional[int] = None) -> dict:
    """The least time of one level-3 backward over the trees ``adj``
    [T,N,N] for the window of rows [row0, row0 + n) and the gradients
    ``needs`` asks for.  Bytes: every input (adj, φ(rel), a_i, v_j, deg,
    M1d, M1f, bias) and the gradient of nt read once, the asked-for
    gradients written once.  Operations, what these trees need: rf's
    recompute (2R per (i,j,k) with A[i,j] != 0 and A[j,k] != 0), per
    (i,j,h) with A[i,j] != 0 the recompute of m3 (4R + 7, as the forward)
    and the asked-for sums (∂a_i 2, ∂v_j 1, ∂deg 2, ∂M1d 2R + 1, ∂M1f 2R,
    ∂bias 1, gd 2R + 1, grf 2R, the local ∂A 4), and the contractions
    with grf (∂φ: 2R per (i,j,k) with A[j,k] != 0; ∂A: 2R per (i,j,k))."""
    T, N = adj.shape[:2]
    n = N - row0 if n is None else n
    need = dict(zip(("adj", "phi_r", "a_i", "v_j", "deg", "m1d", "m1f", "bias"), needs))
    nz = (adj != 0).double()
    rows = nz[:, row0:row0 + n]
    live = rows.sum().item()
    per_live = 4 * R + 7 + sum(c for k, c in (("a_i", 2), ("v_j", 1), ("deg", 2),
                                               ("m1d", 2 * R + 1), ("m1f", 2 * R),
                                               ("bias", 1), ("phi_r", 2 * R + 1),
                                               ("adj", 4)) if need[k])
    per_live += 2 * R if need["phi_r"] or need["adj"] else 0
    ops = 2 * R * (rows.sum(1) * nz.sum(2)).sum().item() + live * h * per_live
    ops += 2 * R * n * nz.sum().item() if need["phi_r"] else 0
    ops += 2 * R * n * N * N * T if need["adj"] else 0
    sizes = {"adj": T * N * N, "phi_r": T * n * N * R, "a_i": T * n * h, "v_j": T * N * h,
             "deg": T * N, "m1d": R * h, "m1f": R * h, "bias": h}
    isz = 2 if dtype == torch.bfloat16 else 4
    nbytes = isz * (sum(sizes.values()) + T * n * h + sum(v for k, v in sizes.items()
                                                           if need[k]))
    ms, by = bound(nbytes, ops, dtype)
    return {"bound_ms": ms, "bound_by": by, "bytes": nbytes, "operations": ops}


def step_level3_backward_bound(cfg, batch, dtype) -> dict:
    """``level3_backward_bound`` of one train step: both motif convs over
    the batch's B·S trees (the joint model: its B graphs), the model's
    gradients (a_i, v_j, M1d, M1f, bias)."""
    N = cfg.num_nodes
    adj = (batch.adj if cfg.model_type == "base" else batch.adj_samples).reshape(-1, N, N)
    parts = [level3_backward_bound(adj, cfg.rel_dim, hidden[0], MODEL_NEEDS, dtype)
             for hidden in cfg.encoder.sg_conv_hidden]
    ms, by = bound(sum(p["bytes"] for p in parts), sum(p["operations"] for p in parts), dtype)
    return {"bound_ms": ms, "bound_by": by, "bytes": sum(p["bytes"] for p in parts),
            "operations": sum(p["operations"] for p in parts)}


def adj_matmul_backward_bound(cfg, B, dtype) -> dict:
    """The least time of the K3 backward of one step (both GraphConvs):
    bytes of A, x, W and the gradient in read, the gradients of x (all but
    the first layer, whose x is the data) and W written; operations twice
    the forward's (A^T @ g and its product with W^T for x, x^T @ (A^T g)
    for W)."""
    N, F = cfg.num_nodes, cfg.num_features
    nbytes = ops = 0
    f = F
    for i, h in enumerate(cfg.encoder.g_conv_hidden):
        reads = B * N * N + B * N * f + f * h + B * N * h
        writes = (B * N * f if i else 0) + f * h
        nbytes += (reads + writes) * (2 if dtype == torch.bfloat16 else 4)
        ops += 2 * (2 * B * N * N * h + 2 * B * N * f * h + 2 * B * N * h)
        f = h + F                                   # the skip concat of the features
    ms, by = bound(nbytes, ops, dtype)
    return {"bound_ms": ms, "bound_by": by, "bytes": nbytes, "operations": ops}


def card_vs_cpu_step(cfg, batch):
    """One Adam step from the seed weights on the card and on a CPU copy,
    same batch (any number of graphs) and ε: the loss at rtol 1e-5, every gradient at rtol 1e-4 /
    atol 1e-6.  Adam's first step moves a weight by lr·g/(|g| + eps), which
    turns a gradient difference dg at |g| ≲ eps into up to lr·dg/eps =
    8e4·dg, so the updated weights are held (rtol 1e-4 / atol 1e-6) against
    the CPU's Adam applied to the card's gradients, and their distance to
    the CPU's own step is only reported.  Returns the largest errors by
    module group."""
    from snd_vae_tpu_torch import train as tt
    from snd_vae_tpu_torch.models import Latents, build_model

    B, enc = batch.batch_size, cfg.encoder
    S = 1 if cfg.model_type == "base" else cfg.sampling_num     # the joint model: z_sg only
    gen = torch.Generator().manual_seed(0)
    eps = Latents(z_sg=torch.randn(B, S, enc.sg_latent_size, generator=gen),
                  z_s=torch.randn(B, enc.s_latent_size, generator=gen),
                  z_g=torch.randn(B, enc.g_latent_size, generator=gen))
    ran = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, dev).train()
        state = tt.TrainState(cfg=cfg, model=model,
                              optimizer=tt.make_optimizer(cfg, model.parameters()),
                              generator=torch.Generator(device=dev).manual_seed(0))
        on = lambda t: t.to(dev)
        aux = tt.train_step(state, batch.to(dev), torch.zeros((), device=dev),
                            eps=Latents(z_sg=on(eps.z_sg), z_s=on(eps.z_s), z_g=on(eps.z_g)))
        ran[dev] = (aux["loss"], dict(model.named_parameters()))
    (card_loss, card), (cpu_loss, cpu) = ran["cuda"], ran["cpu"]
    # the CPU's Adam from the seed weights on the card's gradients
    replay = build_model(cfg, "cpu").train()
    replayed = dict(replay.named_parameters())
    for name, p in replayed.items():
        p.grad = card[name].grad.cpu()
    tt.make_optimizer(cfg, replay.parameters()).step()

    torch.testing.assert_close(card_loss.cpu(), cpu_loss, rtol=1e-5, atol=0)
    errs = {"loss": (card_loss.cpu() - cpu_loss).abs().item()}
    for name, p in cpu.items():
        group = name.split(".")[0]
        for kind, got, want, held in (
                ("grad", card[name].grad, p.grad, True),
                ("param", card[name].detach(), replayed[name].detach(), True),
                ("param_vs_cpu_step", card[name].detach(), p.detach(), False)):
            if held:
                torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-6,
                                           msg=lambda m: f"{kind} of {name}: {m}")
            key = f"{group}.{kind}"
            errs[key] = max(errs.get(key, 0.0), (got.cpu() - want).abs().max().item())
    return errs


def run_training(ml, mc, am):
    import tempfile

    from snd_vae_tpu_torch import train as tt
    from snd_vae_tpu_torch.config import synthetic2_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset

    cfg = synthetic2_preset(dataset_path=str(ROOT / "dataset"))
    B = cfg.train.batch_size
    data = load_dataset(cfg, "train", device="cuda")
    nb = data.batch_size // B
    out = {"batch": [B, cfg.sampling_num, cfg.num_nodes], "graphs": data.batch_size,
           "steps_per_epoch": nb, "epochs": TRAIN_EPOCHS, "optimizer": cfg.train.optimizer}
    (ROOT / "build").mkdir(exist_ok=True)
    for dtype_name in ("float32", "bfloat16"):
        run_cfg = cfg.with_(compute_dtype=dtype_name)
        res = {}
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as workdir:
            trainer = tt.Trainer(run_cfg, data, device="cuda", workdir=workdir)
            # the main path, counted: Trainer.run over 2 epochs
            zero_counts(ml, mc, am)
            trainer.run(TRAIN_EPOCHS, verbose=False, per_step=True)
            launches = read_counts(ml, mc, am)
            steps = TRAIN_EPOCHS * nb
            check(launches == per(steps, ml3=2, k3=2, bwd=2, k3b=2),
                  f"{dtype_name}: launches {launches} over {steps} steps, expected 2 of "
                  "motif_level3, adj_matmul and their backwards per step, no motif_combine "
                  "and no adj_matmul_plain")
            with open(trainer.logger.jsonl_path) as f:
                means = [json.loads(line)["loss"] for line in f]
            check(len(means) == TRAIN_EPOCHS and all(math.isfinite(m) for m in means),
                  f"{dtype_name}: epoch losses {means} not all finite")
            check(means[1] < means[0], f"{dtype_name}: loss did not fall: {means}")
            check(trainer.checkpointer.latest_step() == 0, "epoch 0 checkpointed")
            res.update(launches=launches,
                       launches_per_step={k: v / steps for k, v in launches.items()},
                       epoch_mean_loss=means)

            # throughput: 2 epochs after a warm-up epoch
            trainer.run_epoch(TRAIN_EPOCHS)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for e in range(TRAIN_EPOCHS + 1, TRAIN_EPOCHS + 3):
                trainer.run_epoch(e)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            res.update(steps_per_s=2 * nb / dt, graphs_per_s=2 * nb * B / dt,
                       peak_allocated_bytes=torch.cuda.max_memory_allocated())

            gi = torch.zeros((), device="cuda")
            batches = [trainer.batched._map(lambda t, i=i: t[i]) for i in range(PROFILE_STEPS)]
            step = lambda b: tt.train_step(trainer.state, b, gi)
            res["profile"] = profile_steps(step, batches)
            # the level-3 backward: the kernel against the autograd chain
            # it replaced, in turns (kernel, chain, chain, kernel)
            keys = ("wall_ms_per_step", "kernels_per_step", "device_busy_ms_per_step",
                    "level3_backward_ms_per_step", "level3_backward_kernels_per_step")
            turns = {"kernel": [], "replaced": []}
            for name in ("kernel", "replaced", "replaced", "kernel"):
                if name == "kernel":
                    prof = profile_steps(step, batches)
                else:
                    with replaced_backward():
                        prof = profile_steps(step, batches)
                turns[name].append({k: prof[k] for k in keys})
            res["backward_turns"] = {name: {k: statistics.mean(t[k] for t in ts) for k in keys}
                                     | {"runs": ts} for name, ts in turns.items()}
            # K3's backward: the kernel against the autograd chain it
            # replaced, in turns (kernel, chain, chain, kernel)
            keys = ("wall_ms_per_step", "kernels_per_step", "device_busy_ms_per_step",
                    "adj_matmul_backward_ms_per_step", "adj_matmul_backward_kernels_per_step")
            turns = {"kernel": [], "replaced": []}
            for name in ("kernel", "replaced", "replaced", "kernel"):
                if name == "kernel":
                    prof = profile_steps(step, batches)
                else:
                    with replaced_adj_backward():
                        prof = profile_steps(step, batches)
                turns[name].append({k: prof[k] for k in keys})
            res["adj_matmul_backward_turns"] = {
                name: {k: statistics.mean(t[k] for t in ts) for k in keys} | {"runs": ts}
                for name, ts in turns.items()}
        res["level3_backward_bound"] = step_level3_backward_bound(
            cfg, data.slice_batch(0, B), getattr(torch, dtype_name))
        res["adj_matmul_backward_bound"] = adj_matmul_backward_bound(
            cfg, B, getattr(torch, dtype_name))
        if dtype_name == "float32":
            res["card_vs_cpu_max_abs_err"] = card_vs_cpu_step(cfg, data.slice_batch(0, B))
        out[dtype_name] = res
    return out


def run_joint_training(ml, mc, am):
    """The joint model at synthetic2 width in f32: Trainer.run for 2 epochs
    from the seed weights (counted: 2 motif_level3 per step), the epoch
    loss falling; a timed epoch and a profile of 5 steps; one step on the
    card against the CPU's; the dropout step."""
    import tempfile

    from snd_vae_tpu_torch import train as tt
    from snd_vae_tpu_torch.config import synthetic2_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset

    cfg = synthetic2_preset(model_type="base", dataset_path=str(ROOT / "dataset"))
    B = cfg.train.batch_size
    data = load_dataset(cfg, "train", device="cuda")
    nb = data.batch_size // B
    res = {"batch": [B, 1, cfg.num_nodes], "steps_per_epoch": nb, "epochs": TRAIN_EPOCHS}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as workdir:
        trainer = tt.Trainer(cfg, data, device="cuda", workdir=workdir)
        zero_counts(ml, mc, am)
        trainer.run(TRAIN_EPOCHS, verbose=False, per_step=True)
        launches = read_counts(ml, mc, am)
        steps = TRAIN_EPOCHS * nb
        check(launches == per(steps, ml3=2, bwd=2),
              f"joint train: launches {launches} over {steps} steps, expected 2 motif_level3 "
              "and 2 of its backward per step and nothing else")
        with open(trainer.logger.jsonl_path) as f:
            means = [json.loads(line)["loss"] for line in f]
        check(len(means) == TRAIN_EPOCHS and all(math.isfinite(m) for m in means),
              f"joint train: epoch losses {means} not all finite")
        check(means[1] < means[0], f"joint train: loss did not fall: {means}")
        res.update(launches=launches, launches_per_step={k: v / steps for k, v in launches.items()},
                   epoch_mean_loss=means)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run_epoch(TRAIN_EPOCHS)
        torch.cuda.synchronize()
        res["steps_per_s"] = nb / (time.perf_counter() - t0)
        res["graphs_per_s"] = res["steps_per_s"] * B
        gi = torch.zeros((), device="cuda")
        batches = [trainer.batched._map(lambda t, i=i: t[i]) for i in range(PROFILE_STEPS)]
        res["profile"] = profile_steps(lambda b: tt.train_step(trainer.state, b, gi), batches)
    res["level3_backward_bound"] = step_level3_backward_bound(cfg, data.slice_batch(0, B),
                                                              torch.float32)
    res["card_vs_cpu_max_abs_err"] = card_vs_cpu_step(cfg, data.slice_batch(0, B))
    res["dropout"] = dropout_step(cfg, data.slice_batch(0, B))
    return res


GRAPH_TURNS = 3           # graphs: timed replayed epochs, in turns with the per-step ones
STEP_TURNS = 1            # graphs: timed per-step epochs (each ~10x a replayed one)
# graphs: kernels a step by wrapper on each configuration's path
GRAPH_KERNELS = {"synthetic2_f32": dict(ml3=2, k3=2, bwd=2, k3b=2),
                 "synthetic2_bf16": dict(ml3=2, k3=2, bwd=2, k3b=2),
                 "joint_f32_dropout": dict(ml3=2, bwd=2),
                 "protein_f32": dict(k3=2, k3b=2, k4=2, k4b=2),
                 "synthetic2_f32_remat": dict(ml3=4, k3=2, bwd=2, k3b=2)}


# kernel names of the model's products, convolutions and custom kernels,
# which a replayed step and a per-step step must launch alike
GRAPH_HEAVY = ("gemm", "sm90", "cutlass", "conv", "cudnn", "motif", "adj_", "bmm", "dot")


def graph_configs() -> dict:
    """The graphs phase's configurations (config, train graphs; None: the
    whole generated split)."""
    from snd_vae_tpu_torch.config import protein_preset, synthetic2_preset

    s2 = synthetic2_preset(dataset_path=str(ROOT / "dataset"))
    joint = s2.with_(model_type="base",
                     train=dataclasses.replace(s2.train, dropout_keep_prob=0.8))
    return {"synthetic2_f32": (s2, None),
            "synthetic2_bf16": (s2.with_(compute_dtype="bfloat16"), None),
            "joint_f32_dropout": (joint, None),
            "protein_f32": (protein_preset(dataset_path=str(ROOT / "dataset")), 100),
            "synthetic2_f32_remat": (s2.with_(remat=True), None)}


def logged(trainer) -> list:
    """Each epoch's per-step aux values, as ``Trainer.run`` logs them."""
    got = []
    log = trainer.logger.log
    trainer.logger.log = lambda epoch, storer: (got.append(storer), log(epoch, storer))[1]
    return got


def train_state(trainer) -> dict:
    st = trainer.state
    return {"params": [p.detach().clone() for p in st.model.parameters()],
            "adam": [{k: v.clone() for k, v in st.optimizer.state[p].items()}
                     for p in st.model.parameters()],
            "step": st.step, "generator": st.generator.get_state()}


def state_differs(a: dict, b: dict) -> list:
    """What differs between two ``train_state``s (bit for bit)."""
    out = ["step"] if a["step"] != b["step"] else []
    out += [f"param {i}" for i, (x, y) in enumerate(zip(a["params"], b["params"]))
            if not torch.equal(x, y)]
    out += [f"adam {i} {k}" for i, (x, y) in enumerate(zip(a["adam"], b["adam"]))
            for k in x if not torch.equal(x[k], y[k])]
    return out + ([] if torch.equal(a["generator"], b["generator"]) else ["generator"])


def dispatch_profile(warm_up, fn, steps: int) -> dict:
    """One profiled call of ``fn`` (``steps`` train steps): its kernel
    records by wrapper and in all, device-busy ms and the busy share of the
    wall, a step.  As ``Trainer._profiled_epoch`` does (faults 3.2, 3.5),
    the profiler first runs ``warm_up`` (an epoch the trace leaves out),
    and ``fn``'s kernels keep ``TRACE_MARGIN_S`` of idle card from each
    edge of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from snd_vae_tpu_torch.train import TRACE_MARGIN_S

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        warm_up()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(TRACE_MARGIN_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(TRACE_MARGIN_S)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("train_step.")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    return {"by_wrapper": {k: sum(e.count for e in kernels if sub in e.key) / steps
                           for k, sub in TRACE_KERNEL_NAMES.items()},
            "by_name": {e.key: e.count / steps for e in kernels},
            "kernels_per_step": sum(e.count for e in kernels) / steps,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "wall_ms_per_step": wall * 1e3 / steps,
            "device_busy_share": busy_us / 1e6 / wall}


def compare_dispatches(graph_epoch, step_epoch, epoch: int, nb: int,
                       sync=torch.cuda.synchronize, profile: bool = True) -> dict:
    """The two dispatches of one Trainer's epochs side by side, from epoch
    ``epoch`` on: ``graph_epoch(e)`` trains epoch e by replays,
    ``step_epoch(e)`` per step.  Where ``profile``, a profiled epoch of
    each (``dispatch_profile``, each after a warm-up epoch: its records by
    wrapper and by name, busy ms and share a step); then ``GRAPH_TURNS``
    timed replayed epochs, the first ``STEP_TURNS`` of them each followed
    by a timed per-step epoch: each path's epoch seconds and steps/s at
    their median."""
    out = {}
    if profile:
        out["profile"] = {
            "graph": dispatch_profile(lambda: graph_epoch(epoch), lambda: graph_epoch(epoch + 1),
                                      nb),
            "per_step": dispatch_profile(lambda: step_epoch(epoch), lambda: step_epoch(epoch + 1),
                                         nb)}
        epoch += 2
    secs = {"graph": [], "per_step": []}
    for turn in range(GRAPH_TURNS):
        for path, fn in (("graph", graph_epoch), ("per_step", step_epoch))[
                :2 if turn < STEP_TURNS else 1]:
            sync()
            t0 = time.perf_counter()
            fn(epoch + turn)
            sync()
            secs[path].append(time.perf_counter() - t0)
    out["timed"] = {path: {"epoch_s": v, "steps_per_s": nb / statistics.median(v)}
                    for path, v in secs.items()}
    return out


def run_graphs(ml, mc, am):
    """The default dispatch (``Trainer.run``: the first step eager, every
    later one a CUDA-graph replay) against ``per_step=True`` for each of
    ``graph_configs``, from the seed weights: (a) two epochs of each from
    identical fresh Trainers, every aux value, parameter, Adam moment and
    count, the step and the generator of ε and dropout bit for bit; the
    wrappers' launches (the eager step and the capture: two steps' worth,
    no plain version); (b) a profiled replayed epoch and a profiled
    per-step epoch: kernel records a step by wrapper (``GRAPH_KERNELS``,
    no ``motif_combine``), equal on both paths; (c) timed epochs of each
    in turns (``compare_dispatches``): steps/s, graphs/s, device-busy
    ms a step and busy share, the capture's seconds and the peak memory.
    For synthetic2 f32 also: ``epoch_chunk=2`` over 4 epochs against 4
    one-epoch dispatches, and 3 epochs against 2, a checkpoint and a resume
    in a fresh Trainer for the third, bit for bit."""
    import tempfile

    from snd_vae_tpu_torch import train as tt
    from snd_vae_tpu_torch.data.loaders import load_dataset

    t_phase = time.perf_counter()
    out, splits = {}, {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as workdir:
        for name, (cfg, graphs) in graph_configs().items():
            t_config = time.perf_counter()
            key = (cfg.dataset, cfg.model_type, graphs)
            if key not in splits:
                splits[key] = load_dataset(cfg, "train", device="cuda", num_graphs=graphs)
            data = splits[key]
            B = cfg.train.batch_size
            res = {"graphs": data.batch_size, "batch": B, "compute_dtype": cfg.compute_dtype}
            trainers, logs, launches, peak = {}, {}, {}, {}
            for path in ("per_step", "graph"):
                tr = trainers[path] = tt.Trainer(cfg, data, device="cuda",
                                                 workdir=f"{workdir}/{name}_{path}")
                logs[path] = logged(tr)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero_counts(ml, mc, am)
                tr.run(GRAPH_EPOCHS, verbose=False, per_step=path == "per_step")
                launches[path] = read_counts(ml, mc, am)
                peak[path] = torch.cuda.max_memory_allocated()
            nb = trainers["graph"].batched.adj.shape[0]
            differs = state_differs(train_state(trainers["graph"]),
                                    train_state(trainers["per_step"]))
            check(logs["graph"] == logs["per_step"] and not differs,
                  f"graphs {name}: the graph epochs differ from the per-step ones: aux "
                  f"{logs['graph'] == logs['per_step']}, {differs[:8]}")
            losses = logs["graph"][0]["loss"]
            check(len(set(losses)) == nb and all(math.isfinite(v) for v in losses),
                  f"graphs {name}: each replay's own batch, finite losses: {losses}")
            want = GRAPH_KERNELS[name]
            check(launches["per_step"] == per(GRAPH_EPOCHS * nb, **want)
                  and launches["graph"] == per(2, **want),
                  f"graphs {name}: launches {launches}, expected {want} a step over "
                  f"{GRAPH_EPOCHS * nb} steps per step and 2 (the eager step, the capture)")
            res.update(steps_per_epoch=nb, launches=launches, peak_allocated_bytes=peak,
                       epoch_mean_loss=[statistics.mean(s["loss"]) for s in logs["graph"]])

            # (b) one replayed epoch against one per-step epoch, profiled;
            # (c) timed epochs in turns
            tg, tp = trainers["graph"], trainers["per_step"]
            graph = tt.StepGraph(tg, nb)
            tg.graph_epochs(graph, range(2, 3))          # the eager step and the capture
            both = compare_dispatches(lambda e: tg.graph_epochs(graph, range(e, e + 1)),
                                      tp.run_epoch, 3, nb)
            prof = both["profile"]
            names = [prof[p].pop("by_name") for p in ("graph", "per_step")]
            # the model's kernels a step, equal on both paths; the dispatch's
            # own small kernels (the batch's gather and the counters in the
            # graph; global_iter's fill in the per-step epoch) may differ
            differ = {k: (names[0].get(k, 0), names[1].get(k, 0))
                      for k in set(names[0]) | set(names[1])
                      if names[0].get(k, 0) != names[1].get(k, 0)}
            heavy = [k for k in differ if any(sub in k.lower() for sub in GRAPH_HEAVY)]
            check(prof["graph"]["by_wrapper"] == prof["per_step"]["by_wrapper"]
                  == events_of(per(1, **want)) and not heavy,
                  f"graphs {name}: kernel records a step {prof}, expected {want}; "
                  f"differing model kernels {heavy}")
            res.update(profile=prof, capture_s=graph.capture_s,
                       kernels_differing_per_step={k[:60]: v for k, v in differ.items()})
            res["timed"] = {path: t | {"graphs_per_s": t["steps_per_s"] * B}
                            for path, t in both["timed"].items()}
            res["speedup"] = (res["timed"]["graph"]["steps_per_s"]
                              / res["timed"]["per_step"]["steps_per_s"])
            if name == "synthetic2_f32":
                res["cudnn_deterministic"] = cudnn_deterministic_cost(tp, 5 + GRAPH_TURNS)
            del trainers, tg, tp, graph
            if name == "synthetic2_f32":
                res.update(graph_chunks_and_resume(tt, cfg, data, f"{workdir}/{name}"))
            res["seconds"] = time.perf_counter() - t_config
            out[name] = res
            gc.collect()
            torch.cuda.empty_cache()
    del splits, data
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


@contextlib.contextmanager
def cudnn_default_picks():
    """The port's train steps with cuDNN's default picks in place of the
    deterministic algorithms ``train_step`` asks for
    (``device.deterministic_cudnn``): to time what those cost."""
    from snd_vae_tpu_torch import train as tt

    held = tt.deterministic_cudnn
    tt.deterministic_cudnn = contextlib.nullcontext
    try:
        yield
    finally:
        tt.deterministic_cudnn = held


def cudnn_deterministic_cost(trainer, epoch: int) -> dict:
    """Per-step epochs with cuDNN's deterministic algorithms (the train
    step's setting, ``device.deterministic_cudnn``) and with its default
    picks, in turns (on, off, off, on): steps/s of each, the price of a
    reproducible trajectory."""
    nb = trainer.batched.adj.shape[0]
    secs = {"deterministic": [], "default": []}
    for k, det in enumerate((True, False, False, True)):
        with contextlib.nullcontext() if det else cudnn_default_picks():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.run_epoch(epoch + k)
            torch.cuda.synchronize()
        secs["deterministic" if det else "default"].append(time.perf_counter() - t0)
    return {k: {"epoch_s": v, "steps_per_s": nb / statistics.mean(v)} for k, v in secs.items()}


def graph_chunks_and_resume(tt, cfg, data, workdir, mesh=None, label="graphs",
                            chunks=True) -> dict:
    """``epoch_chunk=2`` over 4 epochs against 4 one-epoch dispatches
    (where ``chunks``), and 3 epochs against 2, a checkpoint
    (checkpoint_every=1) and a fresh Trainer resuming for the third, all
    bit for bit; under ``mesh`` when given."""
    runs = {}
    for name, c, epochs, chunk in (("chunked", cfg, 4, 2), ("single", cfg, 4, 1),
                                   ("straight", cfg, 3, 1))[0 if chunks else 2:]:
        tr = tt.Trainer(c, data, device="cuda", workdir=f"{workdir}/{name}", mesh=mesh)
        ends, end = [], tr.chunk_end
        tr.chunk_end = lambda e, n, k, end=end, ends=ends: (
            lambda s: ends.append(s - e) or s)(end(e, n, k))
        logs = logged(tr)
        tr.run(epochs, verbose=False, epoch_chunk=chunk)
        runs[name] = (logs, train_state(tr), ends)
    every = cfg.with_(train=dataclasses.replace(cfg.train, checkpoint_every=1))
    tt.Trainer(every, data, device="cuda", workdir=f"{workdir}/resumed",
               mesh=mesh).run(2, verbose=False)
    tr = tt.Trainer(every, data, device="cuda", workdir=f"{workdir}/resumed", mesh=mesh)
    logs = logged(tr)
    tr.run(3, verbose=False)
    runs["resumed"] = (logs, train_state(tr), None)
    out = {}
    if chunks:
        (lc, sc, ends), (ls, ss, _) = runs["chunked"], runs["single"]
        check(ends == [1, 2, 1] and lc == ls and not state_differs(sc, ss),
              f"{label}: epoch_chunk=2 {ends} differs from one epoch a dispatch: "
              f"{state_differs(sc, ss)[:8]}")
        out = {"chunked_equals_single": True, "chunks": ends}
    (lr, sr, _), (lt, st, _) = runs["resumed"], runs["straight"]
    check(lr == lt[2:] and not state_differs(sr, st),
          f"{label}: the resumed third epoch differs: {state_differs(sr, st)[:8]}")
    return out | {"resumed_equals_straight": True}


def mesh_graphs(ml, mc, am, label, cfg, data, mesh, stepped, stepped_logs, workdir,
                chunks=True) -> dict:
    """The default dispatch under ``mesh`` (the NCCL group of one: its
    collectives are NCCL kernels in the captured graph) against
    ``stepped``, a Trainer that took ``GRAPH_EPOCHS`` epochs per step on
    the mesh from the seed weights (its logged aux values
    ``stepped_logs``): (a) as many epochs of a fresh Trainer on the mesh
    through ``Trainer.run``'s default dispatch, every aux value, parameter,
    Adam moment and count, the step and the generator bit for bit, the
    wrappers' launches those of the eager first step and the capture (2
    steps' worth), the run's peak memory; (b) a resume on the mesh and,
    where ``chunks``, ``epoch_chunk=2`` (``graph_chunks_and_resume``); (c)
    a profiled replayed epoch and a profiled per-step epoch, then timed
    epochs of each in turns (``compare_dispatches``): kernel records a step
    2 / 2 / 2 / 2 on both, device-busy ms and busy share, steps/s; the
    capture's seconds and the graph's kernel and copy nodes."""
    from snd_vae_tpu_torch import train as tt

    t0 = time.perf_counter()
    nb = stepped.batched.adj.shape[0]
    want = dict(ml3=2, k3=2, bwd=2, k3b=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(ml, mc, am)
    tg = tt.Trainer(cfg, data, device="cuda", workdir=f"{workdir}/graph", mesh=mesh)
    logs = logged(tg)
    tg.run(GRAPH_EPOCHS, verbose=False)
    launches = read_counts(ml, mc, am)
    res = {"launches": launches, "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
    differs = state_differs(train_state(tg), train_state(stepped))
    check(logs == stepped_logs and not differs,
          f"{label}: the default dispatch on the mesh differs from per step: aux "
          f"{logs == stepped_logs}, {differs[:8]}")
    check(launches == per(2, **want),
          f"{label}: default dispatch launches {launches}, expected 2 steps' worth (the "
          "eager step and the capture)")
    res["equals_per_step"] = True
    res.update(graph_chunks_and_resume(tt, cfg, data, f"{workdir}/chunks", mesh, label, chunks))

    graph = tt.StepGraph(tg, nb)
    tg.graph_epochs(graph, range(2, 3))          # the eager step and the capture
    both = compare_dispatches(lambda e: tg.graph_epochs(graph, range(e, e + 1)),
                              stepped.run_epoch, 3, nb)
    prof = both["profile"]
    for p in prof.values():
        p.pop("by_name")
    check(prof["graph"]["by_wrapper"] == prof["per_step"]["by_wrapper"]
          == events_of(per(1, **want)),
          f"{label}: kernel records a step {prof}, expected {want}")
    res["timed"] = both["timed"]
    res.update(speedup=res["timed"]["graph"]["steps_per_s"]
               / res["timed"]["per_step"]["steps_per_s"],
               profile=prof, capture_s=graph.capture_s,
               kernels_per_replay=graph.kernels_per_replay,
               copies_per_replay=graph.copies_per_replay,
               seconds=time.perf_counter() - t0)
    graph.release()
    del tg, graph
    gc.collect()
    torch.cuda.empty_cache()
    return res


def dropout_step(cfg, batch, keep=0.8) -> dict:
    """One f32 train step at dropout keep 0.8, twice from the same seed of
    the card's generator (the masks and ε come from it): the same loss (rtol
    1e-6); keep 1 from that seed gives another loss.  The updated weights'
    largest difference between the two runs is reported: Adam's first step
    turns any difference of a tiny gradient (cuDNN's backward need not sum
    in a fixed order) into up to lr·dg/eps."""
    from snd_vae_tpu_torch import train as tt
    from snd_vae_tpu_torch.models import build_model

    gi = torch.zeros((), device="cuda")

    def run(k):
        c = cfg.with_(train=dataclasses.replace(cfg.train, dropout_keep_prob=k))
        model = build_model(c, "cuda").train()
        state = tt.TrainState(cfg=c, model=model,
                              optimizer=tt.make_optimizer(c, model.parameters()),
                              generator=torch.Generator(device="cuda").manual_seed(5))
        loss = tt.train_step(state, batch, gi)["loss"]
        return loss.item(), [p.detach().clone() for p in model.parameters()]

    (l1, p1), (l2, p2), (l_full, _) = run(keep), run(keep), run(1.0)
    check(math.isfinite(l1), f"dropout step loss {l1}")
    torch.testing.assert_close(torch.tensor(l2), torch.tensor(l1), rtol=1e-6, atol=0)
    param_diff = max((a - b).abs().max().item() for a, b in zip(p1, p2))
    check(l_full != l1, "dropout changed nothing")
    return {"keep": keep, "loss": l1, "rerun_loss_diff": abs(l2 - l1),
            "rerun_param_max_diff": param_diff, "loss_keep_1": l_full}


def run_scene(ml, mc, am):
    """The scene preset (the joint model, K-way edge logits without a
    diagonal mask, the categorical node head) on the seeded fallback data:
    one reconstructed batch against the CPU (2 motif_level3); 3 train steps
    on one batch, counted (2 motif_level3 each), the loss finite and
    falling."""
    from snd_vae_tpu_torch.config import scene_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset

    cfg = scene_preset(dataset_path=str(ROOT / "dataset"))
    res = {"serve": serve_phase(ml, mc, am, cfg, {"ml3": 2}, dtypes=("float32",), n_batches=1,
                                sample_graphs=SAMPLE_GRAPHS, timed=False)}
    data = load_dataset(cfg, "train", num_graphs=2, device="cuda")
    check(data.adj_samples is None and not torch.equal(data.adj, data.adj.transpose(1, 2)),
          "scene: a directed adjacency and no spanning trees")
    res["train"] = run_short_train(ml, mc, am, cfg, {"ml3": 2, "bwd": 2}, vs_cpu=False)
    return res


def run_separable(ml, mc, am):
    """The disentangled synthetic2 widths at num_nodes 128, one batch of 10
    graphs: the separable head (adj_head_factored=True) against the dense
    one (False) on the card at rtol 1e-4 / atol 1e-5, the separable model
    on the card against the CPU, and each head's median device ms on the
    same per-node states."""
    from snd_vae_tpu_torch.config import DecoderConfig, synthetic2_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset
    from snd_vae_tpu_torch.models import build_model
    from snd_vae_tpu_torch.serve import reconstruct

    base = synthetic2_preset(dataset_path=str(ROOT / "dataset"), num_nodes=SEPARABLE_NODES)
    cfgs = {name: base.with_(decoder=DecoderConfig(node_h_size=20, adj_head_factored=f))
            for name, f in (("factored", True), ("dense", False))}
    B = base.train.batch_size
    res = {"serve": serve_phase(ml, mc, am, cfgs["factored"], {"ml3": 2, "k3": 2},
                                dtypes=("float32",), n_batches=1, sample_graphs=0,
                                num_graphs=B, timed=False)}
    batch = load_dataset(base, "test", num_graphs=B, device="cuda")
    models = {name: build_model(c, "cuda") for name, c in cfgs.items()}
    outs = {name: reconstruct(m, batch) for name, m in models.items()}
    torch.testing.assert_close(outs["factored"].decoded.adj_prob, outs["dense"].decoded.adj_prob,
                               rtol=1e-4, atol=1e-5)
    res["factored_vs_dense_max_abs_err"] = (outs["factored"].decoded.adj_prob
                                            - outs["dense"].decoded.adj_prob).abs().max().item()
    gen = torch.Generator(device="cuda").manual_seed(0)
    h = torch.randn(B, SEPARABLE_NODES, 2 * base.decoder.node_h_size, generator=gen,
                    device="cuda")
    coords = torch.rand(B, SEPARABLE_NODES, base.spatial_dim, generator=gen, device="cuda")
    with torch.inference_mode():
        res["head_ms"] = {name: device_ms(lambda m=m: m._adj_head(h, coords), reps=20)
                          for name, m in models.items()}
    return res


def conv3d_bound(cfg, batch, dtype) -> dict:
    """The least time of levels 4 and 3 of the fourth-order conv (inputs to
    nt, per layer) on one batch of the sg-branch: bytes of the chain's
    inputs (mask, φ(rel), φ(dis), beta_jk, the [T,N,h] node terms) and nt
    read or written once; operations 8 per m4_sum element (its four adds,
    two products by deg and the mask, lrelu, the k-sum) plus level 3's
    2·h0·h1 + 12·h1 per (i,j).  ``dense`` counts every (i,j,k) and (i,j);
    ``data`` only the motif paths the batch's trees have (A[i,j]·A[j,k] != 0;
    Σ_j in-degree·out-degree) and its edges."""
    N, R = cfg.num_nodes, cfg.rel_dim
    adj = (batch.adj if cfg.model_type == "base"
           else batch.adj_samples.reshape(-1, N, N))
    T = adj.shape[0]
    nz = (adj != 0).double()
    counts = {"dense": (T * N ** 3, T * N * N),
              "data": ((nz.sum(1) * nz.sum(2)).sum().item(), nz.sum().item())}
    esz = 2 if dtype == torch.bfloat16 else 4
    out = {}
    for layer, (h0, h1, *_) in enumerate(cfg.encoder.sg_conv_hidden):
        nbytes = esz * (T * N * N * (1 + 2 * R + h0) + T * N * (1 + 2 * h0 + 3 * h1) + T * N * h1)
        row = {"bytes": nbytes}
        for name, (paths, pairs) in counts.items():
            ops = 8 * paths * h0 + pairs * (2 * h0 * h1 + 12 * h1)
            ms, by = bound(nbytes, ops, dtype)
            row[name] = {"operations": ops, "bound_ms": ms, "bound_by": by}
        out[f"sg_conv.{layer}"] = row
    return out


def level4_paths(mask) -> dict:
    """The counts K4's work follows on the trees ``mask`` [T,N,N]: the
    (i,j,k) with M[i,j]·M[j,k] != 0, the (i,j) with M[i,j] != 0, the (i,k)
    that some path reaches, and the paths' share of all (i,j,k)."""
    nz = (mask != 0).double()
    T, N = mask.shape[:2]
    n_paths = float((nz.sum(1) * nz.sum(2)).sum())
    return {"paths": n_paths, "pairs": float(nz.sum()),
            "reached": float((torch.bmm(nz, nz) != 0).sum()),
            "path_share": n_paths / (T * N ** 3)}


def level4_bounds(T: int, N: int, h: int, c: dict, esz: int = 4) -> dict:
    """Least bytes and operations of K4 and of its backward at [T,N,N,h] on
    trees of ``level4_paths`` counts ``c``, and the bound in ms of each:
    every output element written once, the masks and deg read once, and
    of pu, alpha, beta, gamma the rows the trees' paths need read once;
    10 operations a path and channel forward, 16 backward."""
    masks = T * N * N * 2 + T * N
    fwd_bytes = esz * (T * N * N * h + masks + (2 * c["pairs"] + c["reached"]) * h + T * N * h)
    bwd_bytes = esz * (2 * T * N * N * h + T * N * N * h + T * N * h + masks
                       + (3 * c["pairs"] + c["reached"]) * h + T * N * h)
    dtype = torch.bfloat16 if esz == 2 else torch.float32
    out = {}
    for name, nbytes, ops in (("forward", fwd_bytes, 10 * c["paths"] * h),
                              ("backward", bwd_bytes, 16 * c["paths"] * h)):
        ms, by = bound(nbytes, ops, dtype)
        out[name] = {"bytes": nbytes, "operations": ops, "bound_ms": ms, "bound_by": by}
    return out


def check_level4(cfg, batch) -> list:
    """K4 and its backward at each fourth-order layer's shape on the
    batch's trees (protein: 500 trees, N = 50, h0 = 10 / 20), f32, inputs
    drawn from N(0, 1): one launch each; the forward against the plain
    chain in float64 and the backward against the closed form, each element
    within (2N + 16)·2^-24 of its sum's magnitude (the plain pair on the
    inputs' absolute values), the card tests' tolerance; the median device
    ms of each beside its plain version's and its bound over the trees'
    paths.  Returns the kernels line's rows."""
    from snd_vae_tpu_torch.nn.kernels import motif_level4 as m4

    N = cfg.num_nodes
    mask = batch.adj_samples.reshape(-1, N, N).float().contiguous()
    T = mask.shape[0]
    counts = level4_paths(mask)
    tol = (2 * N + 16) * 2.0 ** -24

    def held(got, want, mag, what) -> float:
        err = (got.double() - want.double()).abs()
        check(bool((err <= tol * mag.double()).all()),
              f"K4 {what}: error {err.max().item()} beyond {tol:.3g} of its sum's magnitude")
        return err.max().item()

    rows = []
    for layer, (h, *_) in enumerate(cfg.encoder.sg_conv_hidden):
        gen = torch.Generator(device="cuda").manual_seed(h)
        draw = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
        ts = [mask, mask, mask.sum(-1), draw(T, N, N, h), draw(T, N, N, h), draw(T, N, N, h),
              draw(T, N, h)]
        grad = draw(T, N, N, h)
        n0, b0 = m4.fused_motif_level4.launches, m4.fused_motif_level4_backward.launches
        got = m4.fused_motif_level4(*ts)
        grads = m4.fused_motif_level4_backward(grad, *ts)
        torch.cuda.synchronize()
        check((m4.fused_motif_level4.launches - n0, m4.fused_motif_level4_backward.launches - b0)
              == (1, 1), f"K4 layer {layer}: one launch each")
        x64 = [t.double() for t in ts]
        fwd_err = held(got, m4.motif_level4_plain(*x64),
                       m4.motif_level4_plain(*[t.abs() for t in x64]), f"layer {layer} forward")
        del x64, got
        want = m4.motif_level4_backward_plain(grad, *ts)
        mags = m4.motif_level4_backward_plain(grad.abs(), *[t.abs() for t in ts])
        bwd_err = max(held(a, b, m, f"layer {layer} backward {name}")
                      for name, a, b, m in zip(("pu", "alpha", "beta", "gamma"), grads, want,
                                               mags))
        del want, mags, grads
        torch.cuda.empty_cache()
        b = level4_bounds(T, N, h, counts)
        common = dict(shape=[T, N, N, h], dtype="float32", served=True, batch_shape=True,
                      library_ms=None, layer=layer, **counts)
        rows.append(dict(common, kernel="motif_level4", max_abs_err=fwd_err,
                         ms=device_ms(lambda: m4.fused_motif_level4(*ts)),
                         plain_ms=device_ms(lambda: m4.motif_level4_plain(*ts), reps=10),
                         bound_ms=b["forward"]["bound_ms"], bound_by=b["forward"]["bound_by"]))
        rows.append(dict(common, kernel="motif_level4_backward", max_abs_err=bwd_err,
                         ms=device_ms(lambda: m4.fused_motif_level4_backward(grad, *ts)),
                         plain_ms=device_ms(
                             lambda: m4.motif_level4_backward_plain(grad, *ts), reps=10),
                         bound_ms=b["backward"]["bound_ms"], bound_by=b["backward"]["bound_by"]))
        del ts, grad
        torch.cuda.empty_cache()
    return rows


def run_train_epochs(ml, mc, am, cfg, graphs, per_step) -> dict:
    """Trainer.run from the seed weights on ``graphs`` of the generated
    train split, f32 and bf16 (f32 masters): one counted epoch (``per_step``
    launches each step), then one timed epoch with the peak of allocated
    memory, the mean loss falling from the first to the second; a profile
    of the steps; in f32 one step on the card against the CPU's on a batch
    of 2 graphs."""
    import tempfile

    from snd_vae_tpu_torch import train as tt
    from snd_vae_tpu_torch.data.loaders import load_dataset

    B = cfg.train.batch_size
    data = load_dataset(cfg, "train", num_graphs=graphs, device="cuda")
    nb = data.batch_size // B
    out = {"batch": [B, 1 if cfg.model_type == "base" else cfg.sampling_num, cfg.num_nodes],
           "graphs": data.batch_size, "steps_per_epoch": nb}
    for dtype_name in ("float32", "bfloat16"):
        res = {}
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as workdir:
            trainer = tt.Trainer(cfg.with_(compute_dtype=dtype_name), data, device="cuda",
                                 workdir=workdir)
            zero_counts(ml, mc, am)
            trainer.run(1, verbose=False, per_step=True)
            launches = read_counts(ml, mc, am)
            check(launches == per(nb, **per_step),
                  f"{cfg.dataset}/{cfg.model_type} train {dtype_name}: launches {launches} over "
                  f"{nb} steps, expected {per_step} per step")
            with open(trainer.logger.jsonl_path) as f:
                first = json.loads(f.readline())["loss"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            second = float(sum(trainer.run_epoch(1)["loss"]) / nb)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            check(math.isfinite(first) and math.isfinite(second) and second < first,
                  f"{cfg.dataset} {dtype_name}: epoch losses {first} -> {second}")
            res.update(launches=launches, epoch_mean_loss=[first, second],
                       steps_per_s=nb / dt, graphs_per_s=nb * B / dt,
                       peak_allocated_bytes=torch.cuda.max_memory_allocated())
            gi = torch.zeros((), device="cuda")
            batches = [trainer.batched._map(lambda t, i=i: t[i])
                       for i in range(min(nb, PROFILE_STEPS))]
            res["profile"] = profile_steps(lambda b: tt.train_step(trainer.state, b, gi), batches)
        out[dtype_name] = res
    out["card_vs_cpu_max_abs_err"] = card_vs_cpu_step(cfg, data.slice_batch(0, 2))
    return out


def run_protein(ml, mc, am):
    """The disentangled model at the protein preset (B = 50 graphs x S = 10
    trees, N = 50, the fourth-order sg conv) on the loader's seeded
    fallback: serve 2 test batches in f32 and bf16 (0 motif_level3, 2
    adj_matmul and 2 K4 per batch; the card against the CPU on 2 graphs),
    the chain's bound per layer; K4 and its backward at both layers against
    the plain pair (``check_level4``, its rows under ``level4``); train on
    100 graphs (2 steps an epoch, 2 adj_matmul, 2 K4 and their backwards
    each)."""
    from snd_vae_tpu_torch.config import protein_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset
    from snd_vae_tpu_torch.models import build_model

    cfg = protein_preset(dataset_path=str(ROOT / "dataset"))
    B = cfg.train.batch_size
    res = {"serve": serve_phase(ml, mc, am, cfg, {"k3": 2, "k4": 2},
                                n_batches=PROTEIN_SERVE_BATCHES,
                                num_graphs=PROTEIN_SERVE_BATCHES * B, cpu_graphs=2)}
    batch = load_dataset(cfg, "test", num_graphs=B, device="cuda")
    res["level4"] = check_level4(cfg, batch)
    res["conv_bound"] = {d: conv3d_bound(cfg, batch, getattr(torch, d))
                         for d in ("float32", "bfloat16")}
    # the dense adjacency head at N = 50 (adj_factored_min_nodes is 96), f32
    model = build_model(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    h = torch.randn(B, cfg.num_nodes, 2 * cfg.decoder.node_h_size, generator=gen, device="cuda")
    coords = torch.rand(B, cfg.num_nodes, cfg.spatial_dim, generator=gen, device="cuda")
    with torch.inference_mode():
        res["adj_head_ms"] = device_ms(lambda: model._adj_head(h, coords), reps=20)
    res["train"] = run_train_epochs(ml, mc, am, cfg, PROTEIN_TRAIN_GRAPHS,
                                    {"k3": 2, "k3b": 2, "k4": 2, "k4b": 2})
    return res


def run_short_train(ml, mc, am, cfg, per_step, vs_cpu=True) -> dict:
    """``SHORT_TRAIN_STEPS`` f32 train steps on one batch of the generated
    train split, counted (``per_step`` each), finite losses falling, the
    peak of allocated memory; with ``vs_cpu`` one step on the card against
    the CPU's on 2 graphs."""
    import tempfile

    from snd_vae_tpu_torch import train as tt
    from snd_vae_tpu_torch.data.loaders import load_dataset

    data = load_dataset(cfg, "train", num_graphs=2 * cfg.train.batch_size, device="cuda")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as workdir:
        trainer = tt.Trainer(cfg, data, device="cuda", workdir=workdir)
        batch = trainer.batched._map(lambda t: t[0])
        gi = torch.zeros((), device="cuda")
        torch.cuda.reset_peak_memory_stats()
        zero_counts(ml, mc, am)
        auxes = [tt.train_step(trainer.state, batch, gi) for _ in range(SHORT_TRAIN_STEPS)]
        launches = read_counts(ml, mc, am)
    losses = [a["loss"].item() for a in auxes]
    check(launches == per(SHORT_TRAIN_STEPS, **per_step),
          f"{cfg.dataset}/{cfg.model_type} train: launches {launches}")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"{cfg.dataset}/{cfg.model_type} train: losses {losses}")
    out = {"launches": launches, "losses": losses,
           "adj_loss": [a["adj_loss"].item() for a in auxes],
           "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
    if vs_cpu:
        out["card_vs_cpu_max_abs_err"] = card_vs_cpu_step(cfg, data.slice_batch(0, 2))
    return out


def run_3d_short(ml, mc, am, cfg, per_batch) -> dict:
    """One reconstructed f32 batch on the card against the CPU (its first 2
    graphs), then ``run_short_train``; ``per_batch`` launches per batch and
    per step, and per step as many of K3's and K4's backward as of K3 and
    K4."""
    per_step = per_batch | {back: per_batch[fwd] for fwd, back in (("k3", "k3b"), ("k4", "k4b"))
                            if fwd in per_batch}
    return {"serve": serve_phase(ml, mc, am, cfg, per_batch, dtypes=("float32",), n_batches=1,
                                 sample_graphs=SAMPLE_GRAPHS, num_graphs=cfg.train.batch_size,
                                 timed=False, cpu_graphs=2),
            "train": run_short_train(ml, mc, am, cfg, per_step)}


def blocked_pair(ml, mc, am, conv, block_rows, inputs, grad_out, ref_device) -> dict:
    """``conv`` forward and backward on ``inputs`` unblocked and with
    ``block_rows``, in f32: the outputs equal at rtol 1e-5 / atol 1e-6 (each
    row is computed by the same operations either way); the gradients of x
    and every parameter, sums over all rows that the blocked run adds up
    block by block, each held to a float64 run of the blocked form on
    ``ref_device`` (the CPU: both motif convs run kernels, which take f32
    and bf16 only; the CPU tests hold the blocked form equal to the
    unblocked one in float64): the blocked error at most twice the
    unblocked one's, plus 1e-7 of the largest gradient.  Each run's
    launches, peak of allocated memory above what was allocated before, and
    device ms."""
    x = inputs[1]

    def run(module, block, dtype=torch.float32, device="cuda"):
        module.block_rows = block
        on = lambda t: t.to(device, dtype)
        xx = on(x.detach()).requires_grad_(True)
        out = module(on(inputs[0]), xx, on(inputs[2]))
        return [out.detach()] + list(torch.autograd.grad(
            out, [xx] + list(module.parameters()), on(grad_out)))

    res, got = {}, {}
    for block in (None, block_rows):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(ml, mc, am)
        got[block] = run(conv, block)
        launches = read_counts(ml, mc, am)
        res[f"block_{block}"] = {
            "launches": launches,
            "peak_above_inputs_bytes": torch.cuda.max_memory_allocated() - base,
            "forward_backward_ms": device_ms(lambda b=block: run(conv, b), reps=5)}
    ref = run(copy.deepcopy(conv).to(ref_device, torch.float64), block_rows, torch.float64,
              ref_device)
    names = ["out", "x"] + [n for n, _ in conv.named_parameters()]
    errs = {}
    for name, b, u, r in zip(names, got[block_rows], got[None], ref):
        if name == "out":
            torch.testing.assert_close(b, u, rtol=1e-5, atol=1e-6, msg=lambda m: f"out: {m}")
        r = r.to(b.device)
        e_b, e_u = ((t.double() - r).abs().max().item() for t in (b, u))
        check(e_b <= 2 * e_u + 1e-7 * r.abs().max().item(),
              f"{name}: blocked error {e_b} vs float64, unblocked {e_u}")
        errs[name] = {"blocked_vs_unblocked": (b - u).abs().max().item(),
                      "blocked_vs_f64": e_b, "unblocked_vs_f64": e_u}
    res["max_abs_err"] = errs
    return res


def run_blocked(ml, mc, am):
    """Layer 2 of the protein sg conv at its preset shape (500 trees of the
    fallback's test split, N = 50, x of width 10, hidden (20,20,20,20))
    unblocked against block_rows=10, the blocked peak lower; the
    third-order conv's layer 2 at synthetic2 (100 trees, N = 25, x of width
    20, hidden (50,50,50)) against block_rows=5, whose forward is one
    motif_level3 and whose backward one call of the backward kernel either
    way (it keeps no [B,n,N,h] tensor, so block_rows leaves its peak as it
    is), and the same with the replaced backward (``replaced_backward``,
    autograd through the plain level 3, recomputed per block): the kernel's
    peak below the replaced unblocked one, the replaced blocked peak below
    its unblocked one."""
    from snd_vae_tpu_torch.config import protein_preset, synthetic2_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset
    from snd_vae_tpu_torch.nn import SpatialGraphConv, SpatialGraphConv3D

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    # the launches unblocked and blocked: K4 once a block, and once more
    # in the backward's recompute of each checkpointed block
    for name, cfg, make, block_rows, per_run, ref_device in (
            ("protein_conv3d_layer2", protein_preset(dataset_path=str(ROOT / "dataset")),
             SpatialGraphConv3D, 10, {None: per(1, k4=1, k4b=1), 10: per(1, k4=10, k4b=5)},
             "cpu"),
            ("synthetic2_conv_layer2", synthetic2_preset(dataset_path=str(ROOT / "dataset")),
             SpatialGraphConv, 5, {None: per(1, ml3=1, bwd=1), 5: per(1, ml3=1, bwd=1)}, "cpu")):
        data = load_dataset(cfg, "test", num_graphs=cfg.train.batch_size, device="cuda")
        N, S = cfg.num_nodes, cfg.sampling_num
        T = data.batch_size * S
        f, hidden = cfg.encoder.sg_conv_hidden[0][-1], cfg.encoder.sg_conv_hidden[1]
        adj = data.adj_samples.reshape(T, N, N)
        rel = data.rel[:, None].expand(-1, S, -1, -1, -1).reshape(T, N, N, -1)
        x = torch.randn(T, N, f, generator=gen, device="cuda")
        conv = make(f, cfg.rel_dim, tuple(hidden), torch.Generator().manual_seed(1)).cuda()
        g = torch.randn(T, N, hidden[-1], generator=gen, device="cuda")
        res = blocked_pair(ml, mc, am, conv, block_rows, (adj, x, rel), g, ref_device)
        peak = lambda r, key: r[key]["peak_above_inputs_bytes"]
        blocked = f"block_{block_rows}"
        for block in (None, block_rows):
            key = f"block_{block}"
            check(res[key]["launches"] == per_run[block],
                  f"{name} {key}: launches {res[key]['launches']}, expected {per_run[block]}")
        if make is SpatialGraphConv3D:
            check(peak(res, blocked) < peak(res, "block_None"), "blocked peak below unblocked")
        else:
            with replaced_backward():
                res["replaced_backward"] = old = blocked_pair(
                    ml, mc, am, conv, block_rows, (adj, x, rel), g, ref_device)
            for key in ("block_None", blocked):
                check(old[key]["launches"] == per(1, ml3=1),
                      f"{name} replaced {key}: launches {old[key]['launches']}")
            check(peak(res, blocked) <= peak(res, "block_None")
                  < peak(old, "block_None") and peak(old, blocked) < peak(old, "block_None"),
                  f"{name} peaks: kernel {peak(res, 'block_None')} / {peak(res, blocked)}, "
                  f"replaced {peak(old, 'block_None')} / {peak(old, blocked)}")
        out[name] = dict(res, trees=T, num_nodes=N, in_width=f, hidden=list(hidden),
                         block_rows=block_rows)
    return out


def run_eval(ml, mc, am):
    """Held-out evaluation at synthetic2, disentangled, f32: Trainer.run for
    2 epochs with eval_every=1 on the test split (200 graphs), counted (2 +
    2 launches per step and per eval batch; epoch 0 is not scored); the
    best checkpoint and best.json; one evaluate_heldout alone, counted and
    timed; its metrics against a CPU Trainer's on the same weights (edge
    AUC/AP within 1e-4, the MSEs at rtol 1e-4, the same keys)."""
    import tempfile

    from snd_vae_tpu_torch import train as tt
    from snd_vae_tpu_torch.config import synthetic2_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset

    cfg = synthetic2_preset(dataset_path=str(ROOT / "dataset"))
    cfg = cfg.with_(train=dataclasses.replace(cfg.train, eval_every=1))
    B = cfg.train.batch_size
    data = load_dataset(cfg, "train", device="cpu")
    held = load_dataset(cfg, "test", device="cpu")
    steps, eval_batches = TRAIN_EPOCHS * data.batch_size // B, held.batch_size // B
    res = {"graphs": data.batch_size, "heldout_graphs": held.batch_size, "epochs": TRAIN_EPOCHS}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as workdir:
        trainer = tt.Trainer(cfg, data, device="cuda", workdir=workdir, eval_batch=held)
        zero_counts(ml, mc, am)
        trainer.run(TRAIN_EPOCHS, verbose=False, per_step=True)
        launches = read_counts(ml, mc, am)
        check(launches == per(steps + eval_batches, ml3=2, k3=2)
              | {"motif_level3_backward": 2 * steps, "adj_matmul_backward": 2 * steps},
              f"eval: launches {launches} over {steps} steps and {eval_batches} eval batches")
        best_dir = Path(trainer.best_checkpointer.directory)
        best = json.loads((best_dir / "best.json").read_text())
        check(trainer.best_checkpointer.steps() == [best["epoch"]] == [1],
              f"best checkpoint {trainer.best_checkpointer.steps()}, best.json {best}")
        val_log = Path(trainer.eval_logger.path).read_text().splitlines()
        zero_counts(ml, mc, am)
        t0 = time.perf_counter()
        card = trainer.evaluate_heldout()
        res["evaluate_heldout_s"] = time.perf_counter() - t0
        per_eval = read_counts(ml, mc, am)
        check(per_eval == per(eval_batches, ml3=2, k3=2),
              f"evaluate_heldout: launches {per_eval} over {eval_batches} batches")
        cpu_trainer = tt.Trainer(cfg, data, device="cpu", workdir=workdir + "/cpu",
                                 eval_batch=held)
        cpu_trainer.state.model.load_state_dict(trainer.state.model.state_dict())
        cpu = cpu_trainer.evaluate_heldout()
    check(sorted(card) == sorted(cpu), f"eval keys {sorted(card)} vs {sorted(cpu)}")
    for k in ("edge_auc", "edge_ap"):
        check(abs(card[k] - cpu[k]) <= 1e-4, f"{k}: card {card[k]} vs CPU {cpu[k]}")
    for k in ("node_mse", "spatial_mse"):
        check(math.isclose(card[k], cpu[k], rel_tol=1e-4), f"{k}: card {card[k]} vs CPU {cpu[k]}")
    check(all(math.isfinite(v) for v in card.values()), f"eval metrics {card}")
    res.update(launches=launches, launches_per_eval_batch={k: v / eval_batches
                                                           for k, v in per_eval.items()},
               per_eval_launches=per_eval, best=best, val_log_rows=len(val_log) - 1,
               card=card, card_vs_cpu_abs_diff={k: abs(card[k] - cpu[k]) for k in card})
    return res


REMAT_VARIANTS = {"none": {}, "remat": dict(remat=True),
                  "recompute-big": dict(remat=True, remat_policy="recompute-big"),
                  "dots-no-batch": dict(remat=True, remat_policy="dots-no-batch")}


def remat_step(ml, mc, am, cfg, batch, eps, device, dtype=torch.float32):
    """One train step (Adam, global_iter 0) from the seed weights of ``cfg``
    on ``device`` with ε given, the model, the batch and ε in ``dtype``;
    returns the loss, the gradients and the launches."""
    from snd_vae_tpu_torch import train as tt
    from snd_vae_tpu_torch.models import Latents, build_model

    model = build_model(cfg, device).to(dtype).train()
    batch = batch.to(dtype=dtype)
    state = tt.TrainState(cfg=cfg, model=model, optimizer=tt.make_optimizer(cfg, model.parameters()),
                          generator=torch.Generator(device=device).manual_seed(0))
    on = lambda t: None if t is None else t.to(device, dtype)
    zero_counts(ml, mc, am)
    aux = tt.train_step(state, batch.to(device), torch.zeros((), device=device),
                        eps=Latents(z_sg=on(eps.z_sg), z_s=on(eps.z_s), z_g=on(eps.z_g)))
    launches = read_counts(ml, mc, am) if device == "cuda" else None
    return (aux["loss"].item(), {n: p.grad.detach() for n, p in model.named_parameters()
                                 if p.grad is not None}, launches)


def run_remat(ml, mc, am):
    """One f32 train step without remat, with --remat and with each policy,
    for synthetic2 (disentangled, 10 graphs x 10 trees; the joint model)
    and protein (disentangled; 2 graphs x 10 trees here, as a float64 step
    of the full batch does not fit the CPU's time): the loss at rtol 1e-6
    of the step without remat; every gradient held to a float64 step on the
    CPU (each remat variant's error at most twice the unremat one's, plus
    1e-7 of the largest gradient); the launches (each motif conv's kernel
    once more in the recompute).  Then at protein's full batch (50 x 10
    trees) each variant and --remat --motif-block-rows 10: ms per step
    (3 steps after a warm-up) and the peak of allocated memory; synthetic2's
    steps/s without and with --remat, in turns."""
    from snd_vae_tpu_torch import train as tt
    from snd_vae_tpu_torch.config import protein_preset, synthetic2_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset
    from snd_vae_tpu_torch.models import Latents, build_model

    s2 = synthetic2_preset(dataset_path=str(ROOT / "dataset"))
    prot = protein_preset(dataset_path=str(ROOT / "dataset"))
    out = {}
    for name, cfg, graphs, plain, remat in (
            ("synthetic2", s2, s2.train.batch_size, per(1, ml3=2, k3=2, bwd=2, k3b=2),
             per(1, ml3=4, k3=2, bwd=2, k3b=2)),
            ("synthetic2_joint", s2.with_(model_type="base"), s2.train.batch_size,
             per(1, ml3=2, bwd=2), per(1, ml3=4, bwd=2)),
            ("protein", prot, 2, per(1, k3=2, k3b=2, k4=2, k4b=2),
             per(1, k3=2, k3b=2, k4=4, k4b=2))):
        batch = load_dataset(cfg, "train", num_graphs=graphs, device="cpu")
        enc, gen = cfg.encoder, torch.Generator().manual_seed(0)
        S = 1 if cfg.model_type == "base" else cfg.sampling_num
        eps = Latents(z_sg=torch.randn(graphs, S, enc.sg_latent_size, generator=gen),
                      z_s=torch.randn(graphs, enc.s_latent_size, generator=gen),
                      z_g=torch.randn(graphs, enc.g_latent_size, generator=gen))
        _, ref, _ = remat_step(ml, mc, am, cfg, batch, eps, "cpu", torch.float64)
        res, base = {}, None
        for variant, over in REMAT_VARIANTS.items():
            loss, grads, launches = remat_step(ml, mc, am, cfg.with_(**over), batch, eps, "cuda")
            want = plain if variant == "none" else remat
            check(launches == want, f"remat {name} {variant}: launches {launches}, expected {want}")
            errs = {n: (g.double().cpu() - ref[n]).abs().max().item() for n, g in grads.items()}
            if base is None:
                base = (loss, errs)
            else:
                torch.testing.assert_close(torch.tensor(loss), torch.tensor(base[0]), rtol=1e-6,
                                           atol=0)
                for n, e in errs.items():
                    check(e <= 2 * base[1][n] + 1e-7 * ref[n].abs().max().item(),
                          f"remat {name} {variant}: {n} error {e} vs float64, unremat "
                          f"{base[1][n]}")
            worst = max(errs, key=errs.get)
            res[variant] = {"loss": loss, "launches": launches,
                            "max_grad_err_vs_f64": errs[worst], "worst_param": worst,
                            "loss_rel_diff_vs_none": abs(loss - base[0]) / abs(base[0])}
        out[name] = dict(res, graphs=graphs)

    # synthetic2 steps/s without and with --remat, in turns (none, remat,
    # remat, none): Trainer.run_epoch over the 200-graph train split after
    # a warm-up epoch
    import tempfile

    data = load_dataset(s2, "train", device="cuda")
    nb = data.batch_size // s2.train.batch_size
    rates = {"none": [], "remat": []}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as workdir:
        for variant in ("none", "remat", "remat", "none"):
            trainer = tt.Trainer(s2.with_(**REMAT_VARIANTS[variant]), data, device="cuda",
                                 workdir=workdir)
            trainer.run_epoch(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.run_epoch(1)
            torch.cuda.synchronize()
            rates[variant].append(nb / (time.perf_counter() - t0))
    out["synthetic2_steps_per_s"] = {k: {"runs": v, "mean": statistics.mean(v)}
                                     for k, v in rates.items()}

    # protein at its full batch: time and memory of each variant
    data = load_dataset(prot, "train", num_graphs=prot.train.batch_size, device="cuda")
    gi = torch.zeros((), device="cuda")
    timed = {}
    for variant, over in dict(REMAT_VARIANTS, **{"remat+block_rows_10": dict(
            remat=True, motif_block_rows=10)}).items():
        c = prot.with_(**over)
        model = build_model(c, "cuda").train()
        state = tt.TrainState(cfg=c, model=model, optimizer=tt.make_optimizer(c, model.parameters()),
                              generator=torch.Generator(device="cuda").manual_seed(0))
        tt.train_step(state, data, gi)          # warm-up: Adam's state, cuDNN plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = [tt.train_step(state, data, gi)["loss"] for _ in range(3)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        check(all(math.isfinite(v.item()) for v in losses), f"protein {variant} losses")
        timed[variant] = {"ms_per_step": ms, "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
        del model, state
    out["protein_full_batch"] = dict(timed, batch=[prot.train.batch_size, prot.sampling_num,
                                                   prot.num_nodes])
    return out


def run_cli_eval():
    """The CLI in-process on the card, in a temporary workdir: synthetic2
    --type train --epochs 2 --eval-every 1, then test_reconstruct,
    test_generation, test_disentangle in each mode and sweep --epochs 1 (its
    own workdir); the joint model's test_reconstruct and test_disentangle.
    Every metric finite, every traversal grid finite; each command's
    seconds.  The figures each drew (``figures/reconstruct_synthetic2.png``
    and ``latent_synthetic2.png`` after test_reconstruct, the latter only
    for the disentangled model; ``traverse_synthetic2.png``, whose path
    test_disentangle returns), decoded by ``decode_png`` at matplotlib's
    pixel size for the figure, with pixels beside the background; the ms
    each drawing function took."""
    from snd_vae_tpu_torch import cli
    from snd_vae_tpu_torch.config import synthetic2_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset

    cfg = synthetic2_preset(dataset_path=str(ROOT / "dataset"))
    enc, V = cfg.encoder, cfg.visualize_length
    grid_rows = {"generation": 3, "single": 1,
                 "latent": enc.s_latent_size + enc.g_latent_size + enc.sg_latent_size}
    n_factors = load_dataset(cfg, "test", num_graphs=2, device="cpu").factors.shape[1]
    draw_ms = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            fig = fn(*args, **kwargs)
            draw_ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            return fig
        return wrapper

    drawers = ("visualize_reconstruct", "visualize_latent_embedding", "visualize_traverse")
    originals = {name: getattr(cli, name) for name in drawers}
    for name in drawers:
        setattr(cli, name, timed(name, originals[name]))
    out = {}
    try:
        _run_cli_eval(cli, out, grid_rows, V, n_factors)
    finally:
        for name in drawers:
            setattr(cli, name, originals[name])
    out["draw_ms"] = draw_ms
    return out


def _run_cli_eval(cli, out, grid_rows, V, n_factors):
    import contextlib
    import io
    import tempfile

    import numpy as np

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as workdir:
        figures = Path(workdir) / "figures"
        common = ["--workdir", workdir, "--dataset-path", str(ROOT / "dataset")]
        runs = [("train", ["--type", "train", "--epochs", "2", "--eval-every", "1"]),
                ("test_reconstruct", ["--type", "test_reconstruct"]),
                ("test_generation", ["--type", "test_generation"])]
        runs += [(f"test_disentangle_{m}", ["--type", "test_disentangle", "--traverse-mode", m])
                 for m in ("generation", "single", "latent")]
        runs += [("base_test_reconstruct", ["--type", "test_reconstruct", "--model-type", "base"]),
                 ("base_test_disentangle", ["--type", "test_disentangle", "--model-type", "base"]),
                 ("sweep", ["--type", "sweep", "--epochs", "1", "--workdir", workdir + "/sweep"])]
        for name, argv in runs:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(io.StringIO()):
                got = cli.main(argv + common if name != "sweep" else
                               argv + ["--dataset-path", str(ROOT / "dataset")])
            secs = time.perf_counter() - t0
            if isinstance(got, str):
                model_type = "base" if name.startswith("base") else "disentangled"
                grid_dir = Path(workdir) / "traverse" / f"synthetic2_{model_type}"
                grid = {k: np.load(grid_dir / f"{k}.npy") for k in ("adj", "node_feat", "coords")}
                check(all(np.isfinite(v).all() for v in grid.values()), f"{name}: grid")
                check(got == str(figures / "traverse_synthetic2.png"), f"{name} returned {got}")
                rows = 1 if model_type == "base" else grid_rows[name.rsplit("_", 1)[1]]
                check(len(grid["adj"]) == rows * V, f"{name}: {len(grid['adj'])} graphs")
                out[name] = {"seconds": secs, "grid_rows": len(grid["adj"]),
                             "png": check_png(got, (int(2.0 * V * 150), int(2.0 * rows * 150)))}
                os.remove(got)
                continue
            metrics = {k: v for k, v in got.items() if isinstance(v, float)}
            if name == "sweep":
                metrics = {f"{part}.{k}": v for part in ("generation", "reconstruct")
                           for k, v in got[part]["disentangled"].items()}
            check(bool(metrics) and all(math.isfinite(v) for v in metrics.values()),
                  f"{name}: metrics {got}")
            out[name] = {"seconds": secs, "metrics": metrics}
            if name.endswith("test_reconstruct"):
                out[name]["png"] = {"reconstruct": check_png(figures / "reconstruct_synthetic2.png",
                                                             (1650, 690))}
                latent = figures / "latent_synthetic2.png"
                check(latent.exists() == (name == "test_reconstruct"),
                      f"{name}: latent figure {'missing' if not latent.exists() else 'drawn'}")
                if latent.exists():
                    out[name]["png"]["latent"] = check_png(latent,
                                                           (int(3.2 * n_factors * 150), 450))
                    os.remove(latent)
                os.remove(figures / "reconstruct_synthetic2.png")


NATIVE_SAMPLES = 10      # trees per graph in the native phase
PROFILE_EPOCHS = 2       # cli_profile: --epochs 2 --profile traces epoch 1
# the kernel events of each wrapper in a torch.profiler trace, by the
# substring their kernels' names share
TRACE_KERNEL_NAMES = {"motif_level3": "motif_level3_kernel",
                      "motif_level3_backward": "motif_l3_grad_",
                      "motif_combine": "motif_combine_kernel",
                      "adj_matmul": "adj_matmul_",
                      "adj_matmul_backward": "adj_bwd_",
                      "motif_level4": "motif_level4_kernel",
                      "motif_level4_backward": "motif_level4_grad_kernel"}


def trace_kernel_events(events) -> dict:
    """Each wrapper's kernel events in a Chrome trace's events."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return {k: sum(sub in e.get("name", "") for e in kernels)
            for k, sub in TRACE_KERNEL_NAMES.items()}


def events_of(launches: dict) -> dict:
    """The kernel events that wrapper launches on the model's path give
    (the level-3 backward: ``BACKWARD_KERNELS`` a call; K3's backward one),
    by the wrappers that launch kernels."""
    return {k: v * (BACKWARD_KERNELS if k == "motif_level3_backward" else 1)
            for k, v in launches.items() if k in TRACE_KERNEL_NAMES}


def component_labels(adj):
    """Each node's component label (the least node index it reaches) for
    every graph of ``adj`` [..., N, N], by min-label propagation."""
    import numpy as np

    a = adj > 0.5
    lab = np.broadcast_to(np.arange(a.shape[-1], dtype=np.float64), a.shape[:-1]).copy()
    for _ in range(a.shape[-1]):
        new = np.minimum(lab, np.where(a, lab[..., None, :], np.inf).min(-1))
        if np.array_equal(new, lab):
            break
        lab = new
    return lab


def run_native():
    """The port's native library (``utils/native.py``): built from the
    checkout with the host's C++ compiler; S = 10 trees per graph of the
    synthetic2 and protein train splits (N = 25, 50), each tree inside A,
    symmetric, with N - c undirected edges for A's c components and
    spanning each of them (a forest where A is disconnected); two calls
    bit-equal; host ms of the native and numpy samplers;
    ``pairwise_distances`` on protein's coordinates within 1e-12 of numpy
    in float64."""
    import numpy as np

    from snd_vae_tpu_torch.config import protein_preset, synthetic2_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset
    from snd_vae_tpu_torch.data.spanning_tree import sample_spanning_trees
    from snd_vae_tpu_torch.utils import native

    t0 = time.perf_counter()
    native.load()
    out = {"compiler": native.build_info.get("compiler", " ".join(native.compiler())),
           "compiler_version": subprocess.run(
               native.compiler() + ["--version"], capture_output=True, text=True,
               timeout=60).stdout.splitlines()[0],
           "build_seconds": native.build_info.get("seconds", 0.0),
           "load_seconds": time.perf_counter() - t0,
           "library": str(native.library_path().relative_to(ROOT))}
    coords = None
    for name, preset in (("synthetic2", synthetic2_preset), ("protein", protein_preset)):
        batch = load_dataset(preset(dataset_path=str(ROOT / "dataset")), "train", device="cpu")
        adj = batch.adj.numpy().astype(np.float64)
        G, N = adj.shape[:2]
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            trees = sample_spanning_trees(adj, NATIVE_SAMPLES, seed=1)
            ms.append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(trees, sample_spanning_trees(adj, NATIVE_SAMPLES, seed=1)),
              f"native {name}: two calls differ")
        t0 = time.perf_counter()
        sample_spanning_trees(adj, NATIVE_SAMPLES, seed=1, use_native=False)
        numpy_ms = (time.perf_counter() - t0) * 1e3
        check(trees.shape == (G, NATIVE_SAMPLES, N, N) and trees.dtype == np.float64,
              f"native {name}: trees {trees.shape} {trees.dtype}")
        check(bool(np.all(trees <= adj[:, None])) and
              np.array_equal(trees, np.swapaxes(trees, -1, -2)),
              f"native {name}: a tree leaves A or is not symmetric")
        comps = component_labels(adj)
        n_comps = (comps == np.arange(N)).sum(-1)
        check(np.array_equal(component_labels(trees), np.broadcast_to(
            comps[:, None], trees.shape[:-1])), f"native {name}: a tree does not span A")
        check(np.array_equal(trees.sum((-1, -2)) / 2, np.broadcast_to(
            (N - n_comps)[:, None], trees.shape[:2]).astype(np.float64)),
            f"native {name}: edge counts")
        out[name] = {"graphs": G, "nodes": N, "samples": NATIVE_SAMPLES,
                     "disconnected_graphs": int((n_comps > 1).sum()),
                     "native_ms": statistics.median(ms), "numpy_ms": numpy_ms}
        coords = batch.coords.numpy().astype(np.float64)
    t0 = time.perf_counter()
    dist = native.pairwise_distances(coords)
    pd_ms = (time.perf_counter() - t0) * 1e3
    want = np.linalg.norm(coords[:, :, None] - coords[:, None, :], axis=-1)
    err = float(np.abs(dist - want).max())
    check(err <= 1e-12, f"native pairwise_distances off numpy by {err}")
    out["pairwise_distances"] = {"shape": list(coords.shape), "max_abs_err": err,
                                 "native_ms": pd_ms}
    return out


def decode_png(path):
    """An 8-bit RGB PNG as ``raster.write_png`` writes it, decoded with
    zlib: the signature, every chunk's CRC, IHDR first, IDAT, IEND last,
    and every row unfiltered (filter type 0).  Returns the [H, W, 3]
    pixels."""
    import struct
    import zlib

    import numpy as np

    data = Path(path).read_bytes()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: no PNG signature")
    pos, kinds, idat, ihdr = 8, [], b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        check(crc == zlib.crc32(kind + body) & 0xFFFFFFFF, f"{path}: bad CRC in {kind}")
        kinds.append(kind)
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    check(kinds[0] == b"IHDR" and kinds[-1] == b"IEND" and b"IDAT" in kinds,
          f"{path}: chunks {kinds}")
    w, h, depth, color = ihdr[:4]
    check((depth, color) == (8, 2), f"{path}: depth {depth}, colour type {color}")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    check(not raw[:, 0].any(), f"{path}: filtered rows")
    return raw[:, 1:].reshape(h, w, 3)


def check_png(path, size) -> dict:
    """The PNG at ``path`` decodes, has ``size`` (width, height) and more
    than its background colour."""
    import numpy as np

    pixels = decode_png(path)
    h, w = pixels.shape[:2]
    check((w, h) == tuple(size), f"{path}: {w}x{h}, expected {size[0]}x{size[1]}")
    background = pixels[0, 0]
    drawn = float((pixels != background).any(-1).mean())
    check(drawn > 0.005, f"{path}: {drawn:.4f} of the pixels differ from the background")
    return {"size": [w, h], "drawn_share": drawn, "bytes": Path(path).stat().st_size}


def run_cli_profile(untraced_epoch_s: float):
    """``python -m snd_vae_tpu_torch.cli --type train --epochs 2 --profile``
    at synthetic2 full width, in a process of its own as a user runs it
    (timeout 600 s), on the default dispatch: the trace
    ``<workdir>/profile/trace_rank0.json`` holds one ``train_epoch`` range
    over epoch 1's 20 replays (no ``train_step`` range: a replay runs no
    Python) and their kernel events: 40 ``motif_level3``, 40 of its
    backward (one kernel a call), 40 ``adj_matmul``, 40 of K3's backward, no
    ``motif_combine``; the counts written beside it are the trace's own
    (``check_written_trace``: 20 replays, each with its graph's kernel,
    copy and stamp nodes' records, none missing).  The traced
    epoch's wall time (the profiler's start and stop included) and its
    ``train_epoch`` range, each against
    ``untraced_epoch_s``, an untraced replayed f32 epoch's seconds from the
    graphs phase.  A process that has traced before is the ``trace_twice``
    phase's case; this one holds the CLI as a user runs it."""
    import re
    import tempfile

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as workdir:
        cmd = [sys.executable, "-m", "snd_vae_tpu_torch.cli", "--type", "train", "--epochs",
               str(PROFILE_EPOCHS), "--profile", "--workdir", workdir,
               "--dataset-path", str(ROOT / "dataset")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                              env=dict(os.environ, PYTHONPATH=str(ROOT)))
        out = {"command_seconds": time.perf_counter() - t0}
        check(proc.returncode == 0, f"cli_profile exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        got = json.loads(proc.stdout.splitlines()[-1])
        check(math.isfinite(got["loss"]), f"cli_profile loss {got['loss']}")
        secs = [float(v) for v in re.findall(r"^epoch time= (\S+)$", proc.stdout, re.M)]
        check(len(secs) == PROFILE_EPOCHS, f"cli_profile epoch times {secs}")
        written = re.findall(r"^profile: (\S+) written in (\S+) s$", proc.stdout, re.M)
        path = Path(workdir) / "profile" / "trace_rank0.json"
        check(len(written) == 1 and Path(written[0][0]) == path and path.exists(),
              f"cli_profile trace {written}")
        events = json.loads(path.read_text())["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        trace_counts = trace_kernel_events(events)
        # a host range appears once as "user_annotation"; the device's
        # projection of it ("gpu_user_annotation") is left out
        host_ranges = lambda name: [e for e in events
                                    if e.get("name") == name and e.get("cat") == "user_annotation"]
        epoch_ranges, steps = host_ranges("train_epoch"), host_ranges("train_step.forward")
        check(len(epoch_ranges) == 1 and not steps,
              f"cli_profile: {len(epoch_ranges)} train_epoch ranges, {len(steps)} "
              "train_step.forward ranges, expected 1 and none (replays)")
        check(trace_counts == events_of(per(20, 2, 2, 2, 2)),
              f"cli_profile trace kernels {trace_counts}, expected 40 / 40 / 0 / 40 / 40")
        written_counts = json.loads((path.parent / "trace_rank0.launches.json").read_text())
        rec = trace_records(path)
        check_written_trace("cli_profile", rec, written_counts, replays=20)
        range_s = epoch_ranges[0]["dur"] / 1e6
        out.update(
            epoch_seconds=secs, traced_epoch_range_seconds=range_s,
            untraced_epoch_seconds=untraced_epoch_s,
            traced_wall_over_untraced=secs[1] / untraced_epoch_s,
            traced_range_over_untraced=range_s / untraced_epoch_s,
            trace_write_seconds=float(written[0][1]), trace_mb=path.stat().st_size / 2 ** 20,
            written=written_counts, graph_records=rec["graph_records"],
            trace_kernel_events=trace_counts, trace_all_kernels=len(kernels),
            trace_device_ms=sum(e.get("dur", 0) for e in kernels) / 1e3)
    return out


TRACE_GRAPHS = 40         # trace_twice: 4 steps an epoch
TRAINER_TRACES = 8        # trace_twice: Trainer traces in this process


def trace_records(path) -> dict:
    """A Chrome trace's kernel events by wrapper; its graph launches (host
    events ``*GraphLaunch*``), the device records (kernel, memcpy, memset)
    that carry their correlation ids, and those that carry an eager
    launch's; and, to see which records go missing, the kernel launches on
    the host (CUDA runtime and driver events named ``*LaunchKernel*``,
    those inside a capture's range left out: they run nothing) whose
    correlation id no device event carries: their count and positions in
    launch order, and when they ran.
    Times in µs from the trace's start (its "Iteration Start" instant where
    it has one, else its first launch): of the first launch, of the first
    kernel record and of the lost launches; the margins between the
    window's edges and the device's records (the first record's start
    after the "Iteration Start" instant, the "Record Window End" instant
    after the last record's end: the profiler keeps only the records
    inside the window); and the device's start of each kept record less
    its launch's host time (min, median and max: below 0 the two clocks
    disagree)."""
    from snd_vae_tpu_torch.train import CAPTURE_RANGE

    events = json.loads(Path(path).read_text())["traceEvents"]
    captures = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events
                if e.get("name") == CAPTURE_RANGE and e.get("cat") == "user_annotation"]
    api = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    launches = sorted((e for e in api if "LaunchKernel" in e.get("name", "")
                       and not any(a <= float(e["ts"]) <= b for a, b in captures)),
                      key=lambda e: e.get("ts", 0))
    replays = {e.get("args", {}).get("correlation") for e in api
               if "GraphLaunch" in e.get("name", "")}
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    on_device = {e.get("args", {}).get("correlation") for e in device}
    eager = {e.get("args", {}).get("correlation") for e in launches}
    missing = [i for i, e in enumerate(launches)
               if e.get("args", {}).get("correlation") not in on_device]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    instants = [(e.get("name"), e.get("ts")) for e in events if e.get("ph") == "i"]
    starts = [ts for name, ts in instants if "Start" in (name or "")]
    t0 = float(starts[0]) if starts else (float(launches[0]["ts"]) if launches else 0.0)
    launch_ts = {e.get("args", {}).get("correlation"): float(e["ts"]) for e in launches}
    lag = sorted(float(e["ts"]) - launch_ts[c] for e in device
                 if (c := e.get("args", {}).get("correlation")) in launch_ts)
    ends = [ts for name, ts in instants if "Window End" in (name or "")]
    last_end = max((float(e["ts"]) + float(e.get("dur", 0)) for e in device), default=None)
    return {"kernel_events": trace_kernel_events(events), "host_launches": len(launches),
            "graph_launches": len(replays),
            "graph_records": sum(e.get("args", {}).get("correlation") in replays
                                 for e in device),
            "eager_records": sum(e.get("args", {}).get("correlation") in eager
                                 for e in device),
            "launches_without_kernel": len(missing), "missing_positions": missing[:20],
            "last_missing_position": missing[-1] if missing else None,
            "missing_names": [launches[i].get("name") for i in missing[:5]],
            "missing_us": [float(launches[i]["ts"]) - t0 for i in missing[:20]],
            "first_kernels": [e.get("name", "")[:40] for e in kernels[:4]],
            "instants": instants[:4],
            "first_launch_us": float(launches[0]["ts"]) - t0 if launches else None,
            "first_kernel_us": float(kernels[0]["ts"]) - t0 if kernels else None,
            "first_launch_to_first_kernel_us": (kernels[0]["ts"] - launches[0]["ts"]
                                                if kernels and launches else None),
            "first_record_after_start_us": (min(float(e["ts"]) for e in device) - t0
                                            if device and starts else None),
            "window_end_after_last_record_us": (float(ends[0]) - last_end
                                                if ends and last_end is not None else None),
            "kernel_after_launch_us": ([lag[0], statistics.median(lag), lag[-1]]
                                       if lag else None)}


def run_trace_twice(ml, mc, am):
    """Faults 3.2 and 3.5 in a process that has traced before (this one:
    every profile above).  ``TRAINER_TRACES`` Trainers (synthetic2 full
    width, f32, 40 graphs of the train split, 4 steps an epoch) each run 2
    epochs with ``profile_dir``, the package's own tracing: each trace's
    kernel events of every wrapper must equal the wrappers' launches in the
    traced epoch, in every trace (the Trainer's profiler warms up on a
    discarded forward and backward of the epoch's first batch, whose
    launches the run's count holds too, and keeps ``TRACE_MARGIN_S`` of
    idle card at each end of its window), and the counts written beside
    each trace must be the trace's own (``check_written_trace``).  The
    first Trainer steps per step; the others trace their default dispatch,
    epoch 1's replays.
    Before them, as the diagnostic of what that repairs, only reported,
    the same epoch twice under a bare ``torch.profiler.profile`` started at
    the epoch's first launch (the Trainer's tracing before the warm-up),
    and twice under a profiler whose discarded warm-up step is only four
    tiny kernels and one synchronize (too short a warm-up).  For every
    trace, the host launches without a kernel record, their positions in
    launch order, the time from the first launch to the first kernel
    record, the window's margins and the clocks' lags
    (``trace_records``)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    from snd_vae_tpu_torch import train as tt
    from snd_vae_tpu_torch.config import synthetic2_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset

    cfg = synthetic2_preset(dataset_path=str(ROOT / "dataset"))
    data = load_dataset(cfg, "train", num_graphs=TRACE_GRAPHS, device="cuda")
    nb = data.batch_size // cfg.train.batch_size
    out = {"steps_per_epoch": nb, "bare": [], "warmup": [], "trainer": []}
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as workdir:
        bare = tt.Trainer(cfg, data, device="cuda", workdir=f"{workdir}/bare")
        bare.run_epoch(0)
        for k, variant in enumerate(("bare", "warmup", "bare", "warmup")):
            torch.cuda.synchronize()
            zero_counts(ml, mc, am)
            warm = variant == "warmup"
            with profile(activities=activities, acc_events=True,
                         **({"schedule": schedule(wait=0, warmup=1, active=1)} if warm
                            else {})) as prof:
                if warm:
                    for _ in range(4):
                        torch.ones(1, device="cuda").add_(1)
                    torch.cuda.synchronize()
                    prof.step()
                with record_function("train_epoch"):
                    bare.run_epoch(1 + k)
                torch.cuda.synchronize()
            launches = read_counts(ml, mc, am)
            path = f"{workdir}/{variant}_{k}.json"
            prof.export_chrome_trace(path)
            rec = trace_records(path)
            out[variant].append(dict(rec, expected_events=events_of(launches),
                                     equal=rec["kernel_events"] == events_of(launches)))
        for k in range(TRAINER_TRACES):
            stepped = k == 0
            tr = tt.Trainer(cfg, data, device="cuda", workdir=f"{workdir}/trainer_{k}")
            zero_counts(ml, mc, am)
            tr.run(2, verbose=False, per_step=stepped,
                   profile_dir=f"{workdir}/trainer_{k}/profile")
            launches = read_counts(ml, mc, am)
            # the warm-up's forward and backward (2 of each) and 2 epochs of
            # steps, or, replayed, the eager first step and the capture
            steps = 2 * nb + 1 if stepped else 3
            check(launches == per(steps, 2, 2, 2, 2), f"trace_twice launches {launches}")
            want = events_of(per(nb, 2, 2, 2, 2))
            rec = trace_records(f"{workdir}/trainer_{k}/profile/trace_rank0.json")
            written = json.loads(Path(f"{workdir}/trainer_{k}/profile/"
                                      "trace_rank0.launches.json").read_text())
            check(written["graph_replays"] == (0 if stepped else nb),
                  f"trace_twice trace {k}: {written['graph_replays']} replays traced")
            out["trainer"].append(dict(rec, expected_events=want, written=written,
                                       dispatch="per step" if stepped else "replays",
                                       equal=rec["kernel_events"] == want))
    return out


def check_trace_twice(out) -> None:
    """Every Trainer trace holds exactly the wrappers' launches, and what
    ``Trainer.run`` wrote beside it is the trace's own
    (``check_written_trace``)."""
    for k, rec in enumerate(out["trainer"]):
        check(rec["equal"], f"trace_twice: trace {k} holds {rec['kernel_events']} kernel "
              f"events, the wrappers launched {rec['expected_events']}")
        check_written_trace(f"trace_twice trace {k} ({rec['dispatch']})", rec, rec["written"])


def check_written_trace(label, rec, written, replays=None) -> None:
    """A ``--profile`` trace (``trace_records``) against the counts
    ``Trainer.run`` wrote beside it: no device record missing by either
    count; the trace's graph launches the replays written (``replays``
    when given); the device records carrying their ids the graph's kernel,
    copy and stamp nodes times the replays (a profiled run's graph holds
    ``stamps_per_replay`` stamp kernels besides its kernels); the kernel
    records of the eager launches as many as the launches written."""
    nodes = (written["kernels_per_replay"] + written["copies_per_replay"]
             + written.get("stamps_per_replay", 0))
    check(written["launches_without_device_record"] == 0 and rec["launches_without_kernel"] == 0
          and rec["graph_launches"] == written["graph_replays"]
          and (replays is None or written["graph_replays"] == replays)
          and rec["graph_records"] == nodes * written["graph_replays"]
          and rec["eager_records"] == rec["host_launches"] == written["host_launches"],
          f"{label}: wrote {written}; the Chrome trace holds {rec['graph_launches']} graph "
          f"launches with {rec['graph_records']} device records, {rec['host_launches']} "
          f"eager launches with {rec['eager_records']}, {rec['launches_without_kernel']} "
          f"without a record (expected {replays} replays)")


LARGE_GRAPH_NODES = (2048, 8192)   # benchmarks/large_graph_bench.py's graphs
LARGE_GRAPH_DENSITY = 0.01
LARGE_GRAPH_WIDTH = 128            # F = H = 128, two layers
LARGE_GRAPH_REPS = 20


def large_graph_case(am, lg, mesh, adj, x):
    """One normalized graph through the encoder's kernel and library paths
    (see ``run_large_graph``); returns the phase's row and each path's last
    layer and pooled vector."""
    n, W = x.shape
    dtype = x.dtype
    encs = {name: lg.ShardedGCNEncoder(mesh, (W, W), W, torch.Generator().manual_seed(1),
                                       use_kernel=name == "kernel").to("cuda", dtype)
            for name in ("kernel", "library")}
    row = {"launches": {}, "layers": []}
    pooled, h = {}, {name: x for name in encs}
    with torch.no_grad():
        for name, enc in encs.items():
            am.blocked_adj_matmul.launches = 0
            pooled[name] = enc(adj, x)
            torch.cuda.synchronize()
            row["launches"][name] = am.blocked_adj_matmul.launches
        check(row["launches"] == {"kernel": 2, "library": 0},
              f"large_graph N={n} {dtype}: launches {row['launches']}, expected 2 K3 per "
              "apply with the kernel and none without")
        for w in encs["kernel"].kernels:
            lay = dict(zip(("bound_ms", "bound_by"), bound(
                x.element_size() * (n * n + n * W + W * W + n * W),
                2 * n * W * W + 2 * n * n * W + 2 * n * W, dtype)))
            for name in encs:
                conv = lambda hn=h[name], k=name == "kernel": lg.sharded_graph_conv(
                    adj, hn, w, mesh, use_kernel=k)
                got = conv()
                if dtype == torch.float32:
                    lay[f"{name}_err_vs_f64"], _ = compare_f64_bound(
                        got, [adj, h[name], w], n + W,
                        lambda aa, hh, ww: am.adj_matmul_plain(aa, hh, 0.2, ww))
                lay[f"{name}_ms"] = device_ms(conv, reps=LARGE_GRAPH_REPS)
                lay[f"{name}_busy"] = busy_ms(conv)
                h[name] = got
            if dtype == torch.bfloat16:
                lay["kernel_vs_library_err"] = compare(h["kernel"], h["library"], dtype)
            row["layers"].append(lay)
        row["pooled_kernel_vs_library_err"] = (
            compare(pooled["kernel"], pooled["library"], dtype) if dtype == torch.bfloat16
            else (pooled["kernel"] - pooled["library"]).abs().max().item())
        # K3 alone on the first layer's operands, beside its plain version
        # and one library call of the same function
        xw = am.project(x, encs["kernel"].kernels[0])
        row["k3"] = dict(zip(("bound_ms", "bound_by"), bound(
            x.element_size() * (n * n + 2 * n * W), 2 * n * n * W + 2 * n * W, dtype)))
        row["k3"].update(
            shape=[[n, n], [n, W]],
            ms=device_ms(lambda: am.blocked_adj_matmul(adj, xw, 0.2), reps=LARGE_GRAPH_REPS),
            plain_ms=device_ms(lambda: am.adj_matmul_plain(adj, xw, 0.2), reps=LARGE_GRAPH_REPS),
            library_ms=device_ms(lambda: torch.nn.functional.leaky_relu(torch.mm(adj, xw), 0.2),
                                 reps=LARGE_GRAPH_REPS))
        for name, enc in encs.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            row[f"{name}_apply_ms"] = device_ms(lambda enc=enc: enc(adj, x),
                                                reps=LARGE_GRAPH_REPS)
            row[f"{name}_peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
            row[f"{name}_apply_busy"] = busy_ms(lambda enc=enc: enc(adj, x))
    # the backward: the kernels' gradients of the pooled vector through K3's
    # backward (one launch per layer) against the library path's autograd,
    # f32 within 1e-4 and bf16 within 2e-2 of the largest magnitude (the
    # sums over N rows run in another order)
    gp = torch.randn(pooled["kernel"].shape, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(2)).to(dtype)
    grads, row["backward_launches"] = {}, {}
    for name, enc in encs.items():
        am.fused_adj_matmul_backward.launches = 0
        grads[name] = torch.autograd.grad(enc(adj, x), list(enc.kernels), gp)
        torch.cuda.synchronize()
        row["backward_launches"][name] = am.fused_adj_matmul_backward.launches
    check(row["backward_launches"] == {"kernel": 2, "library": 0},
          f"large_graph N={n} {dtype}: backward launches {row['backward_launches']}, expected "
          "2 of K3's backward with the kernel and none without")
    errs = []
    for got, want in zip(grads["kernel"], grads["library"]):
        err, top = (got.float() - want.float()).abs().max().item(), want.float().abs().max().item()
        check(err <= (1e-4 if dtype == torch.float32 else 2e-2) * top,
              f"large_graph N={n} {dtype}: kernel gradient {err} from the library's (max {top})")
        errs.append(err)
    row["backward_kernel_vs_library_err"] = errs
    row["backward_ms"] = {name: device_ms(lambda enc=enc: torch.autograd.grad(
        enc(adj, x), list(enc.kernels), gp), reps=LARGE_GRAPH_REPS) for name, enc in encs.items()}
    return row, h, pooled, [w.detach() for w in encs["kernel"].kernels]


def run_large_graph(am, mesh):
    """The node-sharded GCN encoder (parallel/large_graph.py) in an NCCL
    group of one: graphs as benchmarks/large_graph_bench.py builds them
    (symmetric, density 0.01, F = H = 128) at N = 2048 and 8192, normalized
    by ``sharded_gcn_normalize``, through a ShardedGCNEncoder of hidden
    (128, 128) with ``use_kernel`` True and False, f32 and bf16.  Counts 2
    K3 launches per apply with the kernel and none without, and 2 of K3's
    backward per gradient of the kernels (held to the library path's).  Each f32 layer
    of either path within the summation bound of N + F terms of a float64
    run on the same input; bf16 within 2e-2 of the library path's largest
    magnitude, layer by layer and pooled; at N = 2048 the card's
    normalized adjacency, last layer and pooled vector against the CPU's
    (the dense ``gcn_normalize`` and the layers' plain versions) at rtol
    1e-4.  Reports device ms per apply and per layer of each path with each
    layer's bound, K3 alone on the first layer's operands beside its plain
    version and torch.mm + leaky_relu, the normalize's device ms and each
    apply's peak of allocated memory."""
    from snd_vae_tpu_torch.data.transforms import gcn_normalize
    from snd_vae_tpu_torch.parallel import large_graph as lg

    W = LARGE_GRAPH_WIDTH
    out = {"density": LARGE_GRAPH_DENSITY, "hidden": [W, W], "features": W,
           "launches": 0, "backward_launches": 0}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in LARGE_GRAPH_NODES:
        a = (torch.rand(n, n, generator=gen, device="cuda") < LARGE_GRAPH_DENSITY).float().triu(1)
        a = a + a.T
        x32 = torch.randn(n, W, generator=gen, device="cuda")
        res = {"normalize_ms": device_ms(lambda: lg.sharded_gcn_normalize(a, mesh),
                                         reps=LARGE_GRAPH_REPS),
               "normalize_busy": busy_ms(lambda: lg.sharded_gcn_normalize(a, mesh))}
        adj32 = lg.sharded_gcn_normalize(a, mesh)
        a_cpu = a.cpu() if n == LARGE_GRAPH_NODES[0] else None
        del a
        for dtype in (torch.float32, torch.bfloat16):
            row, h, pooled, ws = large_graph_case(am, lg, mesh, adj32.to(dtype), x32.to(dtype))
            if dtype == torch.float32:
                out["launches"] += row["launches"]["kernel"]
                out["backward_launches"] += row["backward_launches"]["kernel"]
            if a_cpu is not None and dtype == torch.float32:
                adj_cpu = gcn_normalize(a_cpu)
                torch.testing.assert_close(adj32.cpu(), adj_cpu, rtol=1e-5, atol=1e-7)
                hc = x32.cpu()
                for w in ws:
                    hc = am.adj_matmul_plain(adj_cpu, hc, 0.2, w.cpu())
                for name in ("kernel", "library"):
                    torch.testing.assert_close(h[name].cpu(), hc, rtol=1e-4, atol=1e-6)
                    torch.testing.assert_close(pooled[name].cpu(), hc.sum(0) / n,
                                               rtol=1e-4, atol=1e-7)
                row["card_vs_cpu_max_abs_err"] = {
                    "last_layer": max((h[k].cpu() - hc).abs().max().item() for k in h),
                    "pooled": max((pooled[k].cpu() - hc.sum(0) / n).abs().max().item()
                                  for k in pooled)}
            res[str(dtype)[6:]] = row
        out[str(n)] = res
        del adj32, x32
    torch.cuda.empty_cache()
    return out


def run_dp(ml, mc, am, mesh):
    """The data-parallel Trainer at synthetic2 full width in the NCCL group
    of one (``mesh=make_mesh(1, 1)``): Trainer.run for 2 epochs f32 per
    step from the seed weights, counted (2 motif_level3 and 2 adj_matmul
    per step, no motif_combine), its peak memory; its default dispatch
    against it (``mesh_graphs``: CUDA-graph replays with the NCCL
    collectives captured, bit for bit, chunks and a resume, kernel
    records, steps/s and busy share of both dispatches in turns, the
    capture); its per-epoch losses equal to a mesh-less Trainer's
    from the same seed at rtol 1e-6; the steps/s of both over one epoch
    each, run in turns (mesh, plain, plain, mesh, twice) after the counted
    runs.  The difference is the host cost of the collectives: the loss
    terms' all-reduce (forward and backward), the edge accuracy's and the
    gradients' one flattened all-reduce per step; each is also timed alone
    (host µs per call, the card synchronized after the calls), with a
    one-element all-reduce.  A profile of 5 steps of each: wall and busy
    ms, kernels, the top host ops."""
    import tempfile

    from snd_vae_tpu_torch import train as tt
    from snd_vae_tpu_torch.config import synthetic2_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset

    cfg = synthetic2_preset(dataset_path=str(ROOT / "dataset"))
    B = cfg.train.batch_size
    data = load_dataset(cfg, "train", device="cuda")
    nb = data.batch_size // B
    out = {"batch": [B, cfg.sampling_num, cfg.num_nodes], "steps_per_epoch": nb,
           "epochs": TRAIN_EPOCHS}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as workdir:
        trainers, means, logs = {}, {}, {}
        for name, m in (("mesh", mesh), ("no_mesh", None)):
            trainers[name] = tt.Trainer(cfg, data, device="cuda", workdir=f"{workdir}/{name}",
                                        mesh=m)
            logs[name] = logged(trainers[name])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts(ml, mc, am)
            trainers[name].run(TRAIN_EPOCHS, verbose=False, per_step=True)
            launches = read_counts(ml, mc, am)
            steps = TRAIN_EPOCHS * nb
            check(launches == per(steps, ml3=2, k3=2, bwd=2, k3b=2),
                  f"dp {name}: launches {launches} over {steps} steps, expected 2 of "
                  "motif_level3, adj_matmul and their backwards per step, no motif_combine "
                  "and no adj_matmul_plain")
            with open(trainers[name].logger.jsonl_path) as f:
                means[name] = [json.loads(line)["loss"] for line in f]
            out[name] = {"launches": launches, "epoch_mean_loss": means[name],
                         "launches_per_step": {k: v / steps for k, v in launches.items()},
                         "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
        check(all(math.isfinite(v) for v in means["mesh"]), f"dp losses {means['mesh']}")
        # the default dispatch on the mesh, against the per-step run above
        out["mesh_graphs"] = mesh_graphs(ml, mc, am, "dp", cfg, data, mesh, trainers["mesh"],
                                         logs["mesh"], f"{workdir}/graphs")
        for got, want in zip(means["mesh"], means["no_mesh"]):
            check(abs(got - want) <= 1e-6 * abs(want),
                  f"dp epoch losses {means['mesh']} vs the mesh-less {means['no_mesh']}")
        secs = {"mesh": [], "no_mesh": []}
        for i, name in enumerate(("mesh", "no_mesh", "no_mesh", "mesh") * 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainers[name].run_epoch(TRAIN_EPOCHS + i)
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t0)
        for name, ts in secs.items():
            out[name]["steps_per_s"] = [nb / t for t in ts]
            out[name]["median_steps_per_s"] = statistics.median(nb / t for t in ts)
        out["mesh_over_no_mesh_step_time"] = (statistics.median(secs["mesh"])
                                              / statistics.median(secs["no_mesh"]))
        gi = torch.zeros((), device="cuda")
        batches = [data.slice_batch(i * B, B) for i in range(PROFILE_STEPS)]
        for name, tr in trainers.items():
            out[name]["profile"] = profile_steps(lambda b, tr=tr: tt.train_step(
                tr.state, b, gi), batches)
            it = iter(batches * 2)
            out[name]["host_top_ops"] = host_top_ops(
                lambda tr=tr: tt.train_step(tr.state, next(it), gi), reps=PROFILE_STEPS)
        # the data-parallel pieces of a step alone, on the mesh trainer's
        # parameters and gradients
        from snd_vae_tpu_torch.parallel.batch import average_gradients, global_mean
        from snd_vae_tpu_torch.parallel.hints import use_mesh

        params = list(trainers["mesh"].state.model.parameters())
        terms = [torch.zeros((), device="cuda", requires_grad=True) for _ in range(6)]

        def loss_terms():
            with use_mesh(mesh):
                sum(global_mean(*terms)).backward()

        one = torch.ones(1, device="cuda")
        out["host_us_per_call"] = {
            "one_element_all_reduce": host_us(
                lambda: torch.distributed.all_reduce(one, group=mesh.get_group("data"))),
            "loss_terms_all_reduce_forward_backward": host_us(loss_terms),
            "average_gradients": host_us(lambda: average_gradients(params, mesh)),
            "parameters": len(params)}
    return out


def tp_windows(ml, gen) -> dict:
    """K1's row windows, the launches the mesh's model axis makes: for m =
    2 and 4 every rank's window (``node_block``'s ceil rows, the last
    short) of [100,25,25,50] f32 and bf16 and [4,256,256,50] f32, each
    held against ``_level3_rows`` on its rows (f32 within the summation
    bound of float64, bf16 within 2e-2 of the largest magnitude) and timed;
    the windows put together against the full launch (expected bit-equal:
    each row's sums run the same way whatever the window)."""
    from snd_vae_tpu_torch.parallel.mesh import node_block

    rows, joined = [], []
    for B, N, h, dt in ((100, 25, 50, torch.float32), (100, 25, 50, torch.bfloat16),
                        (4, 256, 50, torch.float32)):
        x = level3_inputs(B, N, h, 1, dt, gen, 0.4)
        full = ml.fused_motif_level3(*x)
        for m in (2, 4):
            parts = []
            for r in range(m):
                r0, n = node_block(N, m, r)
                win = [x[0], x[1][:, r0:r0 + n].contiguous(), x[2][:, r0:r0 + n].contiguous(),
                       *x[3:]]
                got = ml.fused_motif_level3(*win, r0)
                plain = lambda *w, r0=r0, n=n: ml._level3_rows(w[0], w[0][:, r0:r0 + n], *w[1:])
                extra = {}
                if dt == torch.float32:
                    err, extra["plain_f32_err_vs_f64"] = compare_f64_bound(got, win, 2 * N + 4,
                                                                           plain)
                else:
                    err = compare(got, plain(*win), dt)
                b_ms, b_by = level3_bound(win, dt, r0)
                rows.append(dict(
                    kernel="motif_level3", path=f"tp_window_m{m}_N{N}", shape=[B, N, h],
                    window=[r0, n], rank=r, dtype=str(dt)[6:], served=False,
                    batch_shape=False, max_abs_err=err,
                    ms=device_ms(lambda w=win, r0=r0: ml.fused_motif_level3(*w, r0)),
                    plain_ms=device_ms(lambda w=win, p=plain: p(*w)),
                    bound_ms=b_ms, bound_by=b_by, library_ms=None, **extra))
                parts.append(got)
            cat = torch.cat(parts, dim=1)
            joined.append({"shape": [B, N, h], "dtype": str(dt)[6:], "m": m,
                           "bit_equal_to_full": bool(torch.equal(cat, full)),
                           "max_abs_diff_to_full": (cat.float() - full.float()).abs().max().item(),
                           "full_ms": device_ms(lambda x=x: ml.fused_motif_level3(*x))})
    return {"rows": rows, "joined": joined}


def tp_rank_rows(ml, mc, am, gen) -> dict:
    """What one model rank holds: the third-order conv's second layer at
    synthetic2 widths (20 features in, hidden 50, 50, 50, R = 1) over 10
    trees of N = 256 (density 0.02), forward and backward for rank 0's rows
    at m = 1, 2, 4 (``spatial_graph_conv(..., rows=(0, ceil(N/m)))``, the
    rank-local computation the collectives wrap): one K1 launch each, the
    peak of allocated memory above the inputs, the ms by events and the
    device-busy ms (the call is ~100 kernels, so the events also time the
    card's waits on the host); the rows of m = 2 and 4 equal the same rows
    of m = 1's output (rtol 1e-5)."""
    from snd_vae_tpu_torch.nn import SpatialGraphConv
    from snd_vae_tpu_torch.nn.spatial_conv import spatial_graph_conv

    N, T = 256, 10
    conv = SpatialGraphConv(20, 1, (50, 50, 50), torch.Generator().manual_seed(0)).cuda()
    params = dict(conv.named_parameters())
    adj = (torch.rand(T, N, N, generator=gen, device="cuda") < 0.02).float().triu(1)
    adj = adj + adj.transpose(1, 2)
    x = torch.randn(T, N, 20, generator=gen, device="cuda")
    rel = torch.rand(T, N, N, 1, generator=gen, device="cuda")
    out, full = {}, None
    for m in (1, 2, 4):
        n = -(-N // m)
        g = torch.randn(T, n, 50, generator=gen, device="cuda")

        def step(n=n, g=g):
            xx = x.clone().requires_grad_(True)
            y = spatial_graph_conv(adj, xx, rel, params, rows=(0, n))
            torch.autograd.backward(y, g)
            return y.detach()

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(ml, mc, am)
        y = step()
        launches = read_counts(ml, mc, am)
        check(launches == per(1, ml3=1, bwd=1), f"tp rank rows m={m}: launches {launches}")
        peak = torch.cuda.max_memory_allocated() - base
        for p in params.values():
            p.grad = None
        if full is None:
            full = y
        else:
            torch.testing.assert_close(y, full[:, :n], rtol=1e-5, atol=1e-5)
        out[f"m{m}"] = {"rows": [0, n], "launches": launches, "peak_above_inputs_bytes": peak,
                        "forward_backward_ms": device_ms(step, reps=10),
                        "forward_backward_busy": busy_ms(step)}
    return out


E2E_ROWS_SIZES = (512, 2048)   # E2E layer 2 at the frontier: held at 512, timed at 2048
E2E_ROWS_M = 4
E2E_ROWS_RANKS = (0, E2E_ROWS_M - 1)


def conv_kernels(prof) -> dict:
    """The device kernels of a profile with their count and ms, by name."""
    from torch.autograd import DeviceType

    return {e.key[:60]: [e.count, e.self_device_time_total / 1e3]
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)}


def e2e_rows_step(N, dt, gen, rank=None):
    """E2E layer 2 of the frontier (x [2,N,N,50] -> 20 channels, k_h = N,
    ``e_d_hidden = (50, 20)``) as one model rank of m = 4 computes it
    without a process group: ``_row_col_conv_rows`` of rank ``rank``'s rows
    (``node_block``; rank 3 holds the short last block, its window padded
    below) and the whole map; with ``rank`` None the single-process
    ``_RowColConv`` of the whole map.  Returns (forward, backward, leaves,
    output gradients): the forward makes the outputs from fresh leaves,
    the backward takes them with seeded output gradients."""
    from snd_vae_tpu_torch.nn.edge_conv import _row_col_conv_rows, _row_col_convs
    from snd_vae_tpu_torch.parallel.mesh import node_block

    x = torch.randn(2, N, N, 50, generator=gen, device="cuda").to(dt)
    w = (0.02 * torch.randn(20, 50, 1, N, generator=gen, device="cuda")).to(dt)
    b = (0.1 * torch.randn(20, generator=gen, device="cuda")).to(dt)
    start, n = (0, N) if rank is None else node_block(N, E2E_ROWS_M, rank)
    g = [torch.randn(2, 20, n, N, generator=gen, device="cuda").to(dt) for _ in range(2)]
    leaves = {"rows": x[:, start:start + n].clone().requires_grad_(), "whole": x,
              "w": w.requires_grad_(), "b": b.requires_grad_()}
    if rank is not None:
        x.requires_grad_()
    else:
        leaves["whole"] = leaves.pop("rows")

    def forward():
        if rank is None:
            return _row_col_convs(leaves["whole"].permute(0, 3, 1, 2), w, b)
        return _row_col_conv_rows(leaves["rows"].permute(0, 3, 1, 2),
                                  leaves["whole"].permute(0, 3, 1, 2), start, w, b)

    def backward(out):
        for t in leaves.values():
            t.grad = None
        torch.autograd.backward(out, g)

    return forward, backward, leaves, g, (start, n)


def warmed_profile(fn):
    """``fn()`` under the profiler after a discarded warm-up step of 20 ms
    of one-element kernels, each waited for (a trace's first kernels can
    otherwise lose their records), timed by CUDA events around it: (its
    result, its device ms, its kernels by name with count and ms)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        x = torch.zeros(1, device="cuda")
        stop = time.perf_counter() + 0.02
        while time.perf_counter() < stop:
            x.add_(1)
            torch.cuda.synchronize()
        prof.step()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
    return out, start.elapsed_time(end), conv_kernels(prof)


def e2e_rows_timed(forward, backward) -> dict:
    """One forward and one backward, each under ``warmed_profile``: the
    device ms of each by CUDA events (a few convolutions of ~0.3-4 s each,
    so the events time the device's work), the device-busy ms of each and
    the backward's kernels by name from the profiler, and the peak of
    allocated memory above what was allocated before, over both."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, fwd, fk = warmed_profile(forward)
    _, bwd, bk = warmed_profile(lambda: backward(out))
    busy = lambda k: sum(v[1] for v in k.values())
    return {"forward_ms": fwd, "backward_ms": bwd, "ms": fwd + bwd,
            "forward_busy_ms": busy(fk), "backward_busy_ms": busy(bk),
            "peak_above_inputs_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "backward_kernels": bk}


def tp_e2e_rows(gen) -> dict:
    """Fault 3.4's repair on the card: E2E layer 2 of the frontier on one
    model rank's rows, as ``E2E._rows`` runs it under a model axis, in f32
    and bf16 at m = 4, for rank 0 and rank 3, forward and backward.  At N =
    512 each rank's outputs and gradients (∂rows, ∂whole, ∂w, ∂b) are held
    against the single-process ``_RowColConv`` of the whole map: its
    output's same rows, and its gradients for output gradients that are the
    rank's on those rows and zero elsewhere, ∂rows against the row conv's
    part and ∂whole against the column conv's (f32 at rtol 1e-5, bf16
    within 2e-2 of the largest magnitude).  At N = 2048 each rank's
    forward and backward (``e2e_rows_timed``: device ms by events and
    device-busy ms, the backward's conv kernels, the peak above the
    inputs) against the whole map's ``_RowColConv``
    once in f32 in the same call: every f32 rank's device ms must be
    less (before the repair the window's f32 backward was cuDNN's data
    gradient of a 1 x N kernel, which ran past 100 s at N = 2048)."""
    import torch.nn.functional as F

    out = {}
    for N in E2E_ROWS_SIZES:
        for dt in (torch.float32, torch.bfloat16):
            key = f"N{N}_{str(dt)[6:]}"
            res = {}
            if N == E2E_ROWS_SIZES[-1] and dt == torch.float32:
                fwd, bwd, _, _, _ = e2e_rows_step(N, dt, gen)
                res["whole_map"] = e2e_rows_timed(fwd, bwd)
                del fwd, bwd
                torch.cuda.empty_cache()
            for rank in E2E_ROWS_RANKS:
                seed = gen.initial_seed() + rank
                fwd, bwd, leaves, g, (start, n) = e2e_rows_step(
                    N, dt, torch.Generator(device="cuda").manual_seed(seed), rank)
                r = {"rows": [start, n]}
                if N == E2E_ROWS_SIZES[0]:
                    outs = fwd()
                    bwd(outs)
                    got = {k: t.grad.float() for k, t in leaves.items()}
                    x = leaves["whole"].detach()
                    ref_fwd, ref_bwd, ref_leaves, _, _ = e2e_rows_step(
                        N, dt, torch.Generator(device="cuda").manual_seed(seed))
                    with torch.no_grad():
                        ref_leaves["whole"].copy_(x)
                        ref_leaves["w"].copy_(leaves["w"])
                        ref_leaves["b"].copy_(leaves["b"])
                    ref = ref_fwd()
                    pad = lambda t: F.pad(t, (0, 0, start, N - start - n))
                    want = {}
                    for part, gs in (("row", (pad(g[0]), torch.zeros_like(ref[1]))),
                                     ("col", (torch.zeros_like(ref[0]), pad(g[1])))):
                        for t in ref_leaves.values():
                            t.grad = None
                        torch.autograd.backward(ref, gs, retain_graph=True)
                        want[part] = {k: t.grad.float() for k, t in ref_leaves.items()}
                    pairs = {"row_out": (outs[0], ref[0][:, :, start:start + n]),
                             "col_out": (outs[1], ref[1][:, :, start:start + n]),
                             "d_rows": (got["rows"], want["row"]["whole"][:, start:start + n]),
                             "d_whole": (got["whole"], want["col"]["whole"]),
                             "d_w": (got["w"], want["row"]["w"] + want["col"]["w"]),
                             "d_b": (got["b"], want["row"]["b"] + want["col"]["b"])}
                    errs = {}
                    for name, (u, v) in pairs.items():
                        u, v = u.float(), v.float()
                        errs[name] = (u - v).abs().max().item()
                        scale = v.abs().max().item()
                        ok = (errs[name] <= 2e-2 * scale if dt == torch.bfloat16 else
                              bool(torch.allclose(u, v, rtol=1e-5, atol=1e-5 * scale)))
                        check(ok, f"tp e2e rows {key} rank {rank} {name}: max |diff| "
                              f"{errs[name]} of max |ref| {scale}")
                    r["max_abs_err"] = errs
                    del ref, ref_leaves, want, got, outs
                else:
                    r.update(e2e_rows_timed(fwd, bwd))
                    if dt == torch.float32:
                        whole = res["whole_map"]["ms"]
                        check(r["ms"] < whole,
                              f"tp e2e rows {key} rank {rank}: {r['ms']} ms, the whole "
                              f"map's {whole} ms")
                del fwd, bwd, leaves, g
                torch.cuda.empty_cache()
                res[f"rank{rank}"] = r
            out[key] = res
    return out


def run_tp(ml, mc, am, mesh):
    """The mesh's model axis on one card: K1's row windows (``tp_windows``),
    what one rank holds (``tp_rank_rows``), and the Trainer at synthetic2
    full width, f32, on ``make_mesh(1, 1)`` through the model-axis code at
    a model axis of 1 (the hint sites, which report through
    ``hints._INSPECT`` and return their input, as XLA elides a trivial
    constraint, read from this per-step run: the replays of the default
    dispatch run no Python; the canonical parameter order; the whole
    checkpoint): 2 epochs per step counted (2 motif_level3 and 2
    adj_matmul per step), its default dispatch against it
    (``mesh_graphs``), per-epoch losses
    equal to a mesh-less Trainer's at rtol 1e-6, as the dp phase holds
    them, beside the spread of two mesh-less runs (the card's f32 runs are
    not bit-reproducible: ~1e-8), a checkpoint written and its tensors
    whole."""
    import tempfile

    from snd_vae_tpu_torch import train as tt
    from snd_vae_tpu_torch.config import synthetic2_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset
    from snd_vae_tpu_torch.parallel import hints

    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {"windows": tp_windows(ml, gen), "rank_rows": tp_rank_rows(ml, mc, am, gen),
           "e2e_rows": tp_e2e_rows(torch.Generator(device="cuda").manual_seed(10))}
    cfg = synthetic2_preset(dataset_path=str(ROOT / "dataset"))
    B = cfg.train.batch_size
    data = load_dataset(cfg, "train", device="cuda")
    nb = data.batch_size // B
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as workdir:
        means = {}
        for name, m in (("tp", mesh), ("no_mesh", None), ("no_mesh_again", None)):
            tr = tt.Trainer(cfg, data, device="cuda", workdir=f"{workdir}/{name}", mesh=m)
            logs = logged(tr)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            sites = {}
            hints._INSPECT = lambda tag, a, b, n: sites.__setitem__(tag, sites.get(tag, 0) + 1)
            zero_counts(ml, mc, am)
            try:
                tr.run(TRAIN_EPOCHS, verbose=False, per_step=True)
            finally:
                hints._INSPECT = None
            launches = read_counts(ml, mc, am)
            steps = TRAIN_EPOCHS * nb
            check(launches == per(steps, ml3=2, k3=2, bwd=2, k3b=2),
                  f"tp {name}: launches {launches} over {steps} steps")
            with open(tr.logger.jsonl_path) as f:
                means[name] = [json.loads(line)["loss"] for line in f]
            out[name] = {"launches": launches, "epoch_mean_loss": means[name],
                         "launches_per_step": {k: v / steps for k, v in launches.items()},
                         "hint_reports_per_step": {k: v / steps for k, v in sites.items()}}
            if name == "tp":
                check(any(t.startswith("sgc.") for t in sites)
                      and any(t.startswith("dec.") for t in sites), f"tp hint sites {sites}")
                saved = tr.checkpointer.load()["model"]
                check(all(saved[k].shape == p.shape for k, p in
                          tr.state.model.named_parameters()), "tp checkpoint whole")
                out[name]["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
                # the default dispatch through the model-axis code, against
                # this per-step run
                # on the mesh of one the dp phase's Trainer, whose chunks
                # that phase holds to one epoch a dispatch
                out["mesh_graphs"] = mesh_graphs(ml, mc, am, "tp", cfg, data, mesh, tr, logs,
                                                 f"{workdir}/graphs", chunks=False)
        rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(means[a], means[b]))
        for got, want in zip(means["tp"], means["no_mesh"]):
            check(math.isfinite(got) and abs(got - want) <= 1e-6 * abs(want),
                  f"tp epoch losses {means['tp']} vs the mesh-less {means['no_mesh']}")
        out["rel_diff_tp_vs_no_mesh"] = rel("tp", "no_mesh")
        out["rel_diff_no_mesh_vs_again"] = rel("no_mesh_again", "no_mesh")
        del out["no_mesh_again"]
    return out


def host_us(fn, n: int = 200) -> float:
    """Host µs per call of ``fn`` over ``n`` calls, the card synchronized
    before the first and after the last."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def run_cli_dp():
    """``torchrun --standalone --nproc_per_node 1 -m snd_vae_tpu_torch.cli
    --type train --dp 1 --distributed --epochs 1 --profile`` in a
    subprocess (timeout 600 s): it prints ``distributed: process 0/1`` and
    that it dispatches CUDA-graph replays (``--dp 1`` makes no mesh: the
    ``dp`` and ``tp`` phases hold the mesh's replays), a finite loss,
    and writes one checkpoint; its trace of the one epoch holds the eager
    first step, the capture (whose launches run nothing) and 19 replays,
    each with its graph's kernel and copy nodes' records, none missing
    (``check_written_trace``)."""
    import tempfile

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as workdir:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "snd_vae_tpu_torch.cli", "--type", "train",
               "--dp", "1", "--distributed", "--epochs", "1", "--profile", "--workdir", workdir,
               "--dataset-path", str(ROOT / "dataset")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                              env=dict(os.environ, PYTHONPATH=str(ROOT)))
        secs = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        check(proc.returncode == 0, f"cli_dp exited {proc.returncode}: {proc.stderr[-2000:]}")
        # --dp 1 makes no mesh: one process in a group of one
        dispatch = "dispatch: CUDA-graph replays"
        check("distributed: process 0/1" in lines and dispatch in lines,
              f"cli_dp printed {lines[:3]}")
        result = json.loads(lines[-1])
        check(math.isfinite(result["loss"]), f"cli_dp loss {result['loss']}")
        ckpts = sorted(os.listdir(Path(workdir) / "checkpoints" / "synthetic2_disentangled"))
        check(ckpts == ["ckpt_0.pt"], f"cli_dp checkpoints {ckpts}")
        profile = Path(workdir) / "profile"
        written = json.loads((profile / "trace_rank0.launches.json").read_text())
        rec = trace_records(profile / "trace_rank0.json")
        check_written_trace("cli_dp", rec, written, replays=19)
    return {"seconds": secs, "loss": result["loss"], "checkpoints": ckpts,
            "dispatch": dispatch[len("dispatch: "):], "profile": written,
            "trace_kernel_events": rec["kernel_events"]}


# The frontier: the JAX package's single-chip frontier configuration
# (benchmarks/frontier_2048.py:43-47: synthetic2's widths, B = 2 graphs x
# S = 2 trees, the separable head by the auto rule), trained and served on
# the card.  Each training variant: (N, dtype, remat, motif_block_rows,
# graphs, epochs).  Each follows a first step without remat from the seed
# weights (``frontier_first_step``): it warms the card up at the variant's
# shapes, gives the calls of (d), is the step (c) reads where the loss is
# not finite and the step (g) holds the remat step to.  At N = 2048 the
# untrained loss is not finite (see (c)), so every step after the first
# runs on NaN weights: there Trainer.run takes one step, from the seed
# weights again.
FRONTIER_VARIANTS = ((1024, "float32", False, None, 4, 2), (1024, "bfloat16", False, None, 4, 2),
                     (2048, "bfloat16", False, None, 2, 1), (2048, "float32", True, 256, 2, 1))
FRONTIER_NONFINITE_N = 2048  # the one N whose untrained loss may read non-finite, per (c)
FRONTIER_CPU_NODES = 256  # the card's step against the CPU's
FRONTIER_PLAIN_REPS = 10  # the plain versions' timing at these shapes (up to ~0.1 s a call)
FRONTIER_PLAIN_ROWS = 256  # row blocks of the float64 references
FRONTIER_WRAPPERS = (("motif_level3", "ml", "fused_motif_level3"),
                     ("motif_level3_backward", "ml", "fused_motif_level3_backward"),
                     ("adj_matmul", "am", "blocked_adj_matmul"),
                     ("adj_matmul_backward", "am", "fused_adj_matmul_backward"))


def frontier_config(n: int, dtype: str = "float32", remat: bool = False,
                    block_rows: Optional[int] = None):
    """``benchmarks/frontier_2048.py:43-47`` in the port's config: the
    synthetic2 preset in ``dtype`` with ``num_nodes=n``, ``sampling_num=2``
    and ``remat``, and a TrainConfig of its defaults but ``batch_size=2``;
    with ``motif_block_rows``."""
    from snd_vae_tpu_torch.config import synthetic2_preset

    cfg = synthetic2_preset(compute_dtype=dtype, dataset_path=str(ROOT / "dataset")).with_(
        num_nodes=n, sampling_num=2, remat=remat, motif_block_rows=block_rows)
    return cfg.with_(train=cfg.train.__class__(batch_size=2))


class capture_calls:
    """While installed, the kernel wrappers (``FRONTIER_WRAPPERS``) keep
    copies of the arguments of their first ``first`` calls (one train step
    calls each twice) in ``calls[name]``, in host memory, so that the
    step's peak of device memory holds none of them.  Each wrapper's launch
    counter stays where ``zero_counts`` / ``read_counts`` look for it."""

    def __init__(self, ml, am, first: int = 2):
        self.mods, self.first = {"ml": ml, "am": am}, first
        self.calls = {name: [] for name, _, _ in FRONTIER_WRAPPERS}

    def __enter__(self):
        self.saved = []
        for name, mod, attr in FRONTIER_WRAPPERS:
            module = self.mods[mod]
            fn = getattr(module, attr)
            kept = self.calls[name]

            def wrapped(*args, _fn=fn, _kept=kept, **kwargs):
                if len(_kept) < self.first:
                    copy_ = lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t
                    _kept.append(([copy_(a) for a in args],
                                  {k: copy_(v) for k, v in kwargs.items()}))
                return _fn(*args, **kwargs)

            # the wrapper body counts its launch under its module's name: here
            wrapped.launches = fn.launches
            self.saved.append((module, attr, fn))
            setattr(module, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for module, attr, fn in self.saved:
            setattr(module, attr, fn)


def level3_plain_blocked(ml, x):
    """``motif_level3_plain`` of x, row block by row block (the float64
    reference at N = 2048 would otherwise hold several [4,N,N,h] tensors)."""
    adj, phi, a_i = x[0], x[1], x[2]
    n = adj.shape[1]
    return torch.cat([ml._level3_rows(adj, adj[:, s:s + FRONTIER_PLAIN_ROWS],
                                      phi[:, s:s + FRONTIER_PLAIN_ROWS],
                                      a_i[:, s:s + FRONTIER_PLAIN_ROWS], *x[3:])
                      for s in range(0, n, FRONTIER_PLAIN_ROWS)], dim=1)


def frontier_k1(ml, args, kwargs, dt) -> dict:
    x = [t for t in args if isinstance(t, torch.Tensor)]
    row0 = ([0] + [t for t in args if isinstance(t, int)])[-1]
    check(row0 == 0 and x[1].shape[1] == x[0].shape[1],
          f"frontier motif_level3: a window from row {row0}, expected every row")
    N, R, h = x[0].shape[1], x[1].shape[-1], x[2].shape[-1]
    kern = lambda: ml.fused_motif_level3(*x)
    got, again = kern(), kern()
    check(torch.equal(got, again), f"frontier motif_level3 {list(x[2].shape)}: two calls differ")
    extra = {}
    if dt == torch.float32:
        err, extra["plain_f32_err_vs_f64"] = compare_f64_bound(
            got, x, 2 * N + 2 * R + 2, lambda *t: level3_plain_blocked(ml, t))
    else:
        err = compare(got, level3_plain_blocked(ml, x), dt)
    b_ms, b_by = level3_bound(x, dt)
    return dict(shape=list(x[1].shape[:3]) + [h], max_abs_err=err, ms=device_ms(kern),
                plain_ms=device_ms(lambda: ml.motif_level3_plain(*x), reps=FRONTIER_PLAIN_REPS),
                bound_ms=b_ms, bound_by=b_by, library_ms=None, **extra)


def finite_grad(g: torch.Tensor) -> tuple:
    """A backward's captured gradient, or where it holds a non-finite value
    (a step whose loss is not finite: bf16 at N = 2048) one drawn from a
    seed in its shape and dtype, so that the kernel is held on the
    step's other inputs; with which it is."""
    if bool(torch.isfinite(g).all()):
        return g, "step"
    gen = torch.Generator(device="cuda").manual_seed(0)
    return torch.randn(g.shape, generator=gen, device="cuda").to(g.dtype), "seeded"


def frontier_k2(ml, args, kwargs, dt) -> dict:
    (g, grad_from), x = finite_grad(args[0]), args[1:]
    needs, row0 = kwargs.get("needs", MODEL_NEEDS), kwargs.get("row0", 0)
    check(tuple(needs) == MODEL_NEEDS and row0 == 0,
          f"frontier motif_level3_backward: asked {needs} at row {row0}, expected the "
          "model's gradients of every row")
    B, n, N, R = x[1].shape
    h = x[2].shape[-1]
    kern = lambda: ml.fused_motif_level3_backward(g, *x, needs=needs)
    got, again = kern(), kern()
    check(all(a is None or torch.equal(a, c) for a, c in zip(got, again)),
          f"frontier motif_level3_backward {[B, N, h]}: two calls differ")
    blocked = lambda gg, xx: ml.motif_level3_backward_plain(gg, *xx, needs=needs,
                                                            block_rows=FRONTIER_PLAIN_ROWS)
    errs = {}
    if dt == torch.float32:
        x64, g64 = [t.double() for t in x], g.double()
        want = blocked(g64, x64)
        mag = blocked(g64.abs(), [t.abs() for t in x64])
        for name, k, w, mg in zip(GRAD_NAMES, got, want, mag):
            if w is None:
                continue
            lim = (grad_terms(name, B, n, N, R, h) + 8) * 2.0 ** -24 * mg
            err = (k.double() - w).abs()
            check(bool((err <= lim).all()), f"frontier motif_level3_backward {[B, N, h]} {name}:"
                  f" f32 error {err.max().item()} beyond the summation bound")
            errs[name] = err.max().item()
    else:
        want = blocked(g.float(), [t.float() for t in x])
        for name, k, w in zip(GRAD_NAMES, got, want):
            if w is not None:
                errs[name] = compare(k, w.to(dt), dt)
    plan = ml.motif_level3_backward_plan(B, N, n, R, h, needs)
    b = level3_backward_bound(x[0], R, h, needs, dt)
    return dict(shape=[B, N, N, h], needs=[k for k, nd in zip(GRAD_NAMES, needs) if nd],
                grad=grad_from, errors=errs, max_abs_err=max(errs.values()),
                plan={"tiles": plan.tiles, "clusters": plan.clusters, "cluster": plan.cluster,
                      "h_chunk": plan.h_chunk, "counters": plan.counters,
                      "scratch": plan.scratch, "kernels": plan.kernels},
                ms=device_ms(kern),
                plain_ms=device_ms(lambda: ml.motif_level3_backward_plain(g, *x, needs=needs),
                                   reps=FRONTIER_PLAIN_REPS),
                bound_ms=b["bound_ms"], bound_by=b["bound_by"], library_ms=None)


def frontier_k3(am, args, kwargs, dt) -> dict:
    a, x, leak, w = (list(args) + [None, None])[:4]
    leak, w = kwargs.get("leak", leak), kwargs.get("w", w)
    b, n, m = a.shape
    f, h = x.shape[-1], w.shape[1]
    kern = lambda: am.blocked_adj_matmul(a, x, leak, w)
    got, again = kern(), kern()
    check(torch.equal(got, again), f"frontier adj_matmul {list(a.shape)}: two calls differ")
    if dt == torch.float32:
        err, p32 = compare_f64_bound(got, [a, x, w], m + f,
                                     lambda aa, xx, ww: am.adj_matmul_plain(aa, xx, leak, ww))
    else:
        err, p32 = compare(got, am.adj_matmul_plain(a, x, leak, w), dt), None
    isz = a.element_size()
    b_ms, b_by = bound(isz * (b * n * m + b * m * f + f * h + b * n * h),
                       2 * b * n * m * h + 2 * b * m * f * h + 2 * b * n * h, dt)
    aligned = all(t.data_ptr() % 16 == 0 for t in (a, x))
    plan = am.adj_matmul_plan(b, n, m, h, f, dt, aligned,
                              am.cluster_capacity(torch.device("cuda")))
    lib = lambda: torch.nn.functional.leaky_relu(torch.bmm(a, torch.matmul(x, w)), leak)
    return dict(shape=[list(a.shape), list(x.shape), list(w.shape)], max_abs_err=err,
                plain_f32_err_vs_f64=p32,
                plan={"variant": plan.variant, "split": plan.split, "blocks": plan.blocks,
                      "smem": plan.smem, "fuse_w": plan.fuse_w, "tma_a": plan.tma_a,
                      "tma_x": plan.tma_x},
                ms=device_ms(kern),
                plain_ms=device_ms(lambda: am.adj_matmul_plain(a, x, leak, w)),
                bound_ms=b_ms, bound_by=b_by, library_ms=device_ms(lib))


def frontier_k3b(am, args, kwargs, dt) -> dict:
    g, a, x, out, leak, w, needs = args
    g, grad_from = finite_grad(g)
    b, n, m = a.shape
    f, h = x.shape[-1], w.shape[1]
    kern = lambda: am.fused_adj_matmul_backward(g, a, x, out, leak, w, needs)
    got, again = kern(), kern()
    check(all(u is None or torch.equal(u, v) for u, v in zip(got, again)),
          f"frontier adj_matmul_backward {list(a.shape)} {needs}: two calls differ")
    want = am.adj_matmul_backward_plain(g, a, x, out, leak, w, needs)
    errs = {}
    for k, name in enumerate(("adj", "x", "w")):
        if want[k] is None:
            check(got[k] is None, f"frontier adj_matmul_backward: {name} not asked")
            continue
        if dt == torch.float32:
            fn = (lambda gg, aa, xx, oo, ww, k=k: am.adj_matmul_backward_plain(
                gg, aa, xx, oo, leak, ww, needs)[k])
            errs[name], _ = compare_f64_bound(got[k], [g, a, x, out, w],
                                              adj_backward_terms(k, b, n, m, f, h), fn)
        else:
            errs[name] = compare(got[k], want[k], dt)
    aligned = all(t.data_ptr() % 16 == 0 for t in (a, g, out))
    plan = am.adj_matmul_backward_plan(b, n, m, h, f, dt, needs, aligned,
                                       am.backward_cluster_capacity(torch.device("cuda")))
    b_ms, b_by = adj_backward_bound(a, x, w, leak, needs, dt)
    gy = am.lrelu_grad(g, out, leak).contiguous()
    return dict(shape=[list(a.shape), list(x.shape), list(w.shape)],
                needs=[nm for nm, nd in zip(("adj", "x", "w"), needs) if nd], grad=grad_from,
                errors=errs,
                max_abs_err=max(errs.values()),
                plan={"variant": plan.variant, "fuse_w": plan.fuse_w, "split": plan.split,
                      "grid": plan.grid, "blocks": plan.blocks, "smem": plan.smem,
                      "tma_a": plan.tma_a, "tma_g": plan.tma_g, "parts": plan.parts,
                      "kernels": plan.kernels},
                ms=device_ms(kern),
                plain_ms=device_ms(lambda: am.adj_matmul_backward_plain(
                    g, a, x, out, leak, w, needs)),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=device_ms(lambda: library_adj_backward(a, x, w, gy, needs,
                                                                  plan.fuse_w)))


def frontier_kernels(ml, am, calls, path, dt) -> list:
    """(d), (e): every call that one train step made of the four wrappers,
    held against its plain version on the card (f32 within the float64
    summation bound, bf16 within 2e-2 of the largest magnitude, two calls
    bit-equal), with the plan that ran, its median device ms over 100
    launches, the plain version's ms, the bound and the library's ms."""
    hold = {"motif_level3": lambda a, k: frontier_k1(ml, a, k, dt),
            "motif_level3_backward": lambda a, k: frontier_k2(ml, a, k, dt),
            "adj_matmul": lambda a, k: frontier_k3(am, a, k, dt),
            "adj_matmul_backward": lambda a, k: frontier_k3b(am, a, k, dt)}
    to_card = lambda t: t.cuda() if isinstance(t, torch.Tensor) else t
    rows = []
    for name, kept in calls.items():
        for i, (args, kwargs) in enumerate(kept):
            row = hold[name]([to_card(a) for a in args],
                             {k: to_card(v) for k, v in kwargs.items()})
            rows.append(dict(kernel=name, path=path, call=i, dtype=str(dt)[6:], served=False,
                             batch_shape=False, two_calls_bit_equal=True,
                             launches_per_step=1) | row)
            torch.cuda.empty_cache()
    return rows


def nonfinite_site(state, batch, dtype) -> dict:
    """(c): where the first non-finite value of train step 1 arises on the
    card: the first module (in the order their forwards return) whose
    output holds one, in the step's forward (ε drawn from ``state``'s
    generator as the step draws it), else the first of the posterior's
    statistics, the latents, the decoded heads and the loss's terms that
    holds one; with the largest magnitude of each statistic."""
    from snd_vae_tpu_torch import train as tt
    from snd_vae_tpu_torch.losses import elbo_loss

    found = []

    def hook(name):
        def fn(mod, inputs, output):
            outs = [t for t in torch.utils._pytree.tree_leaves(output)
                    if isinstance(t, torch.Tensor) and t.is_floating_point()]
            if not found and any(not bool(torch.isfinite(t).all()) for t in outs):
                found.append(f"module {name} ({type(mod).__name__})")
        return fn

    model = state.model
    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules() if n]
    try:
        with torch.no_grad():
            out = tt._forward(state, batch, None)
            _, aux = elbo_loss(state.cfg, out, batch.adj, batch.features, batch.coords,
                               torch.zeros((), device=batch.adj.device))
    finally:
        for h in handles:
            h.remove()
    stats = {f: getattr(out.stats, f) for f in ("mean_sg", "logstd_sg", "mean_s", "logstd_s",
                                                "mean_g", "logstd_g")}
    tensors = ([(f"stats.{k}", v) for k, v in stats.items()]
               + [(f"latents.{k}", getattr(out.latents, k)) for k in ("z_sg", "z_s", "z_g")]
               + [(f"decoded.{k}", getattr(out.decoded, k))
                  for k in ("adj_prob", "coords", "node_feat")]
               + [(f"loss.{k}", v) for k, v in aux.items()])
    if not found:
        found += [name for name, t in tensors if not bool(torch.isfinite(t.float()).all())][:1]
    return {"first": found[0] if found else None,
            "nonfinite_loss_terms": [k for k, v in aux.items()
                                     if not bool(torch.isfinite(v).all())],
            "stats_max_abs": {k: v.float().abs().max().item() for k, v in stats.items()}}


def cpu_graph_kl(cfg, batch, dtype) -> dict:
    """(c) on the CPU: the topology branch's posterior (μ, log σ) of the
    same seed weights and batch in ``dtype`` (the first lines of the
    model's ``encode``; K3's plain version) and the graph KL from them.
    The KL terms enter the loss as a sum, so a graph KL that is not finite
    makes the loss not finite whatever the rest gives; the other branches,
    which (c) does not read, are left out."""
    from torch.nn.utils.stateless import _reparametrize_module

    from snd_vae_tpu_torch.losses import kl_diag_gaussian
    from snd_vae_tpu_torch.models import build_model

    model = build_model(cfg.with_(compute_dtype="float32"), device="cpu")
    params = {n: p.to(dtype) for n, p in model.named_parameters()}
    b = batch.to("cpu", dtype)
    with torch.no_grad(), _reparametrize_module(model, params):
        g = b.features
        for conv, bn in zip(model.g_convs, model.g_bns):
            g = torch.cat([bn(conv(b.adj, g)), b.features], dim=-1)
        hidden = model.g_lin1(model.encoder_g_bn(g).reshape(b.batch_size, -1))
        mean, logstd = model.g_lin_mean(hidden), model.g_lin_std(hidden)
    kl = kl_diag_gaussian(mean.float(), logstd.float()).item()
    return {"graph_kl": kl, "finite": math.isfinite(kl),
            "stats_max_abs": {"mean_g": mean.float().abs().max().item(),
                              "logstd_g": logstd.float().abs().max().item()}}


def same_terms(a: dict, b: dict) -> tuple:
    """Whether two steps' loss terms agree: each at rtol 1e-6, one that is
    not finite (the init's graph KL at N = 2048, see (c)) the same in
    both; with the largest relative difference of the finite ones."""
    same = a.keys() == b.keys() and all(
        abs(a[k] - b[k]) <= 1e-6 * abs(b[k]) if math.isfinite(b[k]) else str(a[k]) == str(b[k])
        for k in a)
    rel = max((abs(a[k] - b[k]) / abs(b[k]) for k in a if math.isfinite(b[k]) and b[k]),
              default=0.0)
    return same, rel


def frontier_first_step(ml, mc, am, data, n, dt_name) -> tuple:
    """The first train step of the frontier config without remat from the
    seed weights (a Trainer's: its first batch and ε), counted (2 launches
    of each kernel), with its loss terms, wall ms and peak of allocated
    memory, and the arguments of each kernel wrapper's calls
    (``capture_calls``: copied to the host, which the ms includes).  Where
    its loss is not finite, (c): where the first non-finite value arises
    in this step's forward on the card (a Trainer from the same seed), and
    the CPU's graph KL on the same weights and batch; the check fails
    unless N is ``FRONTIER_NONFINITE_N``, the graph KL is the card's one
    non-finite term of the loss and the CPU's is not finite either.
    Returns (its line, the calls)."""
    import tempfile

    from snd_vae_tpu_torch import train as tt

    cfg = frontier_config(n, dt_name)
    dt = getattr(torch, dt_name)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as workdir:
        trainer = tt.Trainer(cfg, data, device="cuda", workdir=workdir)
        with capture_calls(ml, am) as cap:
            zero_counts(ml, mc, am)
            t0 = time.perf_counter()
            aux = tt.train_step(trainer.state, trainer.batched._map(lambda t: t[0]),
                                torch.zeros((), device="cuda"))
            first = {k: v.item() for k, v in aux.items()}
            ms = (time.perf_counter() - t0) * 1e3
            launches = read_counts(ml, mc, am)
        check(launches == per(1, ml3=2, k3=2, bwd=2, k3b=2),
              f"frontier N={n} {dt_name} first step: launches {launches}")
        res = {"N": n, "dtype": dt_name, "remat": False, "launches": launches,
               "first_step_aux": first, "first_step_ms": ms,
               "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
        del trainer, aux
        if not math.isfinite(first["loss"]):
            fresh = tt.Trainer(cfg, data, device="cuda", workdir=workdir)
            batch = data.slice_batch(0, cfg.train.batch_size)
            res["nonfinite"] = {"card": nonfinite_site(fresh.state, batch, dt)}
            del fresh
            torch.cuda.empty_cache()
            cpu = cpu_graph_kl(cfg, batch, dt)
            res["nonfinite"]["cpu"] = cpu
            terms = set(res["nonfinite"]["card"]["nonfinite_loss_terms"]) - {"loss"}
            check(n == FRONTIER_NONFINITE_N and terms == {"graph_kl"} and not cpu["finite"],
                  f"frontier N={n} {dt_name}: the card's loss is not finite "
                  f"({res['nonfinite']['card']}) where the CPU's graph KL is {cpu['graph_kl']}")
    torch.cuda.empty_cache()
    return res, cap.calls


def frontier_train(ml, mc, am, data, n, dt_name, remat, block_rows, epochs) -> dict:
    """(b): Trainer.run of the frontier config for ``epochs`` on ``data``
    (B = 2 graphs a step), counted (2 launches a step of each kernel;
    motif_level3 4 with remat; K3's plain version never), with the per-step
    losses, the peak of allocated memory and a profile of the last epoch:
    ms per step, device-busy ms and kernels per step.  The first step of
    the variant (``frontier_first_step``) has warmed the card up; at N =
    2048 the run is one step from the seed weights.  The losses are finite
    (but at ``FRONTIER_NONFINITE_N``, where the first step's passed (c)),
    and over two epochs f32's epoch mean falls."""
    import tempfile

    from snd_vae_tpu_torch import train as tt

    cfg = frontier_config(n, dt_name, remat, block_rows)
    B = cfg.train.batch_size
    per_epoch = data.adj.shape[0] // B
    steps = epochs * per_epoch
    res = {"N": n, "dtype": dt_name, "remat": remat, "motif_block_rows": block_rows,
           "batch": [B, cfg.sampling_num, n], "adj_head_factored": cfg.adj_factored_engaged,
           "epochs": epochs, "steps": steps}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as workdir:
        trainer = tt.Trainer(cfg, data, device="cuda", workdir=workdir)
        losses, first, run_epoch = [], {}, trainer.run_epoch

        def epoch_profiled(epoch):
            # the last epoch runs under the profiler: its wall and device time
            if epoch == epochs - 1:
                kept = []
                res["profile"] = profile_steps(lambda _: kept.append(run_epoch(epoch)), [None],
                                               steps=per_epoch)
                storer = kept[0]
            else:
                storer = run_epoch(epoch)
            losses.extend(storer["loss"])
            if not first:
                first.update({k: v[0] for k, v in storer.items()})
            return storer

        trainer.run_epoch = epoch_profiled
        zero_counts(ml, mc, am)
        t0 = time.perf_counter()
        trainer.run(epochs, verbose=False, per_step=True)
        res["run_s"] = time.perf_counter() - t0
        launches = read_counts(ml, mc, am)
        res["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
        del trainer
    check(launches == per(steps, ml3=4 if remat else 2, k3=2, bwd=2, k3b=2),
          f"frontier N={n} {dt_name} remat={remat}: launches {launches} over {steps} steps")
    means = [statistics.mean(losses[e * per_epoch:(e + 1) * per_epoch]) for e in range(epochs)]
    finite = all(math.isfinite(v) for v in losses)
    check(finite or n == FRONTIER_NONFINITE_N,
          f"frontier N={n} {dt_name}: losses {losses} not all finite")
    if dt_name == "float32" and epochs > 1:
        check(means[1] < means[0], f"frontier N={n} f32: loss did not fall: {means}")
    prof = res.pop("profile")
    res.update(launches=launches, launches_per_step={k: v / steps for k, v in launches.items()},
               step_losses=losses, first_step_aux=first, epoch_mean_loss=means,
               losses_finite=finite, ms_per_step=prof["wall_ms_per_step"],
               profiled_steps=per_epoch,
               profile={k: prof[k] for k in (
                   "device_busy_ms_per_step", "device_busy_share", "kernels_per_step",
                   "device_ms_per_step_by_range", "level3_backward_ms_per_step",
                   "adj_matmul_backward_ms_per_step", "top_backward_kernels")})
    torch.cuda.empty_cache()
    return res


def frontier_serve(ml, mc, am, n: int) -> dict:
    """(f): serve.reconstruct of one batch (2 graphs x 2 trees) and
    serve.sample of 2 graphs at N, f32, from the seed weights: launches (2
    of motif_level3 and 2 of adj_matmul a batch, none to sample), finite
    outputs of the expected shapes, the peak memory and the wall ms of the
    one call (the f32 steps at N have run these shapes before)."""
    from snd_vae_tpu_torch.data.loaders import load_dataset
    from snd_vae_tpu_torch.models import build_model
    from snd_vae_tpu_torch.serve import reconstruct, sample

    cfg = frontier_config(n)
    B = cfg.train.batch_size
    torch.cuda.empty_cache()
    batch = load_dataset(cfg, "test", num_graphs=B, device="cuda")
    model = build_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(cfg.train.seed)
    res = {"N": n, "dtype": "float32", "batch": [B, cfg.sampling_num, n]}
    for name, fn, want in (
            ("reconstruct", lambda: reconstruct(model, batch), per(1, ml3=2, k3=2)),
            ("sample", lambda: sample(model, B, gen), per(0))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(ml, mc, am)
        t0 = time.perf_counter()
        out = fn()
        launches = read_counts(ml, mc, am)
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        check(launches == want, f"frontier serve {name}: launches {launches}, expected {want}")
        d = out.decoded if name == "reconstruct" else out
        check(d.adj_prob.shape == (B, n, n, 2) and d.coords.shape == (B, n, 2)
              and d.node_feat.shape == (B, n, 1), f"frontier serve {name}: shapes")
        check(all(bool(torch.isfinite(t).all()) for t in (d.adj_prob, d.coords, d.node_feat)),
              f"frontier serve {name}: outputs not finite")
        res[name] = {"launches": launches, "ms": ms, "peak_allocated_bytes": peak}
    return res


def frontier_vs_cpu(n: int) -> dict:
    """(a): one f32 train step at N on the card against the same step on
    the CPU from the same seed weights (``card_vs_cpu_step``: phase 5's
    tolerances), and one reconstructed batch against the CPU's."""
    from snd_vae_tpu_torch.data.loaders import load_dataset
    from snd_vae_tpu_torch.models import build_model
    from snd_vae_tpu_torch.serve import reconstruct

    cfg = frontier_config(n)
    batch = load_dataset(cfg, "train", num_graphs=cfg.train.batch_size, device="cuda")
    t0 = time.perf_counter()
    step = card_vs_cpu_step(cfg, batch)
    model, cpu = build_model(cfg, device="cuda"), build_model(cfg, device="cpu")
    recon = held_to_cpu(reconstruct(model, batch), reconstruct(cpu, batch.to("cpu")), False)
    return {"N": n, "step_max_abs_err": step, "reconstruct_max_abs_err": recon,
            "seconds": time.perf_counter() - t0}


def run_frontier(ml, mc, am) -> tuple:
    """The frontier phase, (a)-(g) (see the module docstring).  Returns its
    line and its kernel rows."""
    from snd_vae_tpu_torch.data.loaders import load_dataset

    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    out = {"vs_cpu": frontier_vs_cpu(FRONTIER_CPU_NODES)}
    emit("frontier_vs_cpu", out["vs_cpu"])
    firsts, train, rows, loaded = [], [], [], {}
    for n, dt_name, remat, block_rows, graphs, epochs in FRONTIER_VARIANTS:
        if (n, graphs) not in loaded:
            loaded.clear()
            torch.cuda.empty_cache()
            t = time.perf_counter()
            loaded[n, graphs] = load_dataset(frontier_config(n), "train", num_graphs=graphs,
                                             device="cuda")
            emit("frontier_data", {"N": n, "graphs": graphs, "load_s": time.perf_counter() - t})
        data = loaded[n, graphs]
        first, calls = frontier_first_step(ml, mc, am, data, n, dt_name)
        emit("frontier_first_step", first | {"phase_s": time.perf_counter() - t0})
        kernel_rows = frontier_kernels(ml, am, calls, f"frontier_{n}", getattr(torch, dt_name))
        del calls
        for r in kernel_rows:
            emit("kernel", r)
        rows += kernel_rows
        emit("frontier_kernels_held", {"N": n, "dtype": dt_name,
                                       "phase_s": time.perf_counter() - t0})
        res = frontier_train(ml, mc, am, data, n, dt_name, remat, block_rows, epochs)
        # the run's first step against the first step without remat: with
        # remat this is (g); without, the same step again
        same, rel = same_terms(res["first_step_aux"], first["first_step_aux"])
        res["first_step_vs_first"] = {"same": same, "max_rel_diff": rel}
        if remat:
            check(same, f"frontier remat N={n}: first-step loss terms "
                        f"{res['first_step_aux']} against {first['first_step_aux']} without")
            out["remat_vs_none"] = {
                "N": n, "dtype": dt_name, "max_rel_diff": rel,
                "first_step_aux": {k: [v, first["first_step_aux"][k]]
                                   for k, v in res["first_step_aux"].items()},
                "peak_allocated_bytes": [res["peak_allocated_bytes"],
                                         first["peak_allocated_bytes"]]}
        emit("frontier_train", res | {"phase_s": time.perf_counter() - t0})
        firsts.append(first)
        train.append(res)
    del data
    loaded.clear()
    torch.cuda.empty_cache()
    out["first_steps"], out["train"] = firsts, train
    out["serve"] = frontier_serve(ml, mc, am, 2048)
    emit("frontier_serve", out["serve"])
    out["seconds"] = time.perf_counter() - t0
    emit("frontier", {k: v for k, v in out.items() if k in ("remat_vs_none", "seconds")})
    return out, rows


def kernel_entry(name, source, replaces, tpu_fn, rows, launches_by_path):
    """One kernel's line: its times summed over the shapes one served batch
    of the disentangled model (or one train step's forward: the same
    shapes) launches it at (f32).  A kernel off that path has no such rows;
    its line sums the rows at the shapes the served layers would give it.
    ``rows_by_path`` sums the rows of the joint model's and scene's shapes
    the same way, per dtype."""
    mine = [r for r in rows if r["kernel"] == name]
    served = [r for r in mine if r["served"]]
    picked = served or [r for r in mine if r["batch_shape"]]

    def total(rs, key):
        return (None if not rs or any(r.get(key) is None for r in rs)
                else sum(r[key] for r in rs))

    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "tpu_function": tpu_fn, "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path, "on_main_path": bool(served),
        "max_abs_err": max((r["max_abs_err"] for r in picked), default=None),
        "ms": total(picked, "ms"), "plain_ms": total(picked, "plain_ms"),
        "bound_ms": total(picked, "bound_ms"),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in picked)
                     else "operations"),
        "library_ms": total(picked, "library_ms"),
        "per_batch_shapes": [r["shape"] for r in picked],
    }
    if any("replaced_ms" in r for r in picked):
        entry["replaced_ms"] = total(picked, "replaced_ms")
    by_path = {}
    for r in mine:
        if r.get("path"):
            by_path.setdefault(f"{r['path']}_{r['dtype']}", []).append(r)
    if by_path:
        entry["rows_by_path"] = {
            key: {"shapes": [r["shape"] for r in rs], "ms": total(rs, "ms"),
                  "plain_ms": total(rs, "plain_ms"), "bound_ms": total(rs, "bound_ms"),
                  "max_abs_err": max(r["max_abs_err"] for r in rs)}
            for key, rs in by_path.items()}
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from snd_vae_tpu_torch.nn.kernels import adj_matmul as am
    from snd_vae_tpu_torch.nn.kernels import build
    from snd_vae_tpu_torch.nn.kernels import motif_combine as mc
    from snd_vae_tpu_torch.nn.kernels import motif_level3 as ml

    count_plain_calls(am)
    # f32 products and convolutions in full f32, for the comparisons (the
    # serve phase also holds the serving entry points to clearing TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit("device", {"nvidia_smi": smi, "torch": torch.__version__,
                    "cuda": torch.version.cuda,
                    "capability": list(torch.cuda.get_device_capability(0))})

    # 2. build, every kernel from the sources in this checkout
    t0 = time.perf_counter()
    secs = build.build()
    ptxas = {k: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln] for k, log in build.build_log.items()}
    emit("build", {"seconds": secs, "wall_s": time.perf_counter() - t0, "ptxas": ptxas})

    # 2b. the native data-path library, which every loader below samples with
    emit("native", run_native())

    # 3. kernels against their plain versions, beside the timing floor: a
    # one-element fill_ timed as the kernels are
    one = torch.ones(1, device="cuda")
    emit("timing_floor", {"fill_ms": device_ms(lambda: one.fill_(1.0))})
    rows = check_kernels(ml, mc, am)
    for r in rows:
        emit("kernel", r)

    # 4. the served path
    from snd_vae_tpu_torch.config import synthetic2_preset

    # the dataset path lies inside this checkout, which commits no data
    # files: the splits are generated from the seed
    s2 = synthetic2_preset(dataset_path=str(ROOT / "dataset"))
    serving = serve_phase(ml, mc, am, s2, {"ml3": 2, "k3": 2})
    emit("serve", serving)

    # 5. the training path, and 5b. its default dispatch: CUDA-graph replays
    training = run_training(ml, mc, am)
    emit("train", training)
    graphs = run_graphs(ml, mc, am)
    emit("graphs", graphs)

    # 6.-10. the joint model, scene, the geoGCN / posGCN encoders and the
    # separable adjacency head
    joint_serving = serve_phase(ml, mc, am, s2.with_(model_type="base"), {"ml3": 2})
    emit("joint_serve", joint_serving)
    joint_training = run_joint_training(ml, mc, am)
    emit("joint_train", joint_training)
    scene = run_scene(ml, mc, am)
    emit("scene", scene)
    baselines = {mt: serve_phase(ml, mc, am, s2.with_(model_type=mt), {"k3": 2},
                                 dtypes=("float32",), n_batches=1, sample_graphs=SAMPLE_GRAPHS,
                                 num_graphs=s2.train.batch_size, timed=False)
                 for mt in ("geoGCN", "posGCN")}
    emit("baselines", baselines)
    separable = run_separable(ml, mc, am)
    emit("separable", separable)

    # 11.-13. the fourth-order conv: protein (disentangled), the blocked
    # lowerings, the joint model on protein, mnist
    from snd_vae_tpu_torch.config import mnist_preset, protein_preset

    protein = run_protein(ml, mc, am)
    level4_rows = protein.pop("level4")
    emit("protein", protein)
    for r in level4_rows:
        emit("kernel", r)
    rows += level4_rows
    blocked = run_blocked(ml, mc, am)
    emit("protein_blocked", blocked)
    protein_joint = run_3d_short(
        ml, mc, am, protein_preset(model_type="base", dataset_path=str(ROOT / "dataset")),
        {"k4": 2})
    emit("protein_joint", protein_joint)
    mnist = run_3d_short(ml, mc, am, mnist_preset(dataset_path=str(ROOT / "dataset")),
                         {"k3": 2, "k4": 2})
    emit("mnist", mnist)

    # 14.-16b. held-out evaluation, rematerialization, the evaluation CLI
    # with its figures, and the CLI's --profile
    evaluation = run_eval(ml, mc, am)
    emit("eval", evaluation)
    remat = run_remat(ml, mc, am)
    emit("remat", remat)
    emit("cli_eval", run_cli_eval())
    cli_profile = run_cli_profile(
        statistics.median(graphs["synthetic2_f32"]["timed"]["graph"]["epoch_s"]))
    emit("cli_profile", cli_profile)
    trace_twice = run_trace_twice(ml, mc, am)
    emit("trace_twice", trace_twice)
    check_trace_twice(trace_twice)

    # 17.-19. the parallel layer: the large-graph encoder and the
    # data-parallel Trainer in an NCCL process group of one, then the CLI
    # under torchrun
    import tempfile

    import torch.distributed as dist

    from snd_vae_tpu_torch.parallel import initialize_distributed, make_mesh

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as rendezvous:
        initialize_distributed(f"file://{rendezvous}/rendezvous", 1, 0, device="cuda")
        try:
            mesh = make_mesh(1, 1)
            large_graph = run_large_graph(am, mesh)
            emit("large_graph", large_graph)
            dp = run_dp(ml, mc, am, mesh)
            emit("dp", dp)
            tp = run_tp(ml, mc, am, mesh)
            rows += tp["windows"]["rows"]
            emit("tp", {k: v for k, v in tp.items() if k != "windows"}
                 | {"windows_joined": tp["windows"]["joined"]})
            for r in tp["windows"]["rows"]:
                emit("kernel", r)
        finally:
            dist.destroy_process_group()
    emit("cli_dp", run_cli_dp())

    # 19b. the frontier: the JAX package's single-chip frontier configuration
    frontier, frontier_rows = run_frontier(ml, mc, am)
    rows += frontier_rows

    # 20. launches per path (the f32 runs, each counted from 0), the kernels
    # line; 21. the result line (the card's line just before)
    by_path = {"serve": serving["float32"]["launches"],
               "train": training["float32"]["launches"],
               # the default dispatch: the wrappers run at the eager first
               # step and at the capture; replays launch without them
               "graphs_train": graphs["synthetic2_f32"]["launches"]["graph"],
               "joint_serve": joint_serving["float32"]["launches"],
               "joint_train": joint_training["launches"],
               "scene_serve": scene["serve"]["float32"]["launches"],
               "scene_train": scene["train"]["launches"],
               "geoGCN_serve": baselines["geoGCN"]["float32"]["launches"],
               "posGCN_serve": baselines["posGCN"]["float32"]["launches"],
               "separable_serve": separable["serve"]["float32"]["launches"],
               "protein_serve": protein["serve"]["float32"]["launches"],
               "protein_train": protein["train"]["float32"]["launches"],
               "protein_blocked": blocked["synthetic2_conv_layer2"]["block_5"]["launches"],
               "protein_joint_serve": protein_joint["serve"]["float32"]["launches"],
               "protein_joint_train": protein_joint["train"]["launches"],
               "mnist_serve": mnist["serve"]["float32"]["launches"],
               "mnist_train": mnist["train"]["launches"],
               "eval_train": evaluation["launches"],
               "eval_heldout": evaluation["per_eval_launches"],
               "remat_train": remat["synthetic2"]["remat"]["launches"],
               "remat_joint_train": remat["synthetic2_joint"]["remat"]["launches"],
               "remat_protein_train": remat["protein"]["remat"]["launches"],
               "large_graph": {"motif_level3": 0, "motif_level3_backward": 0,
                               "motif_combine": 0, "adj_matmul": large_graph["launches"],
                               "adj_matmul_backward": large_graph["backward_launches"],
                               "motif_level4": 0, "motif_level4_backward": 0},
               "dp_train": dp["mesh"]["launches"],
               "tp_train": tp["tp"]["launches"],
               # the default dispatch on the mesh: the eager step and the
               # capture; its replays' records read 2 each (dp, tp lines)
               "dp_graphs_train": dp["mesh_graphs"]["launches"],
               "tp_graphs_train": tp["mesh_graphs"]["launches"],
               "profile_train": {k: v // (BACKWARD_KERNELS if k == "motif_level3_backward"
                                          else 1)
                                 for k, v in cli_profile["trace_kernel_events"].items()}}
    by_path |= {f"frontier_{r['N']}_{r['dtype']}_first_step": r["launches"]
                for r in frontier["first_steps"]}
    by_path |= {f"frontier_{r['N']}_{r['dtype']}{'_remat' if r['remat'] else ''}":
                r["launches"] for r in frontier["train"]}
    by_path["frontier_serve"] = {k: a + b for (k, a), b in zip(
        frontier["serve"]["reconstruct"]["launches"].items(),
        frontier["serve"]["sample"]["launches"].values())}
    emit("launches", by_path)
    emit("phase_seconds", PHASE_SECONDS | {"total": sum(PHASE_SECONDS.values())})
    entry = lambda name, source, tpu_fn, replaces: kernel_entry(
        name, source, replaces, tpu_fn, rows, {path: p[name] for path, p in by_path.items()})
    print(json.dumps({"kernels": [
        entry("motif_level3", L3_SOURCE, "fused_motif_combine", K1_REPLACES),
        entry("motif_level3_backward", L3B_SOURCE, "motif_combine (custom VJP, _motif_bwd)",
              K2_REPLACES),
        entry("motif_combine", K1_SOURCE, "fused_motif_combine", K1_REPLACES),
        entry("adj_matmul", K3_SOURCE, "blocked_adj_matmul", K3_REPLACES),
        entry("adj_matmul_backward", K3B_SOURCE, K3B_TPU_FN, K3_REPLACES)
        | {"replaced_in_port": K3B_REPLACED},
        entry("motif_level4", K4_SOURCE, K4_TPU_FN, K4_REPLACES),
        entry("motif_level4_backward", K4B_SOURCE, K4_TPU_FN, K4_REPLACES),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
