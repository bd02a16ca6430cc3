#!/usr/bin/env python3
"""Where the time of K3 (forward) and of K3's backward goes on one CUDA card.

    python3 benchmarks_torch/adj_matmul_ablation.py [--part forward|backward|both]

Builds ``csrc/adj_matmul.cu`` five more times, each with a phase compiled
out through the macros the source guards them with (SKIP_LOADS: the k-tile
copies; SKIP_MMA: the products; SKIP_REDUCE: the cluster's reduction in
distributed shared memory and the epilogue after it; SKIP_EPILOGUE: the
rounding, activation and store after the reduction; all four), and times
every build with ``chip_smoke.device_ms`` (median of 100 single launches
behind a device-side spin) at [2048,2048] @ [2048,128] in f32 (CUDA cores)
and bf16 (tensor cores, TMA), k split over a cluster as the plan picks, with and without
the leaky ReLU, beside ``torch.mm`` on the same inputs and the timing floor
(a one-element ``fill_`` timed the same way).  The full build is held
against the plain version first, and also timed with the k split over 1, 2,
4 and 8 blocks (the plan's choice among them).  A build with a phase
compiled out computes nothing meaningful; only its time is read.  First it
prints how many clusters of each size the card holds at once
(cudaOccupancyMaxActiveClusters) beside the plan's H100_CLUSTERS table.
The backward part builds ``csrc/adj_matmul_backward.cu`` seven more times
in the same way (SKIP_LOADS: the stages' copies; SKIP_GY: the gy pass;
SKIP_MMA: the products; SKIP_REDUCE: the cluster's exchange; SKIP_ELECTION:
the election and the last block's sum of gW; SKIP_LAST_SUM: that sum
alone; all of loads, gy, products, exchange and election) and times each at
[2048,2048] @ [2048,128] (∂x; f32 simt and bf16 tc, with and without the
leaky ReLU), at GraphConv 2 of synthetic2's widths at N = 1024 (B = 2, W
fused, ∂x and ∂W) and at the model's two GraphConvs of synthetic2 (the small
variant, one block a graph: where its election and last-block sum stand),
beside ``torch.matmul(A^T, gy)`` on a precomputed gy; the full build is
held against the closed form first, and at N = 2048 also timed with the sum
over i split over 1, 2, 4 and 8 blocks.  It first prints the backward's
cluster capacity beside H100_BWD_CLUSTERS.
Prints one JSON line per case and the card's name and power limit last.
Needs nvcc and a card.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from snd_vae_tpu_torch.nn.kernels import adj_matmul as am  # noqa: E402
from snd_vae_tpu_torch.nn.kernels import build  # noqa: E402

VARIANTS = {"full": [], "no_loads": ["SKIP_LOADS"], "no_mma": ["SKIP_MMA"],
            "no_reduce": ["SKIP_REDUCE"], "no_epilogue": ["SKIP_EPILOGUE"],
            "none": ["SKIP_LOADS", "SKIP_MMA", "SKIP_REDUCE"]}
CASES = ((torch.float32, None), (torch.float32, 0.2), (torch.bfloat16, None),
         (torch.bfloat16, 0.2))
N, H, DENSITY = 2048, 128, 0.05
BWD_VARIANTS = {"full": [], "no_loads": ["SKIP_LOADS"], "no_gy": ["SKIP_GY"],
                "no_mma": ["SKIP_MMA"], "no_reduce": ["SKIP_REDUCE"],
                "no_election": ["SKIP_ELECTION"], "no_last_sum": ["SKIP_LAST_SUM"],
                "none": ["SKIP_LOADS", "SKIP_GY", "SKIP_MMA", "SKIP_REDUCE", "SKIP_ELECTION"]}
# (A shape, x shape, W's columns or None, needs (∂A, ∂x, ∂W), density)
BWD_CASES = (((N, N), (N, H), None, (False, True, False), DENSITY),
             ((2, 1024, 1024), (2, 1024, 11), 20, (False, True, True), 0.01),
             ((10, 25, 25), (10, 25, 1), 10, (False, False, True), 0.15),
             ((10, 25, 25), (10, 25, 11), 20, (False, True, True), 0.15))


def build_variants(source: str = "adj_matmul", variants: dict = VARIANTS,
                   entry: str = "adj_matmul_launch", signatures: dict = am._SIGNATURES) -> dict:
    """Every variant of ``csrc/<source>.cu`` built at once; the launch
    function of each."""
    out_dir = build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / f"{source}.cu"
    procs = {name: subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, *(f"-D{m}" for m in macros),
         "-o", str(out_dir / f"lib{source}_{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, macros in variants.items()}
    fns = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(out_dir / f"lib{source}_{name}.so")), entry)
        fn.argtypes = list(signatures[entry])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launch(fn, a, x, leak, plan):
    out = torch.empty(a.shape[0], x.shape[-1], dtype=x.dtype, device=x.device)
    code = fn(*am.launch_args(a, x, None, out, leak, plan))
    if code != 0:
        raise RuntimeError(f"launch failed with cudaError {code}")
    return out


def backward_part() -> None:
    """The backward's phases (see the module docstring)."""
    fns = build_variants("adj_matmul_backward", BWD_VARIANTS, "adj_matmul_backward_launch",
                         am._BACKWARD_SIGNATURES)
    lib = ctypes.CDLL(str(build.BUILD_DIR / "ablation" / "libadj_matmul_backward_full.so"))
    lib.adj_matmul_backward_max_clusters.argtypes = [ctypes.c_int, ctypes.c_int,
                                                     ctypes.POINTER(ctypes.c_int)]
    held = {}
    for dtype, name in ((0, "simt"), (1, "tc")):
        held[name] = {}
        for split in (1, 2, 4, 8):
            count = ctypes.c_int(0)
            if lib.adj_matmul_backward_max_clusters(dtype, split, ctypes.byref(count)) != 0:
                raise RuntimeError("cudaOccupancyMaxActiveClusters failed")
            held[name][split] = count.value
        print(json.dumps({"backward_variant": name, "max_clusters": held[name],
                          "plan_table": am.H100_BWD_CLUSTERS[name]}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for a_shape, x_shape, hw, needs, density in BWD_CASES:
        for dt in (torch.float32, torch.bfloat16):
            for leak in ((0.2, None) if hw is None else (0.2,)):
                if hw is not None and a_shape[-1] <= 64 and dt == torch.bfloat16:
                    continue   # the small variant: f32 answers the question
                a, x = cs.adj_inputs(a_shape, x_shape, dt, gen, density)
                w = (None if hw is None else
                     (0.3 * torch.randn(x_shape[-1], hw, generator=gen, device="cuda")).to(dt))
                out = am.blocked_adj_matmul(a, x, leak, w)
                g = torch.randn(out.shape, generator=gen, device="cuda").to(dt)
                n, m = a_shape[-2:]
                b = a_shape[0] if len(a_shape) == 3 else 1
                f = None if w is None else x_shape[-1]
                plan = am.adj_matmul_backward_plan(b, n, m, out.shape[-1], f, dt, needs,
                                                   clusters=held)
                call = lambda fn, pl=plan: am.backward_call(fn, g, a, x, out, leak, w, needs, pl)
                got = call(fns["full"])
                want = am.adj_matmul_backward_plain(g, a, x, out, leak, w, needs)
                errs = []
                for k, (u, v) in enumerate(zip(got, want)):
                    if v is None or u is None:
                        continue
                    if dt == torch.float32:
                        errs.append(cs.compare_f64_bound(
                            u, [g, a, x] + ([] if leak is None else [out]) + (
                                [] if w is None else [w]),
                            cs.adj_backward_terms(k, b, n, m, f, out.shape[-1]),
                            lambda gg, aa, xx, *rest, k=k: am.adj_matmul_backward_plain(
                                gg, aa, xx, rest[0] if leak is not None else None, leak,
                                rest[-1] if w is not None else None, needs)[k])[0])
                    else:
                        errs.append(cs.compare(u, v, dt))
                ms = {name: cs.device_ms(lambda fn=fn: call(fn)) for name, fn in fns.items()}
                gy = (g if leak is None else am.lrelu_grad(g, out, leak)).contiguous()
                ms["torch_matmul_At_gy"] = cs.device_ms(lambda: torch.matmul(a.mT, gy))
                if plan.variant != "small" and hw is None:   # the full build at each split
                    for split in (1, 2, 4, 8):
                        if split > -(-n // plan.tile[2]):
                            continue
                        at = dataclasses.replace(
                            plan, split=split, grid=(split, *plan.grid[1:]),
                            i_slices=am.split_k(n, plan.tile[2], split))
                        ms[f"full_split{split}"] = cs.device_ms(lambda: call(fns["full"], at))
                print(json.dumps({"backward": True, "shape": [list(a_shape), list(x_shape)] + (
                    [] if w is None else [list(w.shape)]), "dtype": str(dt)[6:], "leak": leak,
                    "needs": needs, "variant": plan.variant, "split": plan.split,
                    "blocks": plan.blocks,
                    "tma_a": plan.tma_a, "tma_g": plan.tma_g, "max_abs_err": max(errs),
                    "ms": ms}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--part", choices=("forward", "backward", "both"), default="both")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("adj_matmul_ablation: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.part != "forward":
        backward_part()
    if args.part != "backward":
        forward_part()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


def forward_part() -> None:
    """The forward's phases (see the module docstring)."""
    fns = build_variants()
    lib = ctypes.CDLL(str(build.BUILD_DIR / "ablation" / "libadj_matmul_full.so"))
    lib.adj_matmul_max_clusters.argtypes = [ctypes.c_int, ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_int)]
    for dtype, name in ((0, "simt"), (1, "tc")):
        held = {}
        for split in (1, 2, 4, 8):
            count = ctypes.c_int(0)
            if lib.adj_matmul_max_clusters(dtype, split, ctypes.byref(count)) != 0:
                raise RuntimeError("cudaOccupancyMaxActiveClusters failed")
            held[split] = count.value
        plan = am.adj_matmul_plan(1, N, N, H, None, (torch.float32, torch.bfloat16)[dtype])
        print(json.dumps({"variant": name, "max_clusters": held,
                          "plan_table": am.H100_CLUSTERS[name], "smem": plan.smem}), flush=True)
    one = torch.ones(1, device="cuda")
    print(json.dumps({"floor": {"fill_ms": cs.device_ms(lambda: one.fill_(1.0))}}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dt, leak in CASES:
        a, x = cs.adj_inputs((N, N), (N, H), dt, gen, DENSITY)
        plan = am.adj_matmul_plan(1, N, N, H, None, dt)
        got = launch(fns["full"], a, x, leak, plan)
        if dt == torch.float32:
            err, _ = cs.compare_f64_bound(got, [a, x], N,
                                          lambda aa, xx: am.adj_matmul_plain(aa, xx, leak))
        else:
            err = cs.compare(got, am.adj_matmul_plain(a, x, leak), dt)
        ms = {name: cs.device_ms(lambda: launch(fn, a, x, leak, plan)) for name, fn in fns.items()}
        ms["torch_mm"] = cs.device_ms(lambda: torch.mm(a, x))
        if leak is None:   # the full build at each k-split
            for split in (1, 2, 4, 8):
                at = dataclasses.replace(plan, split=split, grid=(split, *plan.grid[1:]),
                                         k_slices=am.split_k(N, plan.tile[2], split))
                ms[f"full_split{split}"] = cs.device_ms(lambda: launch(fns["full"], a, x, leak, at))
        print(json.dumps({"shape": [[N, N], [N, H]], "dtype": str(dt)[6:], "leak": leak,
                          "variant": plan.variant, "split": plan.split, "blocks": plan.blocks,
                          "max_abs_err": err, "ms": ms}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
