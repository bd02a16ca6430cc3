#!/usr/bin/env python3
"""Where the tiled K3 kernel's time goes on one CUDA card.

    python3 benchmarks_torch/adj_matmul_ablation.py

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
Prints one JSON line per case and the card's name and power limit last.
Needs nvcc and a card.
"""

from __future__ import annotations

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


def build_variants() -> dict:
    out_dir = build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "adj_matmul.cu"
    procs = {name: subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, *(f"-D{m}" for m in macros),
         "-o", str(out_dir / f"libadj_{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, macros in VARIANTS.items()}
    fns = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"libadj_{name}.so")).adj_matmul_launch
        fn.argtypes = list(am._SIGNATURES["adj_matmul_launch"])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launch(fn, a, x, leak, plan):
    out = torch.empty(a.shape[0], x.shape[-1], dtype=x.dtype, device=x.device)
    code = fn(*am.launch_args(a, x, None, out, leak, plan))
    if code != 0:
        raise RuntimeError(f"launch failed with cudaError {code}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("adj_matmul_ablation: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build_variants()
    lib = ctypes.CDLL(str(build.BUILD_DIR / "ablation" / "libadj_full.so"))
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
