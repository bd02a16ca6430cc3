#!/usr/bin/env python3
"""Where ``motif_level3``'s time goes on one CUDA card.

    python3 benchmarks_torch/level3_ablation.py

Builds ``csrc/motif_level3.cu``, its header ``csrc/motif_level3.cuh``
inlined, five more times, each with a phase compiled out (the rf sums; the
k-chunk copies; the j-tile's epilogue copies; the epilogue; all four), and
times every build with ``chip_smoke.device_ms``
(median of 100 single launches behind a device-side spin) at the served
shapes, at N = 256 (16-byte copies; one tree and four) and N = 255 (4-byte
copies), beside the timing floor: a one-element ``fill_`` timed the same
way, and per launch in a run of 50 back-to-back launches.  The full build
is held against the plain version in float64 first.  A build with a phase
compiled out computes nothing meaningful; only its time is read.  Prints
one JSON line per shape and the card's name and power limit last.  Needs
nvcc and a card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from snd_vae_tpu_torch.nn.kernels import build  # noqa: E402
from snd_vae_tpu_torch.nn.kernels import motif_level3 as ml  # noqa: E402
from snd_vae_tpu_torch.nn.kernels._launch import stream_handle  # noqa: E402

# (macro, first line of the phase, last line of the phase) in the source,
# its header csrc/motif_level3.cuh inlined (rf_tile, stage_chunk and
# stage_tile live there)
PHASES = (
    ("SKIP_RF", "    for (int rr = 0; rr < r; ++rr) {\n      float s0",
     "(s2 + s3);\n    }"),
    ("SKIP_STAGE", "  stage_chunk<kTk>(as, ps, ab, pb, n, rows, r, i0, j0, 0, vec);", "vec);"),
    ("SKIP_STAGE", "      stage_chunk<kTk>(as + nb", "(c + 1) * kTk, vec);"),
    ("SKIP_EPI_STAGE", "  for (int e = tid; e < kTi * kTj * r; e += kThreads) {",
     "stage(vs + e, v_j + (ok ? (b * n + j) * h + hh : 0), ok);\n  }"),
    ("SKIP_EPI", "    if (i < rows) {\n      const unsigned all",
     "if (two) acc[q] = fmaf(a2, l2, acc[q]);\n        }\n      }\n    }"),
)
VARIANTS = {"full": [], "no_rf_sums": ["SKIP_RF"], "no_chunk_copies": ["SKIP_STAGE"],
            "no_epilogue_copies": ["SKIP_EPI_STAGE"], "no_epilogue": ["SKIP_EPI"],
            "none": ["SKIP_RF", "SKIP_STAGE", "SKIP_EPI_STAGE", "SKIP_EPI"]}
SHAPES = ((100, 25, 20, 0.4), (100, 25, 50, 0.4), (4, 256, 50, 0.4), (1, 256, 50, 0.4),
          (4, 256, 50, 0.0), (4, 255, 50, 0.4))


HEADER = "motif_level3.cuh"


def guarded_source() -> str:
    """The kernel source, its header inlined, with each phase between
    #ifndef MACRO / #endif."""
    src = (build.CSRC / "motif_level3.cu").read_text()
    include = f'#include "{HEADER}"'
    if src.count(include) != 1:
        raise ValueError(f"motif_level3.cu does not include {HEADER} once; update HEADER")
    src = src.replace(include, (build.CSRC / HEADER).read_text())
    for macro, start, end in PHASES:
        i = src.find(start)
        j = src.find(end, i)
        if i < 0 or j < 0:
            raise ValueError(f"phase {macro} not found in motif_level3.cu and {HEADER}; "
                             "update PHASES")
        j += len(end)
        src = f"{src[:i]}\n#ifndef {macro}\n{src[i:j]}\n#endif\n{src[j:]}"
    return src


def build_variants() -> dict:
    out_dir = build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "motif_level3_guarded.cu"
    src.write_text(guarded_source())
    procs = {name: subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, *(f"-D{m}" for m in macros),
         "-o", str(out_dir / f"lib{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, macros in VARIANTS.items()}
    fns = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"lib{name}.so")).motif_level3_launch
        fn.argtypes = list(ml._SIGNATURES["motif_level3_launch"])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launch(fn, x):
    nt = torch.empty_like(x[2])
    B, N, _, R = x[1].shape
    code = fn(*(t.data_ptr() for t in x), nt.data_ptr(), B, N, 0, N, R, x[2].shape[-1], 0,
              stream_handle(x[0].device))
    if code != 0:
        raise RuntimeError(f"launch failed with cudaError {code}")
    return nt


def per_launch_in_run(fn, count: int = 50) -> float:
    torch.cuda.synchronize()
    torch.cuda._sleep(cs.SPIN_CYCLES)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(count):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / count


def main() -> int:
    if not torch.cuda.is_available():
        print("level3_ablation: CUDA is not available", file=sys.stderr)
        return 1
    fns = build_variants()
    one = torch.ones(1, device="cuda")
    print(json.dumps({"floor": {"fill_ms": cs.device_ms(lambda: one.fill_(1.0)),
                                "fill_ms_in_run_of_50": per_launch_in_run(
                                    lambda: one.fill_(1.0))}}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, N, h, density in SHAPES:
        x = cs.level3_inputs(B, N, h, 1, torch.float32, gen, density)
        err, _ = cs.compare_f64_bound(launch(fns["full"], x), x, 2 * N + 4,
                                      ml.motif_level3_plain)
        ms = {name: cs.device_ms(lambda: launch(fn, x)) for name, fn in fns.items()}
        ms["full_in_run_of_50"] = per_launch_in_run(lambda: launch(fns["full"], x))
        print(json.dumps({"shape": [B, N, h], "density": density, "max_abs_err": err,
                          "ms": ms}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
