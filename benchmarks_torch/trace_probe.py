#!/usr/bin/env python3
"""Which kernel records a ``torch.profiler`` trace loses, and what keeps them.

    python3 benchmarks_torch/trace_probe.py [--rounds 8] [--variants trainer,...]
                                                        # on the card, ~2 min

In one process, which traces once first (so that every trace after it is
in a process that has traced before, as in ``chip_smoke.py``'s
``trace_twice`` phase), synthetic2's epoch of 4 steps (40 graphs, f32) is
traced in rounds, each round every variant once, in this order:

  * ``trainer``: a new ``Trainer``'s ``run(2, profile_dir=...)``, the
    package's own tracing of its second epoch (``Trainer._profiled_epoch``);
  * ``trainer_no_margin``: the same with ``train.TRACE_MARGIN_S`` = 0, the
    epoch's kernels launched at the window's start and the trace stopped
    at their end;
  * ``bare``: ``profile()`` entered and the epoch launched at once;
  * ``bare_sleep``: the same, the host asleep 20 ms (the card idle) between;
  * ``warm_idle``: a discarded warm-up step of 20 ms with no kernel, then
    the epoch;
  * ``warm_kernels``: a discarded warm-up step of 20 ms of one-element
    kernels, each waited for, then the epoch;
  * ``warm_kernels_sleep``: that warm-up, then 20 ms asleep before the epoch.

Each trace's kernel events are held against the wrappers' launches, and
its host launches without a kernel record are counted twice: in the
exported Chrome trace (``chip_smoke.trace_records``, with when they ran)
and in the profile itself (``train.launches_without_record``).  One JSON
line a trace, then one line a variant (traces that lost records, records
lost, the least margins between the window's edges and the device's
records, the least and the largest time from a launch to its record), then
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PAUSE_S = 0.02
VARIANTS = ("trainer", "trainer_no_margin", "bare", "bare_sleep", "warm_idle", "warm_kernels",
            "warm_kernels_sleep")


def traced_epoch(trainer, variant: str, epoch: int):
    """``trainer``'s epoch ``epoch`` under a profiler of ``variant``."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    warm = variant.startswith("warm")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True,
                 **({"schedule": schedule(wait=0, warmup=1, active=1)} if warm else {})) as prof:
        if variant == "warm_idle":
            time.sleep(PAUSE_S)
        elif warm:
            x = torch.zeros(1, device="cuda")
            end = time.perf_counter() + PAUSE_S
            while time.perf_counter() < end:
                x.add_(1)
                torch.cuda.synchronize()
        if warm:
            prof.step()
        if variant.endswith("sleep"):
            torch.cuda.synchronize()
            time.sleep(PAUSE_S)
        with record_function("train_epoch"):
            trainer.run_epoch(epoch)
        torch.cuda.synchronize()
    return prof


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--variants", default=",".join(VARIANTS),
                   help="comma-separated variants of each round, in order")
    args = p.parse_args()
    variants = args.variants.split(",")
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        p.error(f"unknown variants {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("trace_probe: needs a CUDA card", file=sys.stderr)
        return 1
    from snd_vae_tpu_torch import train as tt
    from snd_vae_tpu_torch.config import synthetic2_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset
    from snd_vae_tpu_torch.nn.kernels import adj_matmul as am
    from snd_vae_tpu_torch.nn.kernels import build
    from snd_vae_tpu_torch.nn.kernels import motif_combine as mc
    from snd_vae_tpu_torch.nn.kernels import motif_level3 as ml

    build.build()
    cfg = synthetic2_preset(dataset_path=str(ROOT / "dataset"))
    data = load_dataset(cfg, "train", num_graphs=cs.TRACE_GRAPHS, device="cuda")
    nb = data.batch_size // cfg.train.batch_size
    want = cs.events_of(cs.per(nb, 2, 2, 2, 2))
    summary = {v: {"traces": 0, "short": 0, "lost": [], "margins_us": [], "lag_us": []}
               for v in variants}
    margin = tt.TRACE_MARGIN_S
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as wd:
        shared = tt.Trainer(cfg, data, device="cuda", workdir=f"{wd}/shared")
        shared.run_epoch(0)
        traced_epoch(shared, "bare", 0)          # this process has traced before
        epoch = 1
        for r in range(args.rounds):
            for v in variants:
                torch.cuda.synchronize()
                cs.zero_counts(ml, mc, am)
                if v.startswith("trainer"):
                    tt.TRACE_MARGIN_S = 0.0 if v == "trainer_no_margin" else margin
                    d = f"{wd}/{v}_{r}"
                    tr = tt.Trainer(cfg, data, device="cuda", workdir=d)
                    tr.run(2, verbose=False, profile_dir=f"{d}/profile")
                    tt.TRACE_MARGIN_S = margin
                    path = f"{d}/profile/trace_rank0.json"
                    in_memory = json.loads(
                        Path(f"{d}/profile/trace_rank0.launches.json").read_text())
                    # 2 epochs and the warm-up's forward and backward: 2 a kernel
                    launches = cs.per(2 * nb + 1, 2, 2, 2, 2)
                    if cs.read_counts(ml, mc, am) != launches:
                        raise RuntimeError(f"trainer launches {cs.read_counts(ml, mc, am)}")
                    launches = cs.per(nb, 2, 2, 2, 2)
                else:
                    prof = traced_epoch(shared, v, epoch)
                    epoch += 1
                    launches = cs.read_counts(ml, mc, am)
                    path = f"{wd}/{v}_{r}.json"
                    prof.export_chrome_trace(path)
                    host, lost = tt.launches_without_record(prof)
                    in_memory = {"host_launches": host, "launches_without_device_record": lost}
                rec = cs.trace_records(path)
                equal = rec["kernel_events"] == cs.events_of(launches) == want
                summary[v]["traces"] += 1
                summary[v]["short"] += not equal
                summary[v]["lost"].append(rec["launches_without_kernel"])
                summary[v]["margins_us"].append((rec["first_record_after_start_us"],
                                                 rec["window_end_after_last_record_us"]))
                summary[v]["lag_us"].append(rec["kernel_after_launch_us"])
                print(json.dumps({"variant": v, "round": r, "equal": equal,
                                  "in_memory": in_memory, **rec}), flush=True)
    for v, s in summary.items():
        margins, lags = s.pop("margins_us"), s.pop("lag_us")
        least = lambda xs: min((x for x in xs if x is not None), default=None)
        print(json.dumps({"variant": v, **s,
                          "least_start_margin_us": least(m[0] for m in margins),
                          "least_end_margin_us": least(m[1] for m in margins),
                          "least_lag_us": least(x[0] for x in lags if x),
                          "largest_lag_us": max((x[-1] for x in lags if x), default=None)}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
