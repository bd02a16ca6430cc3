"""Readings that set the limits of ``correct``: the plain reference put in
the program's place, computed in the precision below the configuration's
(TF32 for f32 with TF32 off: the control), or with a fault planted in it, and
judged against the reference in the configuration's precision on the cell's
own inputs, at its own size.  The benchmark's runs never run this.

    python3 portbench/control.py --workload s2_train --seeds 1 2 3 \
        --variants tf32 half_batch

prints one JSON line per seed and variant with the numbers ``check`` compares.
Variants: ``tf32`` (every cell); ``half_batch`` (training: each step of the
epoch sees half of its batch and takes the mean over it); ``program`` (the
program itself, a run of the cell with a ``--seconds`` window in this
process: the lower readings, many seeds for one start-up).  A state left
unchanged reads 1 in ``change_gap`` and ``change_gap_median`` by their
definition and needs no run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def program_readings(cell: str, seed: int, seconds: float, device: str = "cuda") -> dict:
    """The program's own numbers: a run of the cell (a short window) in this
    process, every number ``check`` computes, limit or not."""
    import time

    import torch

    from portbench.drive import Context, drive
    from portbench.run import find_cell, load_benchmark, load_json

    w = find_cell(load_benchmark(), cell)
    ctx = Context(cell, load_json("configs", w["config"]), load_json("traffic", w["traffic"]),
                  seed, seconds, False, torch.device(device), time.perf_counter())
    out = drive(ctx)
    return {"variant": "program", "failed": out.failed, **out.numbers, **ctx.look}


def readings(cell: str, seed: int, variants, device: str = "cuda") -> list:
    import torch

    from portbench import check, inputs
    from portbench.drive import to_device
    from portbench.reference import model as ref
    from portbench.run import find_cell, load_benchmark, load_json

    if not variants:
        return []
    w = find_cell(load_benchmark(), cell)
    cfg, tr = load_json("configs", w["config"]), load_json("traffic", w["traffic"])
    dev = torch.device(device)
    P0 = inputs.make_weights(ref.param_spec(cfg), seed, dev)
    gen = lambda: torch.Generator(device=dev).manual_seed(seed)
    out = []
    if tr["mode"] == "train":
        B = cfg["train"]["batch_size"]
        data = inputs.make_split(cfg, cfg["splits"][tr["split"]], seed, tr["split"])
        batches = [to_device(data, dev, i * B, B) for i in range(len(data["adj"]) // B)]
        ref.set_precision(False)
        judge = ref.train_steps(P0, cfg, batches, gen())
        for v in variants:
            feed = batches
            if v == "half_batch":
                feed = [{k: t[:B // 2] for k, t in b.items()} for b in batches]
            ref.set_precision(v == "tf32")
            got = ref.train_steps(P0, cfg, feed, gen())
            ref.set_precision(False)
            out.append({"variant": v, **check.train_numbers(got, judge, P0)})
        return out
    G = tr["graphs_per_request"]
    with torch.no_grad():
        data = inputs.make_split(cfg, cfg["splits"][tr["split"]], seed, tr["split"])
        batches = [to_device(data, dev, i * G, G) for i in range(len(data["adj"]) // G)]

        def answer(b):
            st, o = ref.forward(P0, cfg, b)
            return {**o, **st}
        ref.set_precision(False)
        judge = [answer(b) for b in batches]
        for v in variants:
            ref.set_precision(v == "tf32")
            got = [answer(b) for b in batches]
            ref.set_precision(False)
            out.append({"variant": v, **check.serve_numbers(list(zip(got, judge)))})
    return out


def main(argv=None) -> int:
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != ROOT / "portbench"]
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=["tf32"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=1.0,
                    help="the window of a ``program`` reading")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        found = (readings(args.workload, seed, [v for v in args.variants if v != "program"],
                          args.device)
                 + ([program_readings(args.workload, seed, args.seconds, args.device)]
                    if "program" in args.variants else []))
        for r in found:
            print(json.dumps({"workload": args.workload, "seed": seed, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
