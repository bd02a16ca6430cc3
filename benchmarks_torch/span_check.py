#!/usr/bin/env python3
"""The program's own spans on one CUDA card: held to the profiler's trace,
and what they cost.

    python3 benchmarks_torch/span_check.py cell --workload <cell> --seeds <n> ...
        [--seconds S] [--out FILE]
    python3 benchmarks_torch/span_check.py rate --config <name> [--seed N]
        [--turn-seconds S] [--out FILE]

``cell`` runs a cell of ``BENCHMARK.json`` traced (``portbench/run.py``'s
``run_cell`` with ``--trace 1``) once a seed, prints its result line, and
from the run's trace and the program's ``trace_rank0.launches.json``:

  * a training cell: for each replay of the traced epoch and each span of
    ``spans.SPANS``, the trace's delta between the span's two stamp records
    (their starts) against the program's ``%globaltimer`` delta (``spans``'
    ``steps_ns``), the largest miss beside its limit, max(2%, 5 µs);
    forward + backward + optimizer over each replay's stamped extent; the
    stamp records' share of the device time inside the replays; the idle
    µs a replay inside each phase, inside replays and between them; and the
    longest idle gaps, each with the program's range the host was in;
  * a serving cell: device ms a request under the program's
    ``model.encode.sg_conv.<i>`` ranges against the benchmark's own
    ``sg_conv.<i>`` ranges (``serve.sg_conv_ms``).

``rate`` trains the configuration ``<name>`` of ``portbench/configs`` at the
benchmark's weights through ``train.StepGraph`` without and with stamps, in
turns (off, on, on, off), each a fresh capture and ``--turn-seconds`` of
epochs (one host sync an epoch): replays a second of each turn.

Prints one JSON line per result and the card's name and power limit last;
with ``--out`` the same lines go to that file too.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import run as prun  # noqa: E402

OUT: list = []
TURNS = (False, True, True, False)        # stamps off / on


def emit(name: str, payload: dict) -> None:
    line = json.dumps({"result": name, **payload})
    print(line, flush=True)
    OUT.append(line)


def replays_in_trace(run, kernel: str) -> list:
    """Each replay's stamp records (start, end) in the traced window, as
    ``train.replay_idle_pct`` groups them."""
    return prun.metric_reader("train.replay_idle_pct").__globals__["replays"](run, kernel)


def train_consistency(run) -> dict:
    from snd_vae_tpu_torch import spans

    sp = run.launches["spans"]
    steps = sp["steps_ns"]
    replays = replays_in_trace(run, sp["kernel"])
    out = {"replays_traced": len(replays), "steps_stamped": len(steps)}
    if len(replays) != len(steps) or any(len(r) != len(spans.STAMPS) for r in replays):
        return {**out, "matched": False}
    worst = {}
    for name, (a, b) in spans.SPANS.items():
        ia, ib = spans.INDEX[a], spans.INDEX[b]
        misses = []
        for recs, ns in zip(replays, steps):
            prog_us = (ns[ib] - ns[ia]) / 1e3
            trace_us = recs[ib][0] - recs[ia][0]
            misses.append((abs(trace_us - prog_us), prog_us, trace_us))
        miss, prog_us, trace_us = max(misses, key=lambda m: m[0] - max(0.02 * m[1], 5.0))
        limit = max(0.02 * prog_us, 5.0)
        worst[name] = {"miss_us": miss, "program_us": prog_us, "trace_us": trace_us,
                       "limit_us": limit, "holds": miss <= limit}
    k = spans.INDEX
    idle_us = {}
    for name in ("forward", "backward", "optimizer", "step"):
        a, b = (k[x] for x in spans.SPANS[name])
        idle_us[name] = sum((r[b][0] - r[a][0]) - run.trace.busy_us((r[a][0], r[b][0]))
                            for r in replays) / len(replays)
    window_idle_us = (run.window[1] - run.window[0]) - run.trace.busy_us(run.window)
    inside_us = sum((r[-1][1] - r[0][0]) - run.trace.busy_us((r[0][0], r[-1][1]))
                    for r in replays)
    cover = [(ns[k["train_step.end"]] - ns[k["train_step.forward"]])
             / (ns[k["step.end"]] - ns[k["step.start"]]) for ns in steps]
    stamp_us = sum(e - s for r in replays for s, e in r)
    busy_us = sum(run.trace.busy_us((r[0][0], r[-1][1])) for r in replays)
    return {**out, "matched": True, "spans": worst,
            "all_hold": all(w["holds"] for w in worst.values()),
            "phases_over_extent_min": min(cover), "phases_over_extent_median":
            statistics.median(cover), "stamp_share_of_replay_busy_pct": 100 * stamp_us / busy_us,
            "stamp_us_per_replay": stamp_us / len(replays), "ms": sp["ms"],
            "idle_us_per_replay": idle_us, "idle_us_inside_replays": inside_us,
            "idle_us_between_replays": window_idle_us - inside_us,
            "largest_gaps": largest_gaps(run, replays)}


# the program's host ranges that name what the host did during a gap
PROGRAM_RANGES = ("run.", "epoch.", "train_epoch", "StepGraph.capture")


def largest_gaps(run, replays, k: int = 6) -> list:
    """The ``k`` longest idle gaps of the window: µs, whether inside a
    replay's stamps, the program's innermost range at the gap's middle and
    the innermost host event there."""
    a, b = run.window
    gaps, prev = [], a
    for s, e, _, _ in run.trace.records(run.window):
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if b > prev:
        gaps.append((prev, b))
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
        mid = (s + e) / 2
        cover = sorted((h for h in run.trace.host if h[0] <= mid <= h[1]),
                       key=lambda h: h[1] - h[0])
        ours = [h[2] for h in cover if h[2].startswith(PROGRAM_RANGES)]
        inside = any(r[0][0] <= mid <= r[-1][1] for r in replays)
        out.append({"us": e - s, "inside_replay": inside,
                    "program_range": ours[0] if ours else None,
                    "host": cover[0][2] if cover else None})
    return out


def serve_consistency(run) -> dict:
    ours = sum(run.trace.range_device_us(run.window, "model.encode.sg_conv.").values())
    bench = sum(run.trace.range_device_us(run.window, "sg_conv.").values())
    return {"program_sg_conv_ms": ours / 1e3 / run.units,
            "benchmark_sg_conv_ms": bench / 1e3 / run.units,
            "relative_miss": abs(ours - bench) / bench if bench else None}


def cell(args) -> None:
    import portbench.drive as drive

    prun.prepare_process()
    bench = prun.load_benchmark()
    kept = {}
    real = drive.drive

    def keep(ctx):
        kept["out"] = real(ctx)
        return kept["out"]

    drive.drive = keep
    for seed in args.seeds:
        result, _ = prun.run_cell(bench, args.workload, seed, args.seconds, True, "cuda",
                                  time.perf_counter())
        emit("cell", {"workload": args.workload, "seed": seed, "line": result})
        run = kept["out"].run
        check = train_consistency(run) if run.mode == "train" else serve_consistency(run)
        emit("consistency", {"workload": args.workload, "seed": seed, **check})


def rate(args) -> None:
    import torch

    from portbench import inputs
    from portbench.drive import graphbatch, load_weights, port_config
    from portbench.reference import model as ref
    from snd_vae_tpu_torch import spans
    from snd_vae_tpu_torch import train as tt

    prun.prepare_process()
    cfg, dev = prun.load_json("configs", args.config), torch.device("cuda")
    data = inputs.make_split(cfg, cfg["splits"]["train"], args.seed, "train")
    with tempfile.TemporaryDirectory() as workdir:
        trainer = tt.Trainer(port_config(cfg, args.seed), graphbatch(data, dev), device=dev,
                             workdir=workdir)
        load_weights(trainer.state.model, inputs.make_weights(ref.param_spec(cfg), args.seed,
                                                              dev))
        nb = trainer.batched.adj.shape[0]
        for turn, stamped in enumerate(TURNS):
            graph = tt.StepGraph(trainer, nb)
            if stamped:
                graph.stamps = spans.Stamps(nb, graph.row)
            trainer.graph_epochs(graph, range(0, 1))        # the eager step and the capture
            torch.cuda.synchronize(dev)
            epochs, t0 = 0, time.perf_counter()
            while time.perf_counter() - t0 < args.turn_seconds:
                trainer.graph_epochs(graph, range(1 + epochs, 2 + epochs))
                epochs += 1
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            emit("rate", {"config": args.config, "turn": turn, "stamps": stamped,
                          "epochs": epochs, "replays_per_s": epochs * nb / wall,
                          "nodes": graph.kernels_per_replay + graph.copies_per_replay,
                          "stamps_per_replay": graph.stamps_per_replay})
            graph.release()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    c = sub.add_parser("cell")
    c.add_argument("--workload", required=True)
    c.add_argument("--seeds", type=int, nargs="+", required=True)
    c.add_argument("--seconds", type=float, default=15.0)
    r = sub.add_parser("rate")
    r.add_argument("--config", required=True)
    r.add_argument("--seed", type=int, default=3_000_000_019)
    r.add_argument("--turn-seconds", type=float, default=5.0)
    for p in (c, r):
        p.add_argument("--out")
    args = ap.parse_args(argv)
    (cell if args.what == "cell" else rate)(args)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    emit("card", {"nvidia_smi": card.strip()})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(OUT) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
