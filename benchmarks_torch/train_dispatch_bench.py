#!/usr/bin/env python3
"""The train step's dispatch and cuDNN settings on one CUDA card.

    python3 benchmarks_torch/train_dispatch_bench.py [--determinism]
        [--frontier-graphs] [--foreach] [--out FILE]

Builds every kernel, then:

  --determinism      each case's train steps with cuDNN's deterministic
                     algorithms (what ``train_step`` asks for,
                     ``device.deterministic_cudnn``) and with its default
                     picks (``chip_smoke.cudnn_default_picks``), in turns
                     (on, off, off, on): the frontier's first f32 step at
                     N = 2048 from the seed weights (each setting's step
                     profiled first), without and with remat
                     (``motif_block_rows=256``), and per-step epochs of
                     protein (100 graphs) and synthetic2 (200), f32 and
                     bf16.  Wall ms a step of each turn, and from one
                     profiled step or epoch of each setting the device-busy
                     ms a step and the kernels whose device ms differ most.
  --frontier-graphs  the default dispatch at the frontier's f32 step, N =
                     1024 and 2048 (4 graphs, 2 steps an epoch, no remat):
                     the first step with the capture (``StepGraph``), the
                     capture's seconds, then one replay and one eager
                     ``train_step`` in turns (graph, per step, per step,
                     graph), each from the seed weights (copied back in
                     place, Adam's moments and counts zeroed; ε drawn on
                     from the generator, which the graph holds); ms of each,
                     the peak of allocated memory and the memory allocated
                     and reserved between steps on each path.
  --foreach          Adam's division by its bias correction over
                     synthetic2's 102 parameter tensors, as one 0-dim count
                     (``torch._foreach_div_`` with one tensor) and as one
                     count a parameter (a list of 0-dim tensors): kernels
                     and device ms a call.

Prints one JSON line per result and the card's name and power limit last;
with ``--out`` the same lines go to that file too.  Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from snd_vae_tpu_torch import train as tt  # noqa: E402
from snd_vae_tpu_torch.nn.kernels import build  # noqa: E402

TURNS = (True, False, False, True)        # deterministic on / off
EPOCH_ROUNDS = 3                          # per-step epochs: rounds of TURNS
TOP_KERNELS = 8

OUT = []


def emit(name: str, payload: dict) -> None:
    line = json.dumps({"result": name, **payload})
    print(line, flush=True)
    OUT.append(line)


def cudnn_mode(det: bool):
    return contextlib.nullcontext() if det else cs.cudnn_default_picks()


def kernels_by_name(fn, steps: int) -> tuple:
    """(device-busy ms a step, {kernel: device ms a step}) of one profiled
    call of ``fn``, which takes ``steps`` train steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = {e.key: e.self_device_time_total / 1e3 / steps for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("train_step.")}
    return sum(rows.values()), rows


def differing(a: dict, b: dict) -> list:
    """The kernels whose device ms a step differ most between two
    settings: [name, ms with a, ms with b]."""
    keys = sorted(set(a) | set(b), key=lambda k: -abs(a.get(k, 0.0) - b.get(k, 0.0)))
    return [[k[:90], a.get(k, 0.0), b.get(k, 0.0)] for k in keys[:TOP_KERNELS]]


class SeedState:
    """A trainer's parameters as built, put back in place before each timed
    step, with Adam's moments and counts zeroed and the ε generator's
    state restored: every timed step is the run's first."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.params = [p.detach().clone() for p in trainer.state.model.parameters()]
        self.generator = trainer.state.generator.get_state()

    def put_back(self, generator: bool = True) -> None:
        st = self.trainer.state
        with torch.no_grad():
            for p, q in zip(st.model.parameters(), self.params):
                p.copy_(q)
            for s in st.optimizer.state.values():
                for t in s.values():
                    t.zero_()
        if generator:
            st.generator.set_state(self.generator)


def timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def frontier_data(n: int, graphs: int):
    from snd_vae_tpu_torch.data.loaders import load_dataset

    t0 = time.perf_counter()
    data = load_dataset(cs.frontier_config(n), "train", num_graphs=graphs, device="cuda")
    return data, time.perf_counter() - t0


def frontier_determinism(workdir: str) -> None:
    data, load_s = frontier_data(2048, 2)
    for name, remat, rows in (("frontier_2048_f32", False, None),
                              ("frontier_2048_f32_remat", True, 256)):
        cfg = cs.frontier_config(2048, "float32", remat, rows)
        torch.cuda.empty_cache()
        tr = tt.Trainer(cfg, data, device="cuda", workdir=f"{workdir}/{name}")
        seed = SeedState(tr)
        batch = tr.batched._map(lambda t: t[0])
        gi = torch.zeros((), device="cuda")
        step = lambda: tt.train_step(tr.state, batch, gi)
        res = {"N": 2048, "dtype": "float32", "remat": remat, "motif_block_rows": rows,
               "data_load_s": load_s}
        if not remat:
            # profiled first: each setting's step, which warms the card up
            # for the timed turns too
            prof = {}
            for det in (True, False):
                seed.put_back()
                with cudnn_mode(det):
                    prof[det] = kernels_by_name(step, 1)
            res.update(busy_ms={"deterministic": prof[True][0], "default": prof[False][0]},
                       top_differing=differing(prof[True][1], prof[False][1]))
        ms = {"deterministic": [], "default": []}
        for det in TURNS:
            seed.put_back()
            with cudnn_mode(det):
                ms["deterministic" if det else "default"].append(timed(step))
        res.update(ms_per_step=ms, cost=statistics.mean(ms["deterministic"])
                   / statistics.mean(ms["default"]) - 1)
        res["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
        emit("determinism", {"case": name, **res})
        del tr, seed, batch
    del data
    torch.cuda.empty_cache()


def epoch_determinism(workdir: str) -> None:
    from snd_vae_tpu_torch.data.loaders import load_dataset

    configs = cs.graph_configs()
    for name, (cfg, graphs) in (("protein", configs["protein_f32"]),
                                ("synthetic2", configs["synthetic2_f32"])):
        data = load_dataset(cfg, "train", device="cuda", num_graphs=graphs)
        for dtype in ("float32", "bfloat16"):
            tr = tt.Trainer(cfg.with_(compute_dtype=dtype), data, device="cuda",
                            workdir=f"{workdir}/{name}_{dtype}")
            nb = tr.batched.adj.shape[0]
            tr.run_epoch(0)
            epoch = 1
            ms = {"deterministic": [], "default": []}
            for _ in range(EPOCH_ROUNDS):
                for det in TURNS:
                    with cudnn_mode(det):
                        ms["deterministic" if det else "default"].append(
                            timed(lambda: tr.run_epoch(epoch)) / nb)
                    epoch += 1
            prof = {}
            for det in (True, False):
                with cudnn_mode(det):
                    prof[det] = kernels_by_name(lambda: tr.run_epoch(epoch), nb)
                epoch += 1
            med = {k: statistics.median(v) for k, v in ms.items()}
            emit("determinism", {
                "case": f"{name}_{dtype}", "graphs": data.batch_size, "steps_per_epoch": nb,
                "ms_per_step": ms, "median_ms_per_step": med,
                "steps_per_s": {k: 1e3 / v for k, v in med.items()},
                "cost": med["deterministic"] / med["default"] - 1,
                "busy_ms": {"deterministic": prof[True][0], "default": prof[False][0]},
                "top_differing": differing(prof[True][1], prof[False][1])})
            del tr
        del data
        torch.cuda.empty_cache()


def frontier_graphs(workdir: str) -> None:
    for n in (1024, 2048):
        data, load_s = frontier_data(n, 4)
        cfg = cs.frontier_config(n, "float32")
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr = tt.Trainer(cfg, data, device="cuda", workdir=f"{workdir}/graphs_{n}")
        seed = SeedState(tr)
        nb = tr.batched.adj.shape[0]
        graph = tt.StepGraph(tr, nb)
        graph.begin()
        graph.load(tr.batched)
        first_ms = timed(graph.step)         # the eager step and the capture
        res = {"N": n, "dtype": "float32", "graphs": data.batch_size, "steps_per_epoch": nb,
               "data_load_s": load_s, "first_step_and_capture_ms": first_ms,
               "capture_s": graph.capture_s,
               "peak_allocated_bytes_first_step_and_capture":
                   torch.cuda.max_memory_allocated() - base,
               "after_capture": {"allocated": torch.cuda.memory_allocated() - base,
                                 "reserved": torch.cuda.memory_reserved()}}
        batch = tr.batched._map(lambda t: t[0])
        gi = torch.zeros((), device="cuda")
        ms = {"graph": [], "per_step": []}
        held = {"graph": [], "per_step": []}
        peaks = {"graph": [], "per_step": []}
        for path in ("graph", "per_step", "per_step", "graph"):
            seed.put_back(generator=False)
            graph.begin()
            torch.cuda.reset_peak_memory_stats()
            ms[path].append(timed(graph.step if path == "graph"
                                  else lambda: tt.train_step(tr.state, batch, gi)))
            peaks[path].append(torch.cuda.max_memory_allocated() - base)
            held[path].append(torch.cuda.memory_allocated() - base)
        res.update(ms_per_step=ms, peak_allocated_bytes=peaks, allocated_after_step=held,
                   reserved_bytes=torch.cuda.memory_reserved(),
                   graph_over_per_step=statistics.mean(ms["graph"])
                   / statistics.mean(ms["per_step"]))
        emit("frontier_graphs", res)
        del tr, seed, graph, batch, data
        torch.cuda.empty_cache()


def foreach_division() -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from snd_vae_tpu_torch.models import build_model

    cfg = cs.graph_configs()["synthetic2_f32"][0]
    params = [p.detach().clone() for p in build_model(cfg, "cuda").parameters()]
    one = torch.full((), 0.9, device="cuda")
    each = [torch.full((), 0.9, device="cuda") for _ in params]
    res = {"tensors": len(params)}
    for name, other in (("one_count", one), ("count_per_parameter", each)):
        fn = lambda: torch._foreach_div_(params, other)
        res[name] = {"device_ms": cs.device_ms(fn)}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        res[name]["kernels_per_call"] = sum(
            e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 10
    emit("foreach_division", res)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--determinism", action="store_true")
    ap.add_argument("--frontier-graphs", action="store_true")
    ap.add_argument("--foreach", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_dispatch_bench: CUDA is not available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    emit("build", {"seconds": build.build()})
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as workdir:
        if args.foreach:
            foreach_division()
        if args.determinism:
            epoch_determinism(workdir)
            frontier_determinism(workdir)
        if args.frontier_graphs:
            frontier_graphs(workdir)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    emit("card", {"nvidia_smi": card, "torch": torch.__version__,
                  "seconds": time.perf_counter() - t0})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(OUT) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
