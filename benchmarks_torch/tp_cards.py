#!/usr/bin/env python3
"""The mesh's model axis across CUDA cards, against one process.

    python3 benchmarks_torch/tp_cards.py            # needs 4 cards (2 for --cards 2)
    python3 benchmarks_torch/tp_cards.py --part frontier --device cpu --nodes 32  # gloo rehearsal

``--part synthetic2`` trains synthetic2 at full width (the generated
splits, f32) for 2 epochs through the CLI, once in one process and once
under ``torchrun`` on each mesh that fits the cards: (data, model) = (1,
2), and with 4 cards (1, 4) and (2, 2) (``--dp d --tp m --distributed``,
NCCL, one card per process).  Each run's per-epoch mean losses (its
``logs/*.jsonl``) must equal the single process's at rtol 1e-5 (f32 sums
in another order; two single runs on one card differ by ~1e-8), every rank
must print the same result, and the checkpoints written hold whole
tensors (``sg_lin1.kernel`` is [1250, 100] whatever the mesh).

``--part frontier`` takes one f32 train step of the frontier configuration
(``chip_smoke.frontier_config``: synthetic2's widths at ``--nodes`` N, 1024
by default, B = 2 graphs x S = 2 trees) from the seed weights on the train
split's first 2 graphs, in one process and under ``torchrun`` on the
meshes (1, 2) and, with 4 cards, (1, 4), where E2E's layers run on each
rank's rows (``E2E._rows``).  A Trainer takes a warm-up step, then a new
one the timed step: its loss and every gradient (gathered whole) must
equal one process's at rtol 1e-4 (atol 3e-4 of each gradient's largest
magnitude, as ``tests/test_torch_frontier.py`` holds the step to JAX's);
each rank's ms for the step and peak of allocated memory are reported.

``--part all`` (the default) runs both.  Prints one JSON line per run (wall
seconds, the losses, the result) and the cards' name and power limit last.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
EPOCHS = 2


def run(cmd, workdir: Path) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    # each rank's stdout in its own file (torchrun --redirects 1), or the one process's
    outs = sorted((workdir / "ranks").rglob("stdout.log")) if (workdir / "ranks").exists() \
        else [None]
    results = [json.loads((proc.stdout if f is None else f.read_text()).splitlines()[-1])
               for f in outs]
    (log,) = (workdir / "logs").glob("train_loss_*.jsonl")
    losses = [json.loads(line)["loss"] for line in log.read_text().splitlines()]
    saved = sorted((workdir / "checkpoints" / "synthetic2_disentangled").glob("ckpt_*.pt"))
    ckpt = torch.load(saved[-1], map_location="cpu", weights_only=True)
    return {"seconds": secs, "epoch_mean_loss": losses, "results": results,
            "checkpoints": [f.name for f in saved],
            "sg_lin1_shape": list(ckpt["model"]["sg_lin1.kernel"].shape)}


def frontier_worker(args) -> None:
    """One rank of ``--part frontier`` (the world from ``torchrun``'s
    environment; 1 without it): a warm-up step, then the timed step from
    the seed weights of a new Trainer; writes ``<out>/rank<r>.pt``."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import frontier_config

    from snd_vae_tpu_torch import train as tt
    from snd_vae_tpu_torch.data.loaders import load_dataset
    from snd_vae_tpu_torch.parallel import initialize_distributed, make_mesh
    from snd_vae_tpu_torch.parallel import tensor_parallel as tp
    from snd_vae_tpu_torch.parallel.mesh import shard_graphbatch

    if args.device == "cpu":
        torch.set_num_threads(1)
    world = int(os.environ.get("WORLD_SIZE", 1))
    mesh = None
    if world > 1:
        initialize_distributed(device=args.device)
        mesh = make_mesh(1, world, args.device)
    rank = int(os.environ.get("RANK", 0))
    dev = torch.device(f"cuda:{torch.cuda.current_device()}") if args.device == "cuda" \
        else torch.device("cpu")
    cfg = frontier_config(args.nodes)
    data = load_dataset(cfg, "train", num_graphs=2, device=dev)
    out = Path(args.frontier_worker)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    for _ in range(2):          # a warm-up step, then the timed one, each from the seed weights
        tr = tt.Trainer(cfg, data, device=dev, workdir=str(out / f"wd{rank}"), mesh=mesh)
        batch = tr.batched._map(lambda t: t[0])
        batch = batch if mesh is None else shard_graphbatch(batch, mesh)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        sync()
        t0 = time.perf_counter()
        aux = tt.train_step(tr.state, batch, torch.zeros((), device=dev))
        sync()
        ms = (time.perf_counter() - t0) * 1e3
    named = dict(tp.canonical_parameters(tr.state.model))
    grads = tp.whole_tensors(tr.state.model, {n: p.grad for n, p in named.items()})
    res = {"rank": rank, "world": world, "loss": aux["loss"].item(), "ms": ms,
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None}
    if rank == 0:
        res["grads"] = {n: g.float().cpu() for n, g in grads.items()}
    torch.save(res, out / f"rank{rank}.pt")
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()


def frontier(args, meshes) -> dict:
    """``--part frontier``: one process, then each mesh under torchrun."""
    runs = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for m in [1] + [m for d, m in meshes if d == 1]:
            wd = Path(tmp) / f"frontier_1x{m}"
            wd.mkdir()
            me = [sys.executable, str(Path(__file__).resolve()), "--frontier-worker", str(wd),
                  "--nodes", str(args.nodes), "--device", args.device]
            cmd = me if m == 1 else [sys.executable, "-m", "torch.distributed.run",
                                     "--standalone", "--nproc_per_node", str(m), *me[1:]]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900,
                                  env=dict(os.environ, PYTHONPATH=str(ROOT)))
            if proc.returncode != 0:
                raise RuntimeError(f"{cmd} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
            ranks = [torch.load(wd / f"rank{r}.pt", weights_only=False) for r in range(m)]
            name = f"frontier_1x{m}"
            runs[name] = ranks
            print(json.dumps({"run": name, "nodes": args.nodes, "seconds":
                              time.perf_counter() - t0, "loss": ranks[0]["loss"],
                              "ms_per_rank": [r["ms"] for r in ranks],
                              "peak_gb_per_rank": [r["peak_gb"] for r in ranks]}), flush=True)
            if len({r["loss"] for r in ranks}) != 1:
                raise RuntimeError(f"{name}: the ranks' losses {[r['loss'] for r in ranks]}")
            if m == 1:
                continue
            want, got = runs["frontier_1x1"][0], ranks[0]
            if not abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"]):
                raise RuntimeError(f"{name}: loss {got['loss']} vs one process's {want['loss']}")
            worst = {}
            for n, g in want["grads"].items():
                scale = g.abs().max().item()
                gap = (got["grads"][n] - g).abs() - 1e-4 * g.abs()
                worst[n] = gap.max().item() / scale if scale else gap.max().item()
                if not torch.allclose(got["grads"][n], g, rtol=1e-4, atol=3e-4 * scale):
                    raise RuntimeError(f"{name}: gradient {n} off by {worst[n]} of its largest")
            print(json.dumps({"run": name, "gradients_equal": len(worst),
                              "largest_gap_over_scale": max(worst.values())}), flush=True)
    return runs


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cards", type=int, default=4, choices=(2, 4))
    p.add_argument("--part", default="all", choices=("all", "synthetic2", "frontier"))
    p.add_argument("--nodes", type=int, default=1024, help="the frontier's N")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cpu: gloo ranks on the host (--part frontier), a rehearsal")
    p.add_argument("--frontier-worker", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.frontier_worker:
        frontier_worker(args)
        return 0
    if args.device == "cuda" and torch.cuda.device_count() < args.cards:
        print(f"tp_cards: needs {args.cards} CUDA cards, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 1
    cli = ["-m", "snd_vae_tpu_torch.cli", "--type", "train", "--epochs", str(EPOCHS),
           "--dataset-path", str(ROOT / "dataset")]
    meshes = [(1, 2)] + ([(1, 4), (2, 2)] if args.cards == 4 else [])
    out = {}
    os.makedirs(ROOT / "build", exist_ok=True)
    if args.part in ("all", "frontier"):
        frontier(args, meshes)
    if args.part == "frontier":
        meshes = []
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        if meshes:
            wd = Path(tmp) / "single"
            out["single"] = run([sys.executable, *cli, "--workdir", str(wd)], wd)
            print(json.dumps({"run": "single", **out["single"]}), flush=True)
        for d, m in meshes:
            wd = Path(tmp) / f"mesh_{d}x{m}"
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", str(d * m), "--log-dir", str(wd / "ranks"),
                   "--redirects", "1", *cli, "--workdir", str(wd),
                   "--dp", str(d), "--tp", str(m), "--distributed"]
            res = run(cmd, wd)
            name = f"{d}x{m}"
            out[name] = res
            print(json.dumps({"run": name, **res}), flush=True)
            losses = {r["loss"] for r in res["results"]}
            if len(res["results"]) != d * m or len(losses) != 1:
                raise RuntimeError(f"{name}: the ranks printed {res['results']}")
            for got, want in zip(res["epoch_mean_loss"], out["single"]["epoch_mean_loss"]):
                if not (math.isfinite(got) and abs(got - want) <= 1e-5 * abs(want)):
                    raise RuntimeError(f"{name}: losses {res['epoch_mean_loss']} vs "
                                       f"{out['single']['epoch_mean_loss']}")
            if res["sg_lin1_shape"] != [1250, 100]:
                raise RuntimeError(f"{name}: checkpoint not whole: {res['sg_lin1_shape']}")
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
