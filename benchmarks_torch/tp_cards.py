#!/usr/bin/env python3
"""The mesh's model axis across CUDA cards, against one process.

    python3 benchmarks_torch/tp_cards.py            # needs 4 cards (2 for --cards 2)

Trains synthetic2 at full width (the generated splits, f32) for 2 epochs
through the CLI, once in one process and once under ``torchrun`` on each
mesh that fits the cards: (data, model) = (1, 2), and with 4 cards (1, 4)
and (2, 2) (``--dp d --tp m --distributed``, NCCL, one card per process).
Each run's per-epoch mean losses (its ``logs/*.jsonl``) must equal the
single process's at rtol 1e-5 (f32 sums in another order; two single runs
on one card differ by ~1e-8), every rank must print the same result, and
the checkpoints written hold whole tensors (``sg_lin1.kernel`` is
[1250, 100] whatever the mesh).  Prints one JSON line per run (wall
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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cards", type=int, default=4, choices=(2, 4))
    args = p.parse_args()
    if torch.cuda.device_count() < args.cards:
        print(f"tp_cards: needs {args.cards} CUDA cards, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 1
    cli = ["-m", "snd_vae_tpu_torch.cli", "--type", "train", "--epochs", str(EPOCHS),
           "--dataset-path", str(ROOT / "dataset")]
    meshes = [(1, 2)] + ([(1, 4), (2, 2)] if args.cards == 4 else [])
    out = {}
    os.makedirs(ROOT / "build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
