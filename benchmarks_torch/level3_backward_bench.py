#!/usr/bin/env python3
"""The level-3 backward (K2) on one CUDA card: each of its kernels' device
time by name, and ``chip_smoke.py``'s K2 phase and train turns.

    python3 benchmarks_torch/level3_backward_bench.py [--root DIR] [--label L]
        [--split] [--sizes] [--k2] [--train] [--out FILE]

Imports ``snd_vae_tpu_torch`` and ``chip_smoke`` from ``--root`` (default:
this checkout; give another checkout, e.g. the parent commit unpacked with
``git archive``, to measure that version), builds every kernel, then:

  --split  ``fused_motif_level3_backward`` at synthetic2's two layers,
           [100,25,25,20] and [100,25,25,50] with R = 1, f32 and bf16 (the
           bf16 model's layer 2), on random graphs of density 0.4 (the
           kernel phase's inputs) and on the spanning trees of the
           synthetic2 train split's first batch (what a train step gives):
           the median device ms of one call by CUDA events
           (``chip_smoke.device_ms``) for the model's gradients and for all
           eight, and, from ``torch.profiler`` over 50 calls, the device ms
           and launches per call of each of the backward's kernels by name
           (this checkout's ``chip_smoke.backward_kernels_ms``, which any
           version's kernels share a name prefix for);
  --sizes  the model's gradients (events, ``chip_smoke.device_ms``) at
           ``SIZES``: N = 256 at B = 1, 4, 8, 16 (more row tiles than one
           cluster holds; the grid from below one wave to several), the
           kernel phase's other shapes off the path, and synthetic2's
           layer 2, on random graphs of density 0.4;
  --k2     ``chip_smoke.check_level3_backward``: every case of the K2 phase,
           its checks, ms and bound;
  --train  ``chip_smoke.run_training``: the synthetic2 Trainer in f32 and
           bf16, with its profile and the backward against the replaced
           autograd chain in turns.

Prints one JSON line per result, each with ``label``, and the card's name
and power limit last; with ``--out`` the same lines go to that file too.
Run two checkouts in turns in one call to compare them on one card.
Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

SPLIT_CALLS = 50
# --sizes: (B, N, h, R)
SIZES = ((1, 256, 50, 1), (4, 256, 50, 1), (8, 256, 50, 1), (16, 256, 50, 1),
         (2, 72, 75, 2), (2, 40, 70, 5), (3, 29, 37, 2), (100, 25, 50, 1))


def load_chip_smoke(root: Path, name: str):
    """The ``chip_smoke.py`` of the checkout at ``root``, as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def load_root(root: Path):
    """``chip_smoke`` and the port's kernel modules of the checkout at ``root``."""
    sys.path.insert(0, str(root))
    cs = load_chip_smoke(root, "chip_smoke")
    from snd_vae_tpu_torch.nn.kernels import adj_matmul as am
    from snd_vae_tpu_torch.nn.kernels import build
    from snd_vae_tpu_torch.nn.kernels import motif_combine as mc
    from snd_vae_tpu_torch.nn.kernels import motif_level3 as ml

    check = Path(ml.__file__).resolve()
    if root not in check.parents:
        raise RuntimeError(f"imported {check}, not from {root}")
    return cs, build, ml, mc, am


def split(cs, ml, root: Path, kernels_ms) -> list:
    from snd_vae_tpu_torch.config import synthetic2_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset

    cfg = synthetic2_preset(dataset_path=str(root / "dataset"))
    data = load_dataset(cfg, "train", device="cuda")
    trees = data.slice_batch(0, cfg.train.batch_size).adj_samples.reshape(
        -1, cfg.num_nodes, cfg.num_nodes).float()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for graphs in ("density_0.4", "trees"):
        for h, dt in ((20, torch.float32), (50, torch.float32), (50, torch.bfloat16)):
            x = cs.level3_inputs(100, 25, h, 1, dt, gen, 0.4,
                                 adj=None if graphs == "density_0.4" else trees)
            g = torch.randn(100, 25, h, generator=gen, device="cuda").to(dt)
            model = lambda: ml.fused_motif_level3_backward(g, *x, needs=cs.MODEL_NEEDS)
            every = lambda: ml.fused_motif_level3_backward(g, *x)
            out.append({"graphs": graphs, "shape": [100, 25, 25, h], "dtype": str(dt)[6:],
                        "ms_model": cs.device_ms(model), "ms_all_eight": cs.device_ms(every),
                        "kernels_model": kernels_ms(ml, model, SPLIT_CALLS)[0],
                        "kernels_all_eight": kernels_ms(ml, every, SPLIT_CALLS)[0],
                        "bound_model": cs.level3_backward_bound(x[0], 1, h, cs.MODEL_NEEDS, dt)})
    return out


def sizes(cs, ml) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for B, N, h, R in SIZES:
        x = cs.level3_inputs(B, N, h, R, torch.float32, gen, 0.4)
        g = torch.randn(B, N, h, generator=gen, device="cuda")
        out[f"{B},{N},{h},{R}"] = cs.device_ms(
            lambda: ml.fused_motif_level3_backward(g, *x, needs=cs.MODEL_NEEDS))
    return out


def main() -> int:
    here = Path(__file__).resolve().parents[1]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=here)
    ap.add_argument("--label", default="this")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--sizes", action="store_true")
    ap.add_argument("--k2", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("level3_backward_bench: CUDA is not available", file=sys.stderr)
        return 1
    root = args.root.resolve()
    cs, build, ml, mc, am = load_root(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("")

    def emit(kind: str, payload) -> None:
        line = json.dumps({"label": args.label, "kind": kind, "result": payload})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    emit("build", {"root": str(root), "seconds": build.build(),
                   "ptxas": {k: [ln.split(" : ")[-1].strip() for ln in v.splitlines()
                                 if "registers" in ln or "spill" in ln or "entry" in ln]
                             for k, v in build.build_log.items()}})
    if args.split:
        kernels_ms = load_chip_smoke(here, "chip_smoke_here").backward_kernels_ms
        for row in split(cs, ml, root, kernels_ms):
            emit("split", row)
    if args.sizes:
        emit("sizes", sizes(cs, ml))
    if args.k2:
        for row in cs.check_level3_backward(ml, torch.Generator(device="cuda").manual_seed(0)):
            emit("k2", row)
    if args.train:
        emit("train", cs.run_training(ml, mc, am))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit("device", smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
