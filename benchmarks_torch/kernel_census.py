#!/usr/bin/env python3
"""The device kernels of one reconstructed synthetic2 batch, by name, on one
CUDA card.

    python3 benchmarks_torch/kernel_census.py [--root DIR]

Imports ``snd_vae_tpu_torch`` from ``--root`` (default: this checkout; give
another checkout of the repository to census that version), builds the
synthetic2 model at full width with random weights from its seed, as
``chip_smoke.py`` does, reconstructs one batch to warm up, then profiles 5
batches with ``torch.profiler``.  Prints one JSON line per compute dtype
(float32, bfloat16): each kernel's name (cut to 90 characters) with its
launches per batch, and their total.  Two checkouts censused in one call
tell which kernels a change added or removed.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

import torch

BATCHES = 5


def census(root: Path) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from snd_vae_tpu_torch.config import synthetic2_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset
    from snd_vae_tpu_torch.models import build_model
    from snd_vae_tpu_torch.serve import reconstruct

    cfg = synthetic2_preset(dataset_path=str(root / "dataset"))
    B = cfg.train.batch_size
    data = load_dataset(cfg, "test", device="cuda")
    batches = [data.slice_batch(i * B, B) for i in range(BATCHES)]
    for dtype_name in ("float32", "bfloat16"):
        model = build_model(cfg.with_(compute_dtype=dtype_name), device="cuda")
        reconstruct(model, batches[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for b in batches:
                reconstruct(model, b)
            torch.cuda.synchronize()
        counts = Counter()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                counts[e.key[:90]] += e.count
        print(json.dumps({"root": str(root), "dtype": dtype_name,
                          "kernels_per_batch": sum(counts.values()) / BATCHES,
                          "by_name": {k: v / BATCHES for k, v in sorted(counts.items())}}),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_census: CUDA is not available", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    census(root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
