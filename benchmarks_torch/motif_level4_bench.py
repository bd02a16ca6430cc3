#!/usr/bin/env python3
"""K4 (level 4 of the fourth-order motif conv and its masked k-sum,
``nn/kernels/motif_level4.py``) on one CUDA card, against the chain of
PyTorch ops it replaced (``motif_level4_plain``, and autograd through it).

    python3 benchmarks_torch/motif_level4_bench.py [--reps N] [--out FILE]

At protein's two layers (the 500 seeded spanning trees of one train batch,
N = 50, h0 = 10 / 20) and mnist's (20 trees of its hull graphs, h0 = 20 /
50), f32, inputs drawn from N(0, 1):

  * the median device ms of one call by CUDA events behind a device-side
    spin (``chip_smoke.device_ms``): K4's forward, its backward, the plain
    chain's forward, and the chain's forward and autograd backward against
    K4's forward and backward;
  * the peak of allocated memory each adds;
  * the bound of each K4 kernel (``chip_smoke.level4_bounds``): the least
    bytes (each output element written once, each input row the trees'
    paths need read once) and operations, over the H100's 3.35 TB/s and
    67 TFLOP/s;
  * the share of the (i,j,k) on the trees' paths, M[i,j]·M[j,k] != 0;
  * the largest gap of the forward to the plain chain's, and of the
    backward to the closed form's, over the largest magnitude.

Prints one JSON line per case, then nvcc's register report of both kernels
and the card's name and power limit; with ``--out`` the same lines go to
that file too.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from snd_vae_tpu_torch import device  # noqa: E402
from snd_vae_tpu_torch.nn.kernels import build  # noqa: E402
from snd_vae_tpu_torch.nn.kernels import motif_level4 as m4  # noqa: E402

CASES = (("protein", 10), ("protein", 20), ("mnist", 20), ("mnist", 50))


def trees(dataset: str) -> torch.Tensor:
    """The preset's seeded spanning trees of one train batch, [B·S,N,N]."""
    from snd_vae_tpu_torch.config import mnist_preset, protein_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset

    cfg = {"protein": protein_preset, "mnist": mnist_preset}[dataset](
        dataset_path=str(ROOT / "build" / "dataset" / dataset))
    data = load_dataset(cfg, "train", num_graphs=cfg.train.batch_size, device="cuda")
    N = cfg.num_nodes
    return data.adj_samples.reshape(-1, N, N).float().contiguous()


def peak_added(fn) -> int:
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def case(dataset: str, h: int, reps: int) -> dict:
    mask = trees(dataset)
    T, N = mask.shape[:2]
    g = torch.Generator(device="cuda").manual_seed(h)
    draw = lambda *s: torch.randn(*s, generator=g, device="cuda")
    ts = [mask, mask, mask.sum(-1), draw(T, N, N, h), draw(T, N, N, h), draw(T, N, N, h),
          draw(T, N, h)]
    grad = draw(T, N, N, h)
    leaves = [t.clone().requires_grad_(True) for t in ts[3:]]
    kernel_fwd = lambda: m4.fused_motif_level4(*ts)
    kernel_bwd = lambda: m4.fused_motif_level4_backward(grad, *ts)
    plain_fwd = lambda: m4.motif_level4_plain(*ts)
    chain_both = lambda: torch.autograd.grad(m4.motif_level4_plain(*ts[:3], *leaves), leaves,
                                             grad)
    k4_both = lambda: torch.autograd.grad(m4.motif_level4(*ts[:3], *leaves), leaves, grad)
    with torch.no_grad():
        got, want = kernel_fwd(), plain_fwd()
        fwd_gap = float((got - want).abs().max() / want.abs().max())
        del got, want
        gaps = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(kernel_bwd(), m4.motif_level4_backward_plain(grad, *ts))]
    c = cs.level4_paths(mask)
    return {"case": f"{dataset}_h{h}", "shape": [T, N, N, h], "dtype": "float32", **c,
            "ms": {"k4_forward": cs.device_ms(kernel_fwd, reps),
                   "k4_backward": cs.device_ms(kernel_bwd, reps),
                   "plain_forward": cs.device_ms(plain_fwd, 10),
                   "k4_forward_backward": cs.device_ms(k4_both, 10),
                   "chain_forward_backward": cs.device_ms(chain_both, 10)},
            "peak_bytes": {"k4_forward": peak_added(kernel_fwd),
                           "k4_backward": peak_added(kernel_bwd),
                           "plain_forward": peak_added(plain_fwd),
                           "chain_forward_backward": peak_added(chain_both)},
            "bound": cs.level4_bounds(T, N, h, c),
            "gap": {"forward": fwd_gap, "backward": dict(zip(("pu", "alpha", "beta", "gamma"),
                                                              gaps))}}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=100)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device.full_f32()
    secs = build.build(["motif_level4", "motif_level4_backward"])
    lines = []
    for dataset, h in CASES:
        lines.append(case(dataset, h, args.reps))
        torch.cuda.empty_cache()
    report = {k: [ln for ln in build.build_log.get(k, "").splitlines()
                  if "registers" in ln or "spill" in ln] for k in build.build_log}
    lines.append({"build_s": secs, "ptxas": report})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    lines.append({"card": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    with open(args.out, "w") if args.out else open("/dev/null", "w") as f:
        for ln in lines:
            s = json.dumps(ln)
            print(s, flush=True)
            f.write(s + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
