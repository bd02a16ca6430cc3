"""Serving CLI of the port.

  python -m snd_vae_tpu_torch.cli --dataset synthetic2 --type sample --num-generate 100
  python -m snd_vae_tpu_torch.cli --dataset synthetic2 --type test_reconstruct

runs on the CUDA card unless ``--device cpu`` is given, writes the decoded
arrays as ``.npy`` (as ``snd_vae_tpu/cli.py:480-495`` does) and prints one
JSON dict.  Checkpoint restore and the evaluation metrics come with the
training slice; until then the weights are drawn from the seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import numpy as np
import torch

from . import config as cfg_mod
from .data.loaders import load_dataset
from .device import resolve_device
from .models import build_model
from .serve import reconstruct, sample


def _save(dirpath: str, arrays: Dict[str, torch.Tensor]) -> None:
    os.makedirs(dirpath, exist_ok=True)
    for name, t in arrays.items():
        np.save(os.path.join(dirpath, f"{name}.npy"),
                t.detach().to("cpu", torch.float32).numpy())


def run_test_reconstruct(cfg, model, workdir: str) -> Dict:
    """Posterior-mean reconstruction of the test split in batches of
    ``cfg.train.batch_size``; writes the decoded graphs and the latent
    means (z_sg averaged over the trees, as the reference does)."""
    batch = load_dataset(cfg, "test", device=model.device)
    B = cfg.train.batch_size
    outs, zs, zgs, zsgs = [], [], [], []
    for i in range(max(batch.batch_size // B, 1)):
        out = reconstruct(model, batch.slice_batch(i * B, B))
        outs.append(out.decoded)
        zs.append(out.stats.mean_s)
        zgs.append(out.stats.mean_g)
        zsgs.append(out.stats.mean_sg.mean(dim=1))
    cat = lambda name: torch.cat([getattr(o, name) for o in outs])
    rec_dir = os.path.join(workdir, "reconstructed", f"{cfg.dataset}_{cfg.model_type}")
    _save(rec_dir, {"adj": cat("adj"), "coords": cat("coords"),
                    "node_feat": cat("node_feat")})
    vt = cfg.model_type
    _save(os.path.join(workdir, "qualitative_evaluation", cfg.dataset),
          {f"{vt}_z_sg": torch.cat(zsgs), f"{vt}_z_s": torch.cat(zs),
           f"{vt}_z_g": torch.cat(zgs)})
    return {"num_reconstructed": len(outs) * B, "dir": rec_dir,
            "adj_shape": list(cat("adj").shape)}


def run_sample(cfg, model, workdir: str, num: int) -> Dict:
    gen = torch.Generator(device=model.device).manual_seed(cfg.train.seed)
    decoded = sample(model, num, gen)
    gen_dir = os.path.join(workdir, "generated", f"{cfg.dataset}_{cfg.model_type}")
    _save(gen_dir, {"adj": decoded.adj, "coords": decoded.coords,
                    "node_feat": decoded.node_feat})
    return {"num_generated": int(num), "dir": gen_dir,
            "adj_shape": list(decoded.adj.shape)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SND-VAE serving on PyTorch/CUDA")
    p.add_argument("--dataset", default="synthetic2", choices=list(cfg_mod.PRESETS))
    p.add_argument("--model-type", default=None, choices=list(cfg_mod.MODEL_TYPES))
    p.add_argument("--type", default="sample", choices=["test_reconstruct", "sample"])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain versions)")
    p.add_argument("--num-generate", type=int, default=None, dest="num_generate",
                   help="graphs to sample with --type sample (default: batch_size)")
    p.add_argument("--bf16", action="store_true", help="serve in bfloat16")
    p.add_argument("--dataset-path", default=None)
    p.add_argument("--workdir", default=".")
    return p


def main(argv=None) -> Dict:
    args = build_parser().parse_args(argv)
    cfg = cfg_mod.preset(args.dataset)
    if args.model_type:
        cfg = cfg.with_(model_type=args.model_type)
    if args.dataset_path:
        cfg = cfg.with_(dataset_path=args.dataset_path)
    if args.bf16:
        cfg = cfg.with_(compute_dtype="bfloat16")
    device = resolve_device(args.device)
    print(f"WARNING: checkpoint restore is not ported yet; serving weights "
          f"drawn from seed {cfg.train.seed}", file=sys.stderr, flush=True)
    model = build_model(cfg, device)
    if args.type == "test_reconstruct":
        out = run_test_reconstruct(cfg, model, args.workdir)
    else:
        out = run_sample(cfg, model, args.workdir,
                         args.num_generate or cfg.train.batch_size)
    out["device"] = str(device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
