"""CLI of the port: training and serving.

  python -m snd_vae_tpu_torch.cli --dataset synthetic2 --type train --epochs 100
  python -m snd_vae_tpu_torch.cli --dataset synthetic2 --type test_reconstruct
  python -m snd_vae_tpu_torch.cli --dataset synthetic2 --type sample --num-generate 100
  python -m snd_vae_tpu_torch.cli --dataset synthetic2 --model-type base --type train
  python -m snd_vae_tpu_torch.cli --dataset scene --type train     # the joint model
  python -m snd_vae_tpu_torch.cli --dataset protein --type train   # the fourth-order conv
  python -m snd_vae_tpu_torch.cli --dataset mnist --type test_reconstruct

takes every preset (synthetic1/2/3, protein, mnist, scene) with any model
type the dataset's inputs allow (scene has no spanning trees: its preset is
the joint model "base"; geoGCN and posGCN read the truth graph; protein and
mnist run the fourth-order motif conv, and mnist, like scene, has no
factors), runs on the CUDA card unless ``--device cpu`` is given and
prints one JSON dict.  ``train`` trains on the train split
(``train.Trainer``), logging under ``<workdir>/logs`` and checkpointing under
``<workdir>/checkpoints/<dataset>_<model_type>``; it resumes from the
latest checkpoint there.  The serving types restore that checkpoint (the
latest, or ``train.restore_epoch``), as ``snd_vae_tpu/cli.py:145-160``
does, and write the decoded arrays as ``.npy`` (as
``snd_vae_tpu/cli.py:480-495`` does); with no checkpoint they warn and
serve the weights drawn from the seed.  The evaluation metrics are not
ported yet.
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
from .checkpoint import Checkpointer, checkpoint_dir
from .data.loaders import load_dataset
from .device import full_f32, resolve_device
from .models import build_model
from .serve import reconstruct, sample
from .train import Trainer


def _save(dirpath: str, arrays: Dict[str, torch.Tensor]) -> None:
    os.makedirs(dirpath, exist_ok=True)
    for name, t in arrays.items():
        np.save(os.path.join(dirpath, f"{name}.npy"),
                t.detach().to("cpu", torch.float32).numpy())


def restore_for_serving(cfg, workdir: str, device) -> torch.nn.Module:
    """The model of ``cfg`` with the trained weights of the latest
    checkpoint (or of ``cfg.train.restore_epoch``), cast to
    ``cfg.compute_dtype``; without a checkpoint, the seed's weights and a
    WARNING on stderr."""
    model = build_model(cfg, device)
    ck = Checkpointer(checkpoint_dir(cfg, workdir))
    if ck.latest_step() is None:
        print(f"WARNING: no checkpoint under {ck.directory}; serving an untrained model "
              f"drawn from seed {cfg.train.seed} (run --type train first)",
              file=sys.stderr, flush=True)
    else:
        model.load_state_dict(ck.load(cfg.train.restore_epoch)["model"])
    return model


def run_train(cfg, workdir: str, device, epochs=None) -> Dict:
    trainer = Trainer(cfg, load_dataset(cfg, "train", device=device), device=device,
                      workdir=workdir)
    return trainer.run(epochs)


def run_test_reconstruct(cfg, model, workdir: str) -> Dict:
    """Posterior-mean reconstruction of the test split (scene: val) in
    batches of ``cfg.train.batch_size``; writes the decoded graphs and the
    latent means (z_sg averaged over the trees, as the reference does; the
    joint model has z_sg only)."""
    batch = load_dataset(cfg, "test", device=model.device)
    B = cfg.train.batch_size
    outs, stats = [], []
    for i in range(max(batch.batch_size // B, 1)):
        out = reconstruct(model, batch.slice_batch(i * B, B))
        outs.append(out.decoded)
        stats.append({"z_sg": out.stats.mean_sg.mean(dim=1), "z_s": out.stats.mean_s,
                      "z_g": out.stats.mean_g})
    cat = lambda name: torch.cat([getattr(o, name) for o in outs])
    rec_dir = os.path.join(workdir, "reconstructed", f"{cfg.dataset}_{cfg.model_type}")
    _save(rec_dir, {"adj": cat("adj"), "coords": cat("coords"),
                    "node_feat": cat("node_feat")})
    vt = cfg.model_type
    _save(os.path.join(workdir, "qualitative_evaluation", cfg.dataset),
          {f"{vt}_{k}": torch.cat([s[k] for s in stats]) for k in ("z_sg", "z_s", "z_g")
           if stats[0][k] is not None})
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
    p = argparse.ArgumentParser(description="SND-VAE training and serving on PyTorch/CUDA")
    p.add_argument("--dataset", default="synthetic2", choices=list(cfg_mod.PRESETS))
    p.add_argument("--model-type", default=None, choices=list(cfg_mod.MODEL_TYPES))
    p.add_argument("--type", default="train", choices=["train", "test_reconstruct", "sample"])
    p.add_argument("--epochs", type=int, default=None,
                   help="epochs to train up to (default: the preset's)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain versions)")
    p.add_argument("--num-generate", type=int, default=None, dest="num_generate",
                   help="graphs to sample with --type sample (default: batch_size)")
    p.add_argument("--bf16", action="store_true",
                   help="compute in bfloat16 (training keeps f32 master weights)")
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
    full_f32()
    device = resolve_device(args.device)
    if args.type == "train":
        out = run_train(cfg, args.workdir, device, args.epochs)
    else:
        model = restore_for_serving(cfg, args.workdir, device)
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
