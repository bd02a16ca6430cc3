"""CLI of the port: training, serving and evaluation.

  python -m snd_vae_tpu_torch.cli --dataset synthetic2 --type train --epochs 100
  python -m snd_vae_tpu_torch.cli --dataset synthetic2 --type train --eval-every 10
  python -m snd_vae_tpu_torch.cli --dataset synthetic2 --type train --epochs 2 --profile
  python -m snd_vae_tpu_torch.cli --dataset synthetic2 --type train --epochs 100 --epoch-chunk 10
  python -m snd_vae_tpu_torch.cli --dataset synthetic2 --type train --per-step
  python -m snd_vae_tpu_torch.cli --dataset synthetic2 --type test_reconstruct
  python -m snd_vae_tpu_torch.cli --dataset synthetic2 --type test_generation
  python -m snd_vae_tpu_torch.cli --dataset synthetic2 --type test_disentangle --traverse-mode single
  python -m snd_vae_tpu_torch.cli --dataset synthetic2 --type sweep --epochs 10
  python -m snd_vae_tpu_torch.cli --dataset synthetic2 --type sample --num-generate 100
  python -m snd_vae_tpu_torch.cli --dataset synthetic2 --model-type base --type train
  python -m snd_vae_tpu_torch.cli --dataset scene --type train     # the joint model
  python -m snd_vae_tpu_torch.cli --dataset protein --type train --remat
  python -m snd_vae_tpu_torch.cli --dataset mnist --type test_reconstruct
  torchrun --nproc_per_node 4 -m snd_vae_tpu_torch.cli --type train --dp 4 --distributed
  torchrun --nproc_per_node 2 -m snd_vae_tpu_torch.cli --type train --dp 2 --distributed \
      --device cpu
  torchrun --nproc_per_node 2 -m snd_vae_tpu_torch.cli --type train --tp 2 --distributed
  torchrun --nproc_per_node 4 -m snd_vae_tpu_torch.cli --type train --dp 2 --tp 2 --distributed

takes every preset (synthetic1/2/3, protein, mnist, scene) with any model
type the dataset's inputs allow (scene has no spanning trees: its preset is
the joint model "base"; geoGCN and posGCN read the truth graph; protein and
mnist run the fourth-order motif conv, and mnist, like scene, has no
factors), runs on the CUDA card unless ``--device cpu`` is given and
prints one JSON dict (``test_disentangle``: the path of the figure it drew).

  * ``train`` trains on the train split (``train.Trainer``), logging under
    ``<workdir>/logs`` (with the resolved config as
    ``config_<dataset>_<model_type>.json``) and checkpointing under
    ``<workdir>/checkpoints/<dataset>_<model_type>``; it resumes from the
    latest checkpoint there.  ``--eval-every k`` scores the test split every
    k epochs and keeps the best checkpoint by ``--best-metric``.
    On the card, in one process and under any mesh (``--dp``, ``--tp``),
    each step after the first is a replay of a CUDA graph (under a mesh
    with its NCCL collectives), with one host sync an epoch, or one a
    chunk of ``--epoch-chunk`` epochs; ``--per-step`` takes one eager step
    a batch, as the CPU does.  ``--profile`` writes a ``torch.profiler``
    trace of the second epoch on that dispatch (its replays, or its eager
    steps under ``--per-step``) to ``<workdir>/profile/trace_rank<r>.json``
    and, beside it, ``trace_rank<r>.launches.json``: the eager kernel
    launches, the graph's replays and the kernels and copies each runs, and
    how many device records the trace lacks (``Trainer.run``).  It also
    stamps every step on the card's clock (``spans``), and at the run's end
    adds to that file each span's median ms a step of the traced epoch
    (forward, backward, optimizer, the motif-conv stack, the adjacency
    head), the run's host spans (``Trainer.counters``) and the stamps a
    replay runs.
  * The other types restore that checkpoint (the latest, or
    ``train.restore_epoch``), as ``snd_vae_tpu/cli.py:145-160`` does; with
    none they warn and use the weights drawn from the seed.
    ``test_reconstruct`` decodes the test split (scene: val), writes the
    decoded arrays and the latent means, and returns
    ``evaluate.reconstruct_evaluation`` (and ``disentangle_evaluation``
    where the split has factors), and draws
    ``<workdir>/figures/reconstruct_<dataset>.png`` (5 graphs above their
    reconstructions) and, for a disentangled model on a split with factors,
    ``figures/latent_<dataset>.png`` (the latents' PCA per factor), as
    ``snd_vae_tpu/cli.py:203-223`` does.  ``test_generation`` decodes 100
    graphs from the prior and returns ``generation_evaluation`` against the
    test split.  ``test_disentangle`` decodes a latent-traversal grid
    (``models/traversal.py``) from the latents ``test_reconstruct`` wrote,
    saves it as ``.npy`` (adj, node_feat × 120, coords × 600) under
    ``<workdir>/traverse/<dataset>_<model_type>``, draws it as
    ``figures/traverse_<dataset>.png`` and returns that path.
    ``sweep`` trains, then runs test_reconstruct and test_generation.
    ``sample`` writes decoded prior samples.

``--distributed`` joins the processes ``torchrun`` started into one
process group (``parallel.initialize_distributed``: NCCL on the card, one
card per process; gloo with ``--device cpu``) and prints ``distributed:
process i/n``.  ``--dp k`` then trains data parallel over k processes
(``train.Trainer``; ``--dp k`` needs a world of k), as the JAX CLI's
``--dp`` does, and ``--tp m`` over the mesh's model axis (tensor-parallel
parameters, node-sharded activations; ``--dp d --tp m`` needs a world of
d·m).  The serving and evaluation types run in each process alone.

The figures are drawn by ``visualize.py`` (the JAX module's functions on a
numpy raster, no matplotlib).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import config as cfg_mod
from .checkpoint import Checkpointer, checkpoint_dir
from .config import Config
from .data.loaders import load_dataset
from .device import full_f32, resolve_device
from .evaluate import (
    disentangle_evaluation, edge_presence_scores, generation_evaluation,
    reconstruct_evaluation,
)
from .models import JointSNDVAE, build_model
from .models import traversal as trav
from .parallel import initialize_distributed
from .serve import reconstruct, sample
from .train import Trainer
from .visualize import visualize_latent_embedding, visualize_reconstruct, visualize_traverse


def _save(dirpath: str, arrays: Dict[str, torch.Tensor]) -> None:
    os.makedirs(dirpath, exist_ok=True)
    for name, t in arrays.items():
        np.save(os.path.join(dirpath, f"{name}.npy"),
                t.detach().to("cpu", torch.float32).numpy())


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def build_cfg(args) -> Config:
    """The preset of ``--dataset`` with the flags applied, in the JAX CLI's
    order (``snd_vae_tpu/cli.py:43-105``): ``--quality`` after the other
    knobs, then ``--beta`` again, so an explicit beta wins."""
    cfg = cfg_mod.preset(args.dataset)
    over = {}
    if args.model_type:
        over["model_type"] = args.model_type
    train_over = {k: getattr(args, k) for k in ("resample_trees_every", "eval_every")
                  if getattr(args, k)}
    if args.best_metric:
        train_over["best_metric"] = args.best_metric
    if train_over:
        over["train"] = dataclasses.replace(cfg.train, **train_over)
    if args.dataset_path:
        over["dataset_path"] = args.dataset_path
    if over:
        cfg = cfg.with_(**over)
    if args.beta is not None:
        cfg = cfg.with_(loss=dataclasses.replace(cfg.loss, beta=args.beta))
    if args.bf16:
        cfg = cfg.with_(compute_dtype="bfloat16")
    if args.remat:
        cfg = cfg.with_(remat=True)
    if args.remat_policy:
        cfg = cfg.with_(remat=True, remat_policy=args.remat_policy)
    if args.motif_block_rows:
        cfg = cfg.with_(motif_block_rows=args.motif_block_rows)
    if args.coord_activation != "auto":
        cfg = cfg.with_(decoder=dataclasses.replace(
            cfg.decoder, coord_activation=args.coord_activation))
    if args.pairing_skew:
        cfg = cfg.with_(reproduce_pairing_skew=True)
    if args.normalize_coords:
        cfg = cfg.with_(normalize_coords=True)
    if args.dp != 1 or args.tp != 1:
        cfg = cfg.with_(mesh=cfg_mod.MeshConfig(data=args.dp, model=args.tp))
    if args.scene_node_loss:
        cfg = cfg.with_(loss=dataclasses.replace(cfg.loss, scene_node_loss=True))
    latents = {k: getattr(args, k) for k in ("s_latent_size", "g_latent_size", "sg_latent_size")
               if getattr(args, k) is not None}
    if latents:
        cfg = cfg.with_(encoder=dataclasses.replace(cfg.encoder, **latents))
    if args.quality:
        cfg = cfg_mod.apply_quality_overrides(cfg)
        if args.beta is not None:
            cfg = cfg.with_(loss=dataclasses.replace(cfg.loss, beta=args.beta))
    return cfg


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


def run_train(cfg, workdir: str, device, epochs=None, profile: bool = False,
              per_step: bool = False, epoch_chunk: int = 1) -> Dict:
    """Train, after writing the resolved config as JSON beside the logs;
    with ``eval_every`` > 0 the test split is the held-out batch; with
    ``profile``, a trace of the second epoch under ``<workdir>/profile``;
    ``per_step`` and ``epoch_chunk`` pick ``Trainer.run``'s dispatch."""
    cfg_path = os.path.join(workdir, cfg.train.log_dir,
                            f"config_{cfg.dataset}_{cfg.model_type}.json")
    os.makedirs(os.path.dirname(cfg_path), exist_ok=True)
    with open(cfg_path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
    eval_batch = load_dataset(cfg, "test", device=device) if cfg.train.eval_every > 0 else None
    trainer = Trainer(cfg, load_dataset(cfg, "train", device=device), device=device,
                      workdir=workdir, eval_batch=eval_batch)
    return trainer.run(epochs, per_step=per_step,
                       profile_dir=os.path.join(workdir, "profile") if profile else None,
                       epoch_chunk=epoch_chunk)


def run_test_reconstruct(cfg, model, workdir: str) -> Tuple[Dict[str, float], Dict]:
    """Posterior-mean reconstruction of the test split (scene: val) in
    batches of ``cfg.train.batch_size``; writes the decoded graphs and the
    latent means (z_sg averaged over the trees, as the reference does; the
    joint model has z_sg only) and draws the figures.  Returns the metrics
    (the JAX CLI's keys) and what was written."""
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
    z = {k: torch.cat([s[k] for s in stats]) for k in ("z_sg", "z_s", "z_g")
         if stats[0][k] is not None}
    _save(os.path.join(workdir, "qualitative_evaluation", cfg.dataset),
          {f"{vt}_{k}": v for k, v in z.items()})

    gen_adj = _host(cat("adj"))
    n = len(gen_adj)
    results = reconstruct_evaluation(
        gen_adj, _host(cat("node_feat")), _host(cat("coords")), _host(batch.adj)[:n],
        _host(batch.features)[:n], _host(batch.coords)[:n], cfg.dataset,
        adj_scores=edge_presence_scores(_host(cat("adj_prob").double())),
        node_categorical=outs[0].node_feat_prob is not None)
    figures = os.path.join(workdir, "figures")
    if batch.factors is not None and "z_s" in z:
        results.update(disentangle_evaluation(
            _host(z["z_s"]), _host(z["z_g"]), _host(z["z_sg"]), _host(batch.factors)[:n],
            cfg.dataset))
        z_all = np.concatenate([_host(z[k]) for k in ("z_s", "z_g", "z_sg")], axis=1)
        visualize_latent_embedding(
            z_all, _host(batch.factors)[:len(z_all)],
            save_path=os.path.join(figures, f"latent_{cfg.dataset}.png"))
    visualize_reconstruct(
        5, _host(batch.adj), _host(batch.features), _host(batch.coords), gen_adj,
        _host(cat("node_feat")), _host(cat("coords")),
        save_path=os.path.join(figures, f"reconstruct_{cfg.dataset}.png"))
    return results, {"num_reconstructed": n, "dir": rec_dir,
                     "adj_shape": list(gen_adj.shape)}


def run_test_generation(cfg, model, num_generate: Optional[int] = None) -> Dict[str, float]:
    """``num_generate`` graphs (default max(100, batch_size)) decoded from
    the prior in chunks of max(batch_size, 25), drawn from one generator
    seeded with seed + 1, scored by ``generation_evaluation`` against the
    test split (``snd_vae_tpu/cli.py:214-244``)."""
    batch = load_dataset(cfg, "test", device=model.device)
    num = num_generate or max(100, cfg.train.batch_size)
    chunk = min(num, max(cfg.train.batch_size, 25))
    gen = torch.Generator(device=model.device).manual_seed(cfg.train.seed + 1)
    decoded = [sample(model, chunk, gen) for _ in range((num + chunk - 1) // chunk)]
    cat = lambda name: _host(torch.cat([getattr(d, name) for d in decoded]))[:num]
    return generation_evaluation(
        cat("adj"), cat("node_feat"), cat("coords"), _host(batch.adj),
        _host(batch.features), _host(batch.coords), cfg.dataset)


def run_test_disentangle(cfg, model, workdir: str, mode: str = "generation",
                         group: str = "sg", dim: int = 0) -> str:
    """Decode a latent-traversal grid from the latents test_reconstruct
    saved (``snd_vae_tpu/cli.py:247-311``), save it under
    ``<workdir>/traverse/<dataset>_<model_type>`` and draw it as
    ``<workdir>/figures/traverse_<dataset>.png``; returns the figure's path.
    ``mode``: ``generation`` (the three-group sweep), ``single`` (dimension
    ``dim`` of ``group``) or ``latent`` (every dimension); the joint model
    always sweeps dimension ``dim`` of its one latent."""
    qdir = os.path.join(workdir, "qualitative_evaluation")
    V, dev = cfg.visualize_length, model.device
    if isinstance(model, JointSNDVAE):
        z_sg = np.load(os.path.join(qdir, cfg.dataset, f"{cfg.model_type}_z_sg.npy"))
        latents = trav.traverse_joint(cfg, z_sg, dim, device=dev)
        # only the swept block is decoded; the other rows are the anchors
        d = min(dim, cfg.encoder.sg_latent_size - 1)
        latents.z_sg = latents.z_sg[d * V: d * V + V]
        rows = 1
    else:
        z_s, z_g, z_sg = trav.load_saved_latents(cfg, qdir, cfg.model_type)
        if mode == "generation":
            latents, rows = trav.traverse_generation(cfg, z_s, z_g, z_sg, device=dev), 3
        elif mode == "single":
            latents, rows = trav.traverse(cfg, z_s, z_g, z_sg, group, dim, device=dev), 1
        elif mode == "latent":
            enc = cfg.encoder
            latents = trav.traverse_latent(cfg, z_s, z_g, z_sg, device=dev)
            rows = enc.s_latent_size + enc.g_latent_size + enc.sg_latent_size
        else:
            raise ValueError(f"unknown traverse mode {mode!r}")
    cast = lambda z: None if z is None else z.to(model.dtype)
    with torch.inference_mode():
        decoded = model.decode(type(latents)(z_sg=cast(latents.z_sg), z_s=cast(latents.z_s),
                                             z_g=cast(latents.z_g)))
    out_dir = os.path.join(workdir, "traverse", f"{cfg.dataset}_{cfg.model_type}")
    # denormalized as the reference's figure is (main.py:492-497); grid.json
    # holds the rows and V that lay the grid out as that figure does
    grid = {"adj": decoded.adj, "node_feat": decoded.node_feat * 120,
            "coords": decoded.coords * 600}
    _save(out_dir, grid)
    with open(os.path.join(out_dir, "grid.json"), "w") as f:
        json.dump({"mode": mode if cfg.is_disentangled else "joint", "rows": rows,
                   "visualize_length": V}, f)
    path = os.path.join(workdir, "figures", f"traverse_{cfg.dataset}.png")
    visualize_traverse(*(_host(grid[k].float()) for k in ("adj", "node_feat", "coords")),
                       rows, V, cfg.dataset, save_path=path)
    return path


def run_sample(cfg, model, workdir: str, num: int) -> Dict:
    gen = torch.Generator(device=model.device).manual_seed(cfg.train.seed)
    decoded = sample(model, num, gen)
    gen_dir = os.path.join(workdir, "generated", f"{cfg.dataset}_{cfg.model_type}")
    _save(gen_dir, {"adj": decoded.adj, "coords": decoded.coords,
                    "node_feat": decoded.node_feat})
    return {"num_generated": int(num), "dir": gen_dir,
            "adj_shape": list(decoded.adj.shape)}


def run_sweep(cfg, workdir: str, device, epochs=None) -> Dict:
    """The reference's __main__ sweep (main.py:502-525): train, then
    test_reconstruct and test_generation of the trained model."""
    run_train(cfg, workdir, device, epochs)
    model = restore_for_serving(cfg, workdir, device)
    return {"generation": {cfg.model_type: run_test_generation(cfg, model)},
            "reconstruct": {cfg.model_type: run_test_reconstruct(cfg, model, workdir)[0]}}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="SND-VAE training, serving and evaluation on PyTorch/CUDA")
    p.add_argument("--dataset", default="synthetic2", choices=list(cfg_mod.PRESETS))
    p.add_argument("--model-type", default=None, choices=list(cfg_mod.MODEL_TYPES))
    p.add_argument("--type", default="train", choices=[*cfg_mod.RUN_TYPES, "sweep"])
    p.add_argument("--epochs", type=int, default=None,
                   help="epochs to train up to (default: the preset's)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain versions)")
    p.add_argument("--num-generate", type=int, default=None, dest="num_generate",
                   help="graphs to generate with --type sample (default: batch_size) "
                        "or --type test_generation (default: 100)")
    p.add_argument("--bf16", action="store_true",
                   help="compute in bfloat16 (training keeps f32 master weights)")
    p.add_argument("--dataset-path", default=None)
    p.add_argument("--workdir", default=".")
    p.add_argument("--beta", type=float, default=None)
    p.add_argument("--quality", action="store_true",
                   help="the per-dataset quality operating point "
                        "(config.apply_quality_overrides); explicit --beta still wins")
    p.add_argument("--remat", action="store_true",
                   help="recompute the motif convs and the adjacency head in the backward "
                        "(torch.utils.checkpoint)")
    p.add_argument("--remat-policy", default=None, dest="remat_policy",
                   choices=["recompute-big", "dots-no-batch"],
                   help="selective remat policy (implies --remat; see nn/ckpt.py)")
    p.add_argument("--motif-block-rows", type=int, default=None, dest="motif_block_rows",
                   help="compute the motif convs' pairwise tensors one i-row block of "
                        "this size at a time (must divide num_nodes)")
    p.add_argument("--resample-trees-every", type=int, default=0,
                   dest="resample_trees_every",
                   help="re-draw the spanning-tree samples every k epochs (0: never)")
    p.add_argument("--pairing-skew", action="store_true", dest="pairing_skew",
                   help="reproduce the reference's spanning-tree / feature pairing skew")
    p.add_argument("--s-latent-size", type=int, default=None, dest="s_latent_size")
    p.add_argument("--g-latent-size", type=int, default=None, dest="g_latent_size")
    p.add_argument("--sg-latent-size", type=int, default=None, dest="sg_latent_size")
    p.add_argument("--scene-node-loss", action="store_true", dest="scene_node_loss",
                   help="train scene's shape head with categorical cross-entropy")
    p.add_argument("--normalize-coords", action="store_true", dest="normalize_coords",
                   help="map coordinates into the unit box by the train split's bounds")
    p.add_argument("--coord-activation", default="auto", dest="coord_activation",
                   choices=["auto", "linear", "sigmoid"])
    p.add_argument("--eval-every", type=int, default=0, dest="eval_every",
                   help="score the test split every k epochs of training and keep the "
                        "best checkpoint by --best-metric (0: never)")
    p.add_argument("--best-metric", default=None, dest="best_metric",
                   help="held-out metric of the best checkpoint (default edge_auc; a "
                        "leading '-' minimizes, e.g. -spatial_mse)")
    p.add_argument("--traverse-mode", default="generation", dest="traverse_mode",
                   choices=["generation", "single", "latent"],
                   help="test_disentangle's grid: the three-group sweep, one dimension "
                        "of one group, or every dimension")
    p.add_argument("--traverse-group", default="sg", dest="traverse_group",
                   choices=["s", "g", "sg"], help="the group of --traverse-mode single")
    p.add_argument("--traverse-dim", type=int, default=0, dest="traverse_dim",
                   help="the dimension of --traverse-mode single and of the joint "
                        "model's sweep")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel mesh size: train over this many processes, each "
                        "on its block of every batch (needs --distributed); on the card "
                        "the step replays as a CUDA graph with its NCCL collectives "
                        "unless --per-step")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel mesh size: shard the big parameters and the node "
                        "axis of the big activations over this many processes (needs "
                        "--distributed; --dp d --tp m needs d*m processes); dispatched as "
                        "--dp is")
    p.add_argument("--per-step", action="store_true", dest="per_step",
                   help="one eager step a batch instead of the default dispatch (on the "
                        "card, with or without a mesh, CUDA-graph replays of the step, the "
                        "counterpart of the epoch scan)")
    p.add_argument("--epoch-chunk", type=int, default=1, dest="epoch_chunk",
                   help="epochs per host sync of the default dispatch, with or without a "
                        "mesh (ignored under --per-step and --profile)")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of the second epoch of --type train "
                        "on the run's dispatch (replays, or eager steps under --per-step) "
                        "to <workdir>/profile/trace_rank<r>.json, and its expected and "
                        "missing device records to trace_rank<r>.launches.json; stamp every "
                        "step, and at the run's end add to that file each span's median ms "
                        "a step in the traced epoch (spans), the run's host spans "
                        "(counters) and stamps_per_replay")
    p.add_argument("--distributed", action="store_true",
                   help="join the processes torchrun started into one process group "
                        "(NCCL on the card, gloo with --device cpu)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = build_cfg(args)
    full_f32()
    device = resolve_device(args.device)
    joined = args.distributed and not dist.is_initialized()
    if args.distributed:
        rank = initialize_distributed(device=device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        print(f"distributed: process {rank}/{dist.get_world_size()}", flush=True)
    try:
        out = _run(args, cfg, device)
    finally:
        if joined:
            dist.destroy_process_group()
    print(out if isinstance(out, str) else json.dumps(out))
    return out


def _run(args, cfg, device):
    if args.type == "train":
        out = dict(run_train(cfg, args.workdir, device, args.epochs, args.profile,
                             args.per_step, args.epoch_chunk),
                   device=str(device))
    elif args.type == "sweep":
        out = run_sweep(cfg, args.workdir, device, args.epochs)
    else:
        model = restore_for_serving(cfg, args.workdir, device)
        if args.type == "test_reconstruct":
            metrics, written = run_test_reconstruct(cfg, model, args.workdir)
            out = dict(metrics, **written, device=str(device))
        elif args.type == "test_generation":
            out = run_test_generation(cfg, model, args.num_generate)
        elif args.type == "test_disentangle":
            out = run_test_disentangle(cfg, model, args.workdir, args.traverse_mode,
                                       args.traverse_group, args.traverse_dim)
        else:
            out = dict(run_sample(cfg, model, args.workdir,
                                  args.num_generate or cfg.train.batch_size),
                       device=str(device))
    return out


if __name__ == "__main__":
    main()
