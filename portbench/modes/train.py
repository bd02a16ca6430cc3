"""Training: one ``Trainer`` of the program, driven through ``Trainer.run``
alone, the entry the window times.

Set-up builds the trainer at the benchmark's weights and runs its first
epoch, ``Trainer.run(epochs=1)`` (the eager first step, the capture, then
replays, as every run starts).  What that call leaves is what ``correct``
compares with the reference's steps over the same batches: the epoch's mean
loss as ``run`` returns it, the optimizer's bias-corrected first moments
(its ``state_dict``) and the parameters.  It is also the warm-up's first
epoch: ``Trainer.run`` then resumes at epoch 1 for ``warmup_epochs`` more,
whose rate fixes the window's epochs.  The window is one ``Trainer.run`` of
the same trainer from epoch 0 (its checkpoints removed, as a fresh run
starts; default dispatch, its eager first step and capture inside), fenced
by ``synchronize``; with ``--trace 1`` it passes ``profile_dir`` and the
program traces its second epoch.

Parameters (``traffic/<name>.json``): ``split``, ``epoch_chunk``,
``warmup_epochs`` (at least 2).
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import tempfile
import time

import torch

from portbench import check, inputs
from portbench.drive import (Outcome, Run, TraceRefused, graphbatch, load_weights, peak_bytes,
                             port_config, reset_peak, sync, to_device)
from portbench.reference import model as ref
from portbench.traces import Trace


def snapshot(trainer, means: dict) -> dict:
    """What the trainer's first ``Trainer.run`` left: its mean loss, the
    first moments m / (1 - b1^t) from the optimizer's ``state_dict`` (zero
    for a parameter it holds no state of), and the parameters."""
    model, opt = trainer.state.model, trainer.state.optimizer
    name = {id(p): n for n, p in model.named_parameters()}
    sd = opt.state_dict()
    moments = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    for group, saved in zip(opt.param_groups, sd["param_groups"]):
        b1 = group["betas"][0]
        for p, i in zip(group["params"], saved["params"]):
            st = sd["state"].get(i)
            if st is not None:
                moments[name[id(p)]] = (st["exp_avg"] / (1 - b1 ** float(st["step"]))).clone()
    return {"loss": float(means["loss"]), "moments": moments,
            "params": {n: p.detach().clone() for n, p in model.named_parameters()}}


def drive(ctx) -> Outcome:
    from snd_vae_tpu_torch.checkpoint import checkpoint_dir
    from snd_vae_tpu_torch.train import Trainer

    cfg, tr, dev, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    B, warm, chunk = cfg["train"]["batch_size"], tr["warmup_epochs"], tr["epoch_chunk"]
    if warm < 2:
        raise ValueError("the warm-up's rate needs warmup_epochs >= 2")
    data = inputs.make_split(cfg, cfg["splits"][tr["split"]], seed, tr["split"])
    P0 = inputs.make_weights(ref.param_spec(cfg), seed, dev)
    pcfg = port_config(cfg, seed)
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        trainer = Trainer(pcfg, graphbatch(data, dev), device=dev, workdir=workdir)
        load_weights(trainer.state.model, P0)
        ctx.patch_program(trainer)
        nb = trainer.batched.adj.shape[0]
        log = os.path.join(workdir, pcfg.train.log_dir,
                           f"train_loss_{pcfg.dataset}_{pcfg.model_type}.jsonl")
        # the checked epoch, which is the warm-up's first (and, in a fresh
        # checkout, builds the kernels)
        prog = snapshot(trainer, trainer.run(epochs=1, verbose=False, epoch_chunk=chunk))
        t = time.time()
        trainer.run(epochs=1 + warm, verbose=False, epoch_chunk=chunk)
        sync(dev)
        # the window's epochs from the warm-up's rate: the wall of its epochs
        # after the capture (the program's log stamps each epoch's end), and
        # its first epoch's extra (the eager first step and the capture)
        with open(log) as f:
            stamps = [json.loads(line)["time"] for line in f]
        epoch_s = max((stamps[-1] - stamps[1]) / (warm - 1), 1e-3)
        extra = max(stamps[1] - t - epoch_s, 0.0)
        epochs = max(2, round((ctx.seconds - extra) / epoch_s))
        # the window starts from epoch 0, as a fresh run does
        shutil.rmtree(checkpoint_dir(pcfg, workdir), ignore_errors=True)
        profile_dir = os.path.join(workdir, "profile") if ctx.trace else None
        peak_setup = peak_bytes(dev)
        reset_peak(dev)
        sync(dev)
        t0 = time.perf_counter()
        ctx.setup_s = t0 - ctx.t_start
        trainer.run(epochs=epochs, verbose=False, epoch_chunk=chunk, profile_dir=profile_dir)
        sync(dev)
        wall = time.perf_counter() - t0
        peak_window = peak_bytes(dev)
        # the epochs the window trained, as the program logged them (a
        # SIGTERM ends a run early, after a checkpoint)
        with open(log) as f:
            epoch_losses = [json.loads(line)["loss"] for line in f][len(stamps):]
        epochs = len(epoch_losses)
        failed = nb * sum(not math.isfinite(v) for v in epoch_losses)
        run = None
        if ctx.trace:
            run = Run(ctx.name, "train", cfg, tr, graphs_per_unit=B,
                      peak_bytes_window=peak_window)
            with open(os.path.join(profile_dir, "trace_rank0.launches.json")) as f:
                run.launches = json.load(f)
            missing = run.launches["launches_without_device_record"]
            if missing:
                raise TraceRefused(f"the trace lacks {missing} device records of launches it "
                                   "made: refused")
            run.trace = Trace.load(os.path.join(profile_dir, "trace_rank0.json"))
            run.window = run.trace.range_window("train_epoch")
            run.units = nb
            run.trees = [data["adj_samples"][i * B:(i + 1) * B] for i in range(nb)]
        del trainer
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the reference follows the checked epoch, once the program is freed
    gen = torch.Generator(device=dev).manual_seed(seed)
    ref.set_precision(False)
    want = ref.train_steps(P0, cfg, [to_device(data, dev, i * B, B) for i in range(nb)], gen)
    numbers = check.train_numbers(prog, want, P0)
    ctx.look = check.worst_change(prog, want, P0)
    return Outcome({"trained_graphs_per_s": epochs * nb * B / wall, "setup_s": ctx.setup_s},
                   epochs * nb, failed, numbers, max(peak_setup, peak_window), run)
