"""Training: the optimizers, the train step and the epoch loop — the port
of ``snd_vae_tpu/train.py:49-154``, ``:193-289`` and ``:317-608``.

  * ``make_optimizer``: "adam" is ``torch.optim.Adam`` (its step
    lr/(1-b1^t)·m/(√v/√(1-b2^t) + eps) is optax.adam's m̂/(√v̂ + eps));
    "tf1-adam" is ``TF1Adam``, TF1's formulation with eps outside the bias
    correction.
  * ``train_step(state, batch, global_iter, eps=None)``: forward (either
    model family; dropout at ``cfg.train.dropout_keep_prob`` from the
    state's generator, which only the joint model applies), ELBO (in f32),
    the edge accuracy, backward, optimizer step.  The master
    parameters and the optimizer state are f32; with
    ``cfg.compute_dtype = "bfloat16"`` the forward runs on bf16 casts of
    every float parameter and batch tensor (``torch.func.functional_call``),
    so the gradients reach the f32 masters through the casts — what the JAX
    ``_compute_cast`` does, op for op, unlike ``torch.autocast``, which picks
    a precision per op.
  * ``Trainer(cfg, batch, device=...).run(epochs)``: contiguous batches,
    global_iter = epoch, one host sync per epoch (the per-step aux values
    stay on the device until the epoch ends), checkpoints every
    ``checkpoint_every`` epochs and resume at the saved epoch + 1, a
    SIGTERM/SIGINT trap that checkpoints and stops, the spanning-tree
    resampling and the per-epoch reshuffle of corrected mode; with
    ``profile_dir``, a ``torch.profiler`` trace of the second epoch.

  * With ``eval_every = k`` > 0 and an ``eval_batch``, every k-th epoch
    ``evaluate_heldout`` scores the held-out split (posterior-mean
    reconstruction, ``evaluate.reconstruct_evaluation``), the scores go to
    ``val_loss_<dataset>_<model_type>.txt`` and the best checkpoint by
    ``best_metric`` to ``<checkpoint_dir>_best`` with its score in
    ``best.json``, read back on resume (``snd_vae_tpu/train.py:351-518``).

  * Data parallel (``cfg.mesh.data`` > 1, or a ``mesh`` passed; the JAX
    ``Trainer``'s mesh, ``snd_vae_tpu/train.py:355-450``): one process per
    card, joined by ``parallel.initialize_distributed``.  Every process
    builds the same model, takes rank 0's weights (``shard_params``), holds
    the whole train split and steps on its block of each global batch
    (``rebatch``, then ``shard_graphbatch``).  The step runs under the mesh
    (``hints.use_mesh``), where every quantity that reads the whole batch is
    taken over the global batch (``parallel/batch.py``), and averages the
    gradients over the ranks in one flattened all-reduce before the
    optimizer step: the step equals the single-process step on the global
    batch.  Rank 0 alone writes logs, checkpoints and ``best.json`` and
    evaluates the held-out split; every rank resumes from the checkpoint.

  * The mesh's ``model`` axis (``cfg.mesh.model`` > 1, or a ``mesh`` with
    one; JAX ``train.py:366-371`` and the hints it turns on,
    ``:413-419``): every parameter that ``parallel.param_shardings`` shards
    becomes its model rank's slice (``parallel.tensor_parallel``), so its
    Adam moments live on that rank too, and the big activations' node axis
    is split over the model ranks (``parallel.hints``; the convs, the
    adjacency head and the loss compute on each rank's rows).  A
    replicated parameter's gradient is summed over the model ranks (each
    saw only its rows) and a slice's over the model ranks by the backward
    of its all-gather; both are then averaged over the data ranks and
    divided by the model axis's size, as every rank computes the same
    loss.  The step equals the single-process step.  Checkpoints hold
    whole tensors in the unsharded layout, gathered by every rank and
    written by rank 0, so a run resumes on any mesh or in one process.
    The held-out split is scored by the model ranks of data rank 0
    together, under the model axis (JAX's ``_mesh_scope``).

The JAX trainer's ``scan_unroll``, ``epoch_chunk`` and ``max_dispatch_s``
shape how XLA dispatches an epoch and have no counterpart here.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, replace
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.func import functional_call
from torch.nn.utils import parametrize
from torch.profiler import ProfilerActivity, profile, record_function, schedule

from .checkpoint import Checkpointer, checkpoint_dir, checkpoint_payload
from .config import Config
from .data.graphbatch import GraphBatch
from .data.spanning_tree import sample_spanning_trees
from .device import DeviceLike, dtype_of, full_f32, resolve_device
from .evaluate import edge_presence_scores, reconstruct_evaluation
from .losses import elbo_loss
from .models import Latents, Model, build_model
from .models.outputs import whole_decoded
from .parallel.batch import average_gradients, global_sum, model_sum
from .parallel.distributed import is_primary
from .parallel.hints import shard_nodes, use_mesh
from .parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_size, mesh_from_config, \
    shard_graphbatch, shard_params
from .parallel.tensor_parallel import canonical_parameters, slices
from .serve import reconstruct
from .utils.logging import LossesLogger, epoch_means

# how long the profiler's discarded warm-up step keeps the device busy
# before a --profile trace starts
TRACE_WARMUP_S = 0.02


@dataclass
class TrainState:
    """What one step reads and updates: the run's config (its
    ``compute_dtype`` is the forward's), the model holding the f32 master
    parameters, the optimizer, the generator of the ε stream (on the
    model's device), the count of steps taken and the mesh (None: one
    process)."""

    cfg: Config
    model: Model
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0
    mesh: Optional[DeviceMesh] = None


class TF1Adam(torch.optim.Optimizer):
    """Adam in TF1's formulation (``tf.train.AdamOptimizer``, the JAX
    ``tf1_adam``):

        lr_t = lr · √(1 - b2^t) / (1 - b1^t)
        w   -= lr_t · m_t / (√v_t + eps)

    eps is added outside the bias correction.  lr_t is computed in float32,
    as the JAX package computes it from its float32 step count."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @staticmethod
    def step_size(lr: float, b1: float, b2: float, t: int) -> float:
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        tt = f32(float(t))
        return float(f32(lr) * torch.sqrt(1 - f32(b2) ** tt) / (1 - f32(b1) ** tt))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            by_t = defaultdict(list)
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                by_t[st["step"]].append(p)
            for t, params in by_t.items():
                grads = [p.grad for p in params]
                ms = [self.state[p]["exp_avg"] for p in params]
                vs = [self.state[p]["exp_avg_sq"] for p in params]
                torch._foreach_mul_(ms, b1)
                torch._foreach_add_(ms, grads, alpha=1 - b1)
                torch._foreach_mul_(vs, b2)
                torch._foreach_addcmul_(vs, grads, grads, value=1 - b2)
                denom = torch._foreach_sqrt(vs)
                torch._foreach_add_(denom, group["eps"])
                torch._foreach_addcdiv_(params, ms, denom,
                                        value=-self.step_size(group["lr"], b1, b2, t))
        return loss


def make_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    """Adam with the reference's hyperparameters (b1 0.9, b2 0.999, eps
    1e-8); ``cfg.train.optimizer`` picks "adam" or "tf1-adam"."""
    name, lr = cfg.train.optimizer, cfg.train.learning_rate
    if name == "tf1-adam":
        return TF1Adam(params, lr)
    if name == "adam":
        return torch.optim.Adam(params, lr, betas=(0.9, 0.999), eps=1e-8)
    raise ValueError(f"unknown TrainConfig.optimizer {name!r}")


def _forward(state: TrainState, batch: GraphBatch, eps: Optional[Latents]):
    """The model on the batch, in ``cfg.compute_dtype``: float32 runs the
    masters as they are; a narrower dtype runs the model on casts of every
    float parameter and of the batch's float tensors."""
    model, cd = state.model, dtype_of(state.cfg.compute_dtype)
    kw = dict(generator=state.generator, eps=eps,
              dropout_keep=state.cfg.train.dropout_keep_prob)
    if cd == torch.float32:
        return model(batch, **kw)
    params = {n: p.to(cd) if p.is_floating_point() else p
              for n, p in model.named_parameters()}
    return functional_call(model, params, (batch.to(dtype=cd),), kw)


def train_step(state: TrainState, batch: GraphBatch, global_iter,
               eps: Optional[Latents] = None) -> Dict[str, torch.Tensor]:
    """One update of ``state`` on ``batch``; returns the aux values (the
    ELBO's terms and ``adj_acc``) as device tensors.  ε is drawn from
    ``state.generator`` (the disentangled model's in the order s, sg, g;
    the joint model's z_sg only) unless given.  After the call
    each parameter's ``.grad`` holds this step's gradient.  The three
    phases run under ``record_function`` ranges (``train_step.forward``,
    ``.backward``, ``.optimizer``) for the profiler.

    With ``state.mesh``, ``batch`` (and ``eps``, when given) is this rank's
    block of the global batch; the loss, the aux values and, once averaged
    over the ranks, the gradients are the global batch's.  Under a model
    axis the decoded adjacency holds this rank's rows, and each sharded
    parameter is gathered once per forward (``parametrize.cached``)."""
    with use_mesh(state.mesh):
        with record_function("train_step.forward"), parametrize.cached():
            out = _forward(state, batch, eps)
            total, aux = elbo_loss(state.cfg, out, batch.adj, batch.features, batch.coords,
                                   global_iter, node_mask=batch.node_mask)
            # edge accuracy of the decoded graphs (this rank's rows) against the
            # truth: the hits counted over the mesh, then one division (f32
            # counts are exact, so this is the one-process mean bit for bit)
            rows = shard_nodes(batch.adj, tag="dec.adj_true", nodes=batch.adj.shape[1])
            hits, edges = global_sum(model_sum((out.decoded.adj == rows).float().sum()),
                                     torch.tensor(float(batch.adj.numel()), device=rows.device))
            aux["adj_acc"] = hits / edges
        with record_function("train_step.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
            if state.mesh is not None:
                average_gradients([p for g in state.optimizer.param_groups for p in g["params"]],
                                  state.mesh, sharded=slices(state.model))
        with record_function("train_step.optimizer"):
            state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in aux.items()}


def rebatch(data: GraphBatch, batch_size: int) -> GraphBatch:
    """[G, ...] -> [G//B, B, ...] contiguous batches (the remainder is
    dropped, as the reference's int(G/B) loop does)."""
    nb = data.batch_size // batch_size
    return data._map(lambda t: t[: nb * batch_size].reshape((nb, batch_size) + t.shape[1:]))


def _maybe_reshuffle(state: TrainState, batched: GraphBatch) -> GraphBatch:
    """Corrected mode's per-epoch reshuffle (``cfg.train.reshuffle``): a
    fresh graph->batch assignment drawn from the trainer's generator.  JAX
    draws its permutation from its PRNG key, a stream this one cannot
    match.  Identity in parity mode: the reference trains on fixed
    contiguous batches."""
    if not state.cfg.train.reshuffle:
        return batched
    nb, b = batched.adj.shape[:2]
    perm = torch.randperm(nb * b, generator=state.generator, device=state.generator.device)
    return batched._map(
        lambda t: t.reshape((nb * b,) + t.shape[2:])[perm].reshape(t.shape))


class _GracefulStop:
    """SIGTERM/SIGINT trap: training finishes the current epoch, saves a
    checkpoint and returns instead of dying mid-step.  Installed only on the
    main thread; restores the previous handlers on exit."""

    def __init__(self):
        self.stop = False
        self._prev = {}

    def _handler(self, signum, frame):
        self.stop = True

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for s in (signal.SIGTERM, signal.SIGINT):
                self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False


class Trainer:
    """The epoch loop (the JAX ``Trainer``, the reference's main.py:300-356).

    Builds the model of ``cfg`` in f32 from ``cfg.train.seed`` on
    ``device`` (CUDA unless named), its optimizer and the ε generator,
    seeded from ``cfg.train.seed`` too; logs to
    ``<workdir>/<log_dir>/train_loss_<dataset>_<model_type>.txt`` and
    ``.jsonl`` and checkpoints to ``checkpoint.checkpoint_dir(cfg, workdir)``.
    ``eval_batch`` is the held-out split that ``cfg.train.eval_every``
    scores.  ``mesh`` (or, when None, ``cfg.mesh.data`` or ``cfg.mesh.model``
    above 1) trains over the processes of the mesh (see the module
    docstring)."""

    def __init__(self, cfg: Config, train_batch: GraphBatch, device: DeviceLike = None,
                 workdir: str = ".", eval_batch: Optional[GraphBatch] = None,
                 mesh: Optional[DeviceMesh] = None):
        full_f32()
        dev = resolve_device(device)
        if mesh is None and (cfg.mesh.data > 1 or cfg.mesh.model > 1):
            mesh = mesh_from_config(cfg.mesh, dev)
        self.cfg, self.device, self.workdir, self.mesh = cfg, dev, workdir, mesh
        model = build_model(cfg.with_(compute_dtype="float32"), dev).train()
        if mesh is not None:
            shard_params(model, mesh)
        params = [p for _, p in canonical_parameters(model)]
        self.state = TrainState(
            cfg=cfg, model=model, optimizer=make_optimizer(cfg, params),
            generator=torch.Generator(device=dev).manual_seed(cfg.train.seed), mesh=mesh)
        # the model ranks of data rank 0 score the held-out split together,
        # under the model axis alone; without one, rank 0 alone
        tp = mesh is not None and axis_size(mesh, MODEL_AXIS) > 1
        self._eval_mesh = mesh[MODEL_AXIS] if tp else None
        self.evaluates = mesh.get_local_rank(DATA_AXIS) == 0 if tp else is_primary()
        self.data = train_batch.to(dev)
        self.batched = rebatch(self.data, cfg.train.batch_size)
        self.primary = is_primary()
        self.logger = LossesLogger(os.path.join(
            workdir, cfg.train.log_dir,
            f"train_loss_{cfg.dataset}_{cfg.model_type}.txt")) if self.primary else None
        self.checkpointer = Checkpointer(checkpoint_dir(cfg, workdir))
        # epoch of the spanning-tree draw in effect (0 = the load-time draw)
        self._tree_boundary = 0
        # held-out evaluation and the best checkpoint (cfg.train.eval_every)
        self.eval_batch = None if eval_batch is None else eval_batch.to(dev)
        # the truth the scores compare against, on the host once
        self._eval_truth = None if eval_batch is None else {
            name: getattr(eval_batch, name).cpu().numpy()
            for name in ("adj", "features", "coords")}
        self.best_checkpointer: Optional[Checkpointer] = None
        self._best_value: Optional[float] = None
        if cfg.train.eval_every > 0 and eval_batch is not None and self.primary:
            self.best_checkpointer = Checkpointer(checkpoint_dir(cfg, workdir) + "_best",
                                                  max_to_keep=1)
            self.best_path = os.path.join(self.best_checkpointer.directory, "best.json")
            if os.path.exists(self.best_path):
                with open(self.best_path) as f:
                    self._best_value = float(json.load(f)["value"])
            self.eval_logger = LossesLogger(os.path.join(
                workdir, cfg.train.log_dir, f"val_loss_{cfg.dataset}_{cfg.model_type}.txt"))

    def _maybe_resample_trees(self, epoch: int) -> None:
        """Corrected mode (``cfg.train.resample_trees_every = k``): at the
        k-th epoch boundaries, draw new spanning trees of the original
        adjacencies seeded by seed + boundary with the default sampler (the
        native library), the JAX trainer's draw bit for bit where its
        default sampler is the native library too (any host with a C++
        compiler; JAX falls back to numpy without one, the port raises).
        Keyed by the boundary epoch
        (epoch // k)·k, so a run resumed mid-interval draws that boundary's
        trees again."""
        k = self.cfg.train.resample_trees_every
        if k <= 0 or self.data.adj_samples is None:
            return
        boundary = (epoch // k) * k
        if boundary == 0 or boundary == self._tree_boundary:
            return
        new = sample_spanning_trees(self.data.adj.cpu().numpy(), self.data.adj_samples.shape[1],
                                    seed=self.cfg.train.seed + boundary)
        self._tree_boundary = boundary
        self.data = replace(self.data, adj_samples=torch.as_tensor(
            new, dtype=self.data.adj_samples.dtype, device=self.device))
        self.batched = rebatch(self.data, self.cfg.train.batch_size)

    def evaluate_heldout(self) -> Dict[str, float]:
        """``reconstruct_evaluation`` of the posterior-mean reconstruction of
        the held-out batch, decoded by the f32 master weights in slices of
        ``batch_size`` (as the JAX ``make_eval_step`` decodes with its f32
        parameters); one host sync fetches every slice's decode."""
        B = self.cfg.train.batch_size
        with use_mesh(self._eval_mesh), parametrize.cached():
            outs = [whole_decoded(reconstruct(self.state.model,
                                              self.eval_batch.slice_batch(i * B, B)).decoded)
                    for i in range(max(self.eval_batch.batch_size // B, 1))]
        fields = {name: torch.cat([getattr(o, name) for o in outs])
                  for name in ("adj", "adj_prob", "coords", "node_feat")}
        # one transfer: every field as float64 (exact for f32, bf16 and the
        # integer edge classes) in one flat tensor
        flat = torch.cat([t.reshape(-1).double() for t in fields.values()]).cpu().numpy()
        host, o = {}, 0
        for name, t in fields.items():
            host[name] = flat[o:o + t.numel()].reshape(tuple(t.shape))
            o += t.numel()
        n = len(host["adj"])
        truth = self._eval_truth
        return reconstruct_evaluation(
            host["adj"], host["node_feat"], host["coords"],
            truth["adj"][:n], truth["features"][:n], truth["coords"][:n], self.cfg.dataset,
            adj_scores=edge_presence_scores(host["adj_prob"]),
            node_categorical=outs[0].node_feat_prob is not None)

    def _maybe_eval(self, epoch: int, verbose: bool) -> None:
        """At the ``eval_every`` cadence: score the held-out batch, log the
        scores and keep the best checkpoint by ``cfg.train.best_metric`` (a
        leading "-" minimizes), with its score in ``best.json`` so that a
        resumed run compares against the best of all its runs.  A metric
        the scores lack is skipped, as in JAX.  Rank 0 alone evaluates, or
        under a model axis the model ranks of data rank 0, which gather the
        checkpoint's tensors each time; rank 0 writes."""
        k = self.cfg.train.eval_every
        if (k <= 0 or self.eval_batch is None or not self.evaluates or epoch <= 0
                or epoch % k != 0):
            return
        metrics = self.evaluate_heldout()
        payload = checkpoint_payload(self.state) if self._eval_mesh is not None else None
        if not self.primary:
            return
        self.eval_logger.log(epoch, {f"val_{n}": [v] for n, v in metrics.items()})
        name = self.cfg.train.best_metric
        sign = -1.0 if name.startswith("-") else 1.0
        key = name.lstrip("-")
        if key not in metrics:
            if verbose:
                print(f"eval: best_metric {key!r} not in {sorted(metrics)}; "
                      "skipping best tracking")
            return
        score = sign * metrics[key]
        if verbose:
            print(f"Epoch: {epoch + 1:04d} val_{key}= {metrics[key]:.5f}"
                  + (f" (best {sign * self._best_value:.5f})"
                     if self._best_value is not None else ""))
        if self._best_value is None or score > self._best_value:
            self._best_value = score
            self.best_checkpointer.save(epoch, self.state, payload)
            with open(self.best_path, "w") as f:
                json.dump({"epoch": epoch, "metric": key, "value": score,
                           "raw": metrics[key]}, f)

    def maybe_restore(self) -> int:
        """Resume from the latest checkpoint if there is one; returns the
        epoch to start at.  A checkpoint of epoch e holds the state after
        e's updates, so training resumes at e + 1."""
        step = self.checkpointer.latest_step()
        if step is None:
            return 0
        self.checkpointer.restore(self.state, step)
        return step + 1

    def run_epoch(self, epoch: int) -> Dict[str, list]:
        """One epoch of steps over the contiguous batches (global_iter =
        ``epoch``; under a mesh, this rank's block of each); returns each aux
        value's per-step list, fetched from the device in the epoch's one
        host sync."""
        self._maybe_resample_trees(epoch)
        batched = _maybe_reshuffle(self.state, self.batched)
        global_iter = torch.full((), float(epoch), device=self.device)

        def batch(i):
            b = batched._map(lambda t: t[i])
            return b if self.mesh is None else shard_graphbatch(b, self.mesh)

        auxes = [train_step(self.state, batch(i), global_iter)
                 for i in range(batched.adj.shape[0])]
        keys = list(auxes[0])
        values = torch.stack([torch.stack([a[k].double() for k in keys])
                              for a in auxes]).cpu().numpy()
        return {k: values[:, j].tolist() for j, k in enumerate(keys)}

    def _profiled_epoch(self, epoch: int):
        """``run_epoch`` under ``torch.profiler`` (the CPU, and the card's
        kernels on a CUDA device) in a ``train_epoch`` range; the device
        is synchronized before the trace stops.  Returns the epoch's aux
        values and the profile.

        The profiler first takes a warm-up step that the trace leaves out:
        ``TRACE_WARMUP_S`` of tiny kernels, each waited for.  Without it, in
        a process that had traced before, the card's records of the first
        kernels of a trace (3 to 11 of them, the first ~1-2 ms of device
        work) were lost, so a trace counted fewer kernels than ran
        (PERF.md, fault 3.2)."""
        cuda = self.device.type == "cuda"
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        # one cycle: keeping its events (acc_events) spares torch's warning
        # that a new cycle would clear them
        with profile(activities=activities, acc_events=True,
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            x = torch.zeros(1, device=self.device)
            end = time.perf_counter() + TRACE_WARMUP_S
            while time.perf_counter() < end:
                x.add_(1)
                if cuda:
                    torch.cuda.synchronize(self.device)
            prof.step()                     # the warm-up ends, the trace starts
            with record_function("train_epoch"):
                storer = self.run_epoch(epoch)
            if cuda:
                torch.cuda.synchronize(self.device)
        return storer, prof

    def _save(self, epoch: int) -> None:
        """Every rank gathers the state's whole tensors (collectives under a
        model axis); rank 0 writes them."""
        payload = checkpoint_payload(self.state)
        if self.primary:
            self.checkpointer.save(epoch, self.state, payload)

    def run(self, epochs: Optional[int] = None, verbose: bool = True,
            profile_dir: Optional[str] = None) -> Dict[str, float]:
        """Train up to ``epochs`` (``cfg.train.epochs`` when None); returns
        the last epoch's means (on every rank: the global batch's).  Under a
        mesh the ranks meet once more at the end, so that every checkpoint
        is on disk when any rank returns.

        ``profile_dir`` traces epoch 1 (the second; epoch 0 when only one
        is asked for, as the JAX trainer's ``prof_epoch``) with
        ``torch.profiler`` if this run reaches it, and writes the trace as
        ``<profile_dir>/trace_rank<r>.json`` (Chrome's trace format), one
        per process under a mesh.  The trace holds a record of every kernel
        the epoch launched, also in a process that has traced before (the
        profiler warms up on a discarded step: ``_profiled_epoch``)."""
        cfg = self.cfg
        epochs = cfg.train.epochs if epochs is None else epochs
        prof_epoch = 1 if epochs > 1 else 0
        verbose = verbose and self.primary
        last_means: Dict[str, float] = {}
        start = self.maybe_restore()
        with _GracefulStop() as stopper:
            for epoch in range(start, epochs):
                t0 = time.time()
                prof = None
                if profile_dir is not None and epoch == prof_epoch:
                    storer, prof = self._profiled_epoch(epoch)
                else:
                    storer = self.run_epoch(epoch)
                if verbose:
                    print(f"Epoch: {epoch + 1:04d} loss= {np.mean(storer['loss']):.5f}")
                    print(f"epoch time= {time.time() - t0:.5f}")
                if prof is not None:
                    t0 = time.time()
                    os.makedirs(profile_dir, exist_ok=True)
                    rank = dist.get_rank() if dist.is_initialized() else 0
                    path = os.path.join(profile_dir, f"trace_rank{rank}.json")
                    prof.export_chrome_trace(path)
                    if verbose:
                        print(f"profile: {path} written in {time.time() - t0:.5f} s")
                if epoch % cfg.train.checkpoint_every == 0:
                    self._save(epoch)
                self._maybe_eval(epoch, verbose)
                last_means = (self.logger.log(epoch, storer) if self.logger is not None
                              else epoch_means(storer))
                if stopper.stop:
                    self._save(epoch)
                    if verbose:
                        print(f"interrupted: checkpointed epoch {epoch}")
                    break
        if self.mesh is not None:
            dist.barrier()
        return last_means
