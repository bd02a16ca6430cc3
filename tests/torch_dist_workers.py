"""Worker processes of the port's multi-process tests, and the helper that
starts them.  Imports no JAX: the ranks run the port alone, and the tests
compare what they write with the JAX package in their own process.

``run_many([(job, world, directory, inputs), ...])`` starts the runs at
once.  Each saves ``inputs`` to ``<directory>/inputs.pt`` and starts
``world`` processes of

    python tests/torch_dist_workers.py <job> <rank> <world> <directory>

Each joins a gloo process group through ``file://<directory>/rendezvous``
(no TCP port, so runs side by side never collide), runs torch on one
thread, calls ``JOBS[job](rank, world, inputs, directory)`` and saves what
it returns to ``<directory>/out_<rank>.pt``; ``run_many`` returns those of
each run, in rank order, and raises with a rank's output when one fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from snd_vae_tpu_torch import train as ttrain  # noqa: E402
from snd_vae_tpu_torch.data.graphbatch import from_numpy  # noqa: E402
from snd_vae_tpu_torch.data.loaders import load_dataset  # noqa: E402
from snd_vae_tpu_torch.losses import hierarchical_total_correlation  # noqa: E402
from snd_vae_tpu_torch.models import Latents, build_model  # noqa: E402
from snd_vae_tpu_torch.parallel import (  # noqa: E402
    constrain, initialize_distributed, is_primary, make_mesh, param_shardings,
    shard_graphbatch, shard_nodes, shard_params, use_mesh,
)
from snd_vae_tpu_torch.parallel import hints  # noqa: E402
from snd_vae_tpu_torch.parallel import large_graph as lg  # noqa: E402
from snd_vae_tpu_torch.parallel import tensor_parallel as tp  # noqa: E402
from snd_vae_tpu_torch.parallel.batch import (  # noqa: E402
    gather_nodes, global_mean, global_rows, global_sum, local_rows,
)
from snd_vae_tpu_torch.params import sharded_gcn_state_dict  # noqa: E402

F64 = torch.float64


def run_many(jobs, timeout: float = 300) -> list:
    """Several ``(job, world, directory, inputs)`` runs at once; the outputs
    of each, in order."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    started = []
    for job, world, directory, inputs in jobs:
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        torch.save(inputs, directory / "inputs.pt")
        started.append((job, world, directory, [
            subprocess.Popen([sys.executable, __file__, job, str(r), str(world), str(directory)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for r in range(world)]))
    procs = [p for *_, ps in started for p in ps]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = iter(logs)
    outs = []
    for job, world, directory, ps in started:
        for r, p in enumerate(ps):
            log = next(logs)
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of {job} exited {p.returncode}:\n{log[-4000:]}")
        outs.append([torch.load(directory / f"out_{r}.pt", weights_only=False)
                     for r in range(world)])
    return outs


# --------------------------------------------------------------------------
# The data-parallel step, shared with the single-process reference
# --------------------------------------------------------------------------

def make_state(cfg, state_dict=None, mesh=None, min_size=1 << 14) -> ttrain.TrainState:
    """The float64 train state of ``cfg`` on the CPU: the seed's weights
    (or ``state_dict``), the optimizer of ``cfg``, the ε generator seeded
    with 0.  Under a mesh with a model axis, the parameters of at least
    ``min_size`` elements that the axis divides are sharded over it."""
    model = build_model(cfg, device="cpu").to(F64)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    if mesh is not None:
        shard_params(model, mesh, min_size)
    params = [p for _, p in tp.canonical_parameters(model)]
    return ttrain.TrainState(cfg=cfg, model=model,
                             optimizer=ttrain.make_optimizer(cfg, params),
                             generator=torch.Generator().manual_seed(0), mesh=mesh)


def one_step(cfg, arrays, state_dict=None, eps=None, mesh=None, min_size=1 << 14) -> dict:
    """One ``train_step`` in float64 on the global batch ``arrays`` (numpy),
    or under ``mesh`` on this rank's block of it (and of ``eps``, a dict
    of global noise arrays s / sg / g); returns the aux values, every
    gradient and every updated parameter, whole, by unsharded name."""
    state = make_state(cfg, state_dict, mesh, min_size)
    batch = from_numpy(**arrays, dtype=F64)
    if mesh is not None:
        batch = shard_graphbatch(batch, mesh)
    if eps is not None:
        rows = lambda a: a if mesh is None else np.array_split(
            a, mesh.shape[0])[mesh.get_local_rank("data")]
        t = lambda k: torch.from_numpy(rows(eps[k])).to(F64)
        eps = Latents(z_s=t("s"), z_sg=t("sg"), z_g=t("g"))
    aux = ttrain.train_step(state, batch, torch.tensor(0.0, dtype=F64), eps=eps)
    named = dict(tp.canonical_parameters(state.model))
    return {"aux": {k: v.item() for k, v in aux.items()},
            "grads": tp.whole_tensors(state.model, {n: p.grad for n, p in named.items()}),
            "params": tp.whole_tensors(state.model, named),
            "sharded": sorted(tp.sharded(state.model))}


# --------------------------------------------------------------------------
# Jobs
# --------------------------------------------------------------------------

def _spec(placements, ndim):
    """Placements as JAX's PartitionSpec entries: "model" at the sharded
    axis, None elsewhere."""
    model = placements[1]
    return tuple("model" if model.is_shard() and model.dim == ax else None
                 for ax in range(ndim))


def job_parallel(rank, world, inputs, directory):
    """The mesh, the shardings, the hints and the batch reductions at
    world 4."""
    out = {"rank_again": initialize_distributed(), "primary": is_primary()}
    meshes = {"4x1": make_mesh(4, 1, "cpu"), "2x2": make_mesh(2, 2, "cpu"),
              "1x4": make_mesh(1, 4, "cpu")}
    out["shapes"] = {k: tuple(m.shape) for k, m in meshes.items()}
    try:
        make_mesh(8, 1, "cpu")
    except ValueError as e:
        out["too_big"] = str(e)
    out["shardings"] = {}
    for (tree, mesh_name, min_size) in inputs["sharding_cases"]:
        params = {n: torch.empty(s, device="meta") for n, s in inputs["trees"][tree].items()}
        got = param_shardings(params, meshes[mesh_name], min_size)
        out["shardings"][(tree, mesh_name, min_size)] = {
            n: _spec(p, len(inputs["trees"][tree][n])) for n, p in got.items()}
    batch = from_numpy(**inputs["batch"], dtype=F64)
    out["blocks"] = {k: shard_graphbatch(batch, meshes[k]).adj for k in ("4x1", "2x2", "1x4")}
    try:
        shard_graphbatch(batch.slice_batch(0, 6), meshes["4x1"])
    except ValueError as e:
        out["uneven"] = str(e)
    x = torch.ones(2, 3)
    out["identity"] = [constrain(x, "data") is x, shard_nodes(x) is x]
    with use_mesh(meshes["4x1"]):
        out["identity"] += [constrain(x, "data") is x, shard_nodes(x) is x,
                            constrain(x, None, "model") is x]
        g = torch.Generator().manual_seed(3)
        out["local_draw"] = local_rows(lambda s: torch.randn(s, generator=g, dtype=F64), (2, 3))
        local = torch.arange(6, dtype=F64).reshape(2, 3) + 10.0 * rank
        out["global_sum"] = global_sum(local.sum())
        out["global_mean"] = global_mean(local.mean(0), local.mean())
        out["global_rows"] = global_rows(local)
    # under a model axis of 2 (and of 4): this rank's rows of the node axis
    nodes = torch.arange(2 * 5 * 3).reshape(2, 5, 3)
    out["hint_rows"] = {}
    for name in ("2x2", "1x4"):
        with use_mesh(meshes[name]):
            rows = shard_nodes(nodes, tag="probe")
            out["hint_rows"][name] = {
                "shard_nodes": rows, "constrain": constrain(nodes, "data", "model"),
                "again": shard_nodes(rows, nodes=5) is rows,
                "whole": gather_nodes(rows, 5), "block": hints.own_block(5)}
    params = {"a": torch.full((3,), float(rank)), "b": torch.full((2, 2), float(rank), dtype=F64)}
    shard_params(params, meshes["4x1"])
    out["broadcast"] = params
    mixed = {"small": torch.full((3,), float(rank)),
             "big": torch.arange(64 * 8, dtype=F64).reshape(64, 8) + rank}
    out["model_slices"] = shard_params(mixed, meshes["2x2"], min_size=256)
    return out


def job_large_graph(rank, world, inputs, directory):
    """Each case's node-sharded ops on this rank's rows, float64: the
    normalized adjacency, the degrees, one layer and the encoder's pooled
    vector, by the library and by K3's plain version; at world 1 the
    gradient of the pooled sum for the kernels."""
    mesh = make_mesh(1, world, "cpu")
    out = []
    for case in inputs:
        adj_blk, x_blk = lg.shard_graph(case["adj"], case["x"], mesh, dtype=F64)
        norm = lg.sharded_gcn_normalize(adj_blk, mesh)
        w0 = torch.from_numpy(case["kernels"][0])
        res = {"adj_blk": adj_blk, "norm": norm, "degree": lg.sharded_degree(adj_blk),
               "conv": lg.sharded_graph_conv(norm, x_blk, w0, mesh),
               "conv_kernel": lg.sharded_graph_conv(norm, x_blk, w0, mesh, use_kernel=True)}
        for use_kernel in (False, True):
            enc = lg.ShardedGCNEncoder(mesh, [k.shape[1] for k in case["kernels"]],
                                       case["x"].shape[1], torch.Generator().manual_seed(0),
                                       use_kernel=use_kernel).to(F64)
            enc.load_state_dict(sharded_gcn_state_dict(case["kernels"]))
            pooled = enc(norm, x_blk)
            res["pooled_kernel" if use_kernel else "pooled"] = pooled.detach()
            if world == 1 and not use_kernel:
                res["grads"] = torch.autograd.grad(pooled.sum(), list(enc.kernels))
        out.append(res)
    return out


def job_dp_step(rank, world, inputs, directory):
    """Each case's data-parallel step at this world; at world 2 also the
    Trainer's 2 epochs and a resume, and the hierarchical total
    correlation."""
    mesh = make_mesh(world, 1, "cpu")
    out = {name: one_step(c["cfg"], c["arrays"], c.get("state_dict"), c.get("eps"), mesh)
           for name, c in inputs["cases"].items()}
    if "htc" in inputs:
        full = [torch.from_numpy(a) for a in inputs["htc"]]
        local = [a.chunk(world)[rank].clone().requires_grad_(True) for a in full]
        with use_mesh(mesh):
            value = hierarchical_total_correlation(*local)
            grads = torch.autograd.grad(value, local)
        out["htc"] = {"value": value.item(), "grads": grads}
    if "trainer" in inputs:
        out["trainer"] = _trainer_runs(inputs["trainer"], mesh, Path(directory))
    return out


def _trainer_runs(cfg, mesh, directory) -> dict:
    """2 epochs straight in workdir a; 1 epoch, then a new Trainer resumed
    to 2, in workdir b."""
    data = load_dataset(cfg, "train", num_graphs=2 * cfg.train.batch_size, device="cpu")
    trainer = lambda wd: ttrain.Trainer(cfg, data, device="cpu", workdir=str(directory / wd),
                                        mesh=mesh)
    straight = trainer("a")
    means = straight.run(2, verbose=False)
    trainer("b").run(1, verbose=False)
    resumed = trainer("b")
    resumed.run(2, verbose=False)
    state = lambda t: {"params": {n: p.detach().clone()
                                  for n, p in t.state.model.named_parameters()},
                       "optimizer": t.state.optimizer.state_dict(),
                       "generator": t.state.generator.get_state(), "step": t.state.step}
    return {"means": means, "straight": state(straight), "resumed": state(resumed),
            "writes_logs": straight.logger is not None,
            "checkpoints": sorted(os.listdir(straight.checkpointer.directory))}


# --------------------------------------------------------------------------
# The mesh's model axis
# --------------------------------------------------------------------------

def _inspect():
    """Collect every ``shard_nodes`` report as tag -> [(start, stop, n)]."""
    seen = {}
    hints._INSPECT = lambda tag, start, stop, n: seen.setdefault(tag, []).append(
        (start, stop, n))
    return seen


def tp_op(case, mesh=None):
    """One node-sharded op of ``case`` (built by ``tp_op_module`` from its
    seed, in the case's ``dtype``, float64 by default) on the whole inputs:
    under ``mesh`` this rank's rows of the output, a local loss Σ out·g
    over those rows and the gradients of that loss (the inputs' and the
    parameters'); without it the whole op."""
    fn, params = tp_op_module(case)
    dt = getattr(torch, case.get("dtype", "float64"))
    inputs = [torch.from_numpy(a).to(dt).requires_grad_(True) for a in case["inputs"]]
    with use_mesh(mesh):
        out = fn(*inputs)
        n = case["inputs"][0].shape[1]
        g = shard_nodes(torch.from_numpy(case["g"]).to(dt), nodes=n)
        grads = torch.autograd.grad((out * g).sum(), inputs + list(params.values()),
                                    allow_unused=True)
        whole = gather_nodes(out.detach(), n)
    names = [f"input{i}" for i in range(len(inputs))] + list(params)
    return {"out": whole, "grads": {k: (torch.zeros(()) if v is None else v)
                                    for k, v in zip(names, grads)}}


def tp_op_module(case):
    """(fn of the whole inputs, the parameters by name) of an op case."""
    from snd_vae_tpu_torch.models import build_model
    from snd_vae_tpu_torch.nn import E2E, SpatialGraphConv, SpatialGraphConv3D

    kind, g = case["kind"], torch.Generator().manual_seed(case.get("seed", 0))
    if kind == "sgc3":
        m = SpatialGraphConv(case["F"], case["R"], case["hidden"], g,
                             block_rows=case.get("block_rows")).to(F64)
        return (lambda adj, x, rel: m(adj, x, rel)), dict(m.named_parameters())
    if kind == "sgc4":
        m = SpatialGraphConv3D(case["F"], case["R"], case["hidden"], g,
                               fully_connected=case.get("fully_connected", False),
                               block_rows=case.get("block_rows")).to(F64)
        return (lambda adj, x, rel: m(adj, x, rel)), dict(m.named_parameters())
    if kind in ("e2e", "e2e_sep"):
        m = E2E(case["C"], case["O"], case["k_h"], g, use_matmul=case.get("use_matmul")).to(
            getattr(torch, case.get("dtype", "float64")))
        for p in m.parameters():          # a bias of zeros would hide its gradient
            with torch.no_grad():
                p.add_(0.1 * torch.randn(p.shape, generator=g, dtype=F64))
        if kind == "e2e":
            # the map as the adjacency head hands it over: this rank's rows
            return (lambda x: m(shard_nodes(x, tag="probe.e2e", nodes=x.shape[1]))), dict(
                m.named_parameters())
        return (lambda p_, q, d: m(factors=(p_, q, shard_nodes(d, nodes=d.shape[1])))), dict(
            m.named_parameters())
    if kind == "adj_head":
        model = build_model(case["cfg"], device="cpu").to(F64)
        head = {n: p for n, p in model.named_parameters()
                if n.split(".", 1)[0] in model.ADJ_HEAD}
        return (lambda h, coords: model._adj_head(h, coords)), head
    raise ValueError(kind)


def job_tp_ops(rank, world, inputs, directory):
    """Every op case on the 2x2 and the 1x4 mesh, with the hint reports."""
    meshes = {"2x2": make_mesh(2, 2, "cpu"), "1x4": make_mesh(1, 4, "cpu")}
    out = {}
    for mesh_name, mesh in meshes.items():
        seen = _inspect()
        out[mesh_name] = {name: tp_op(case, mesh) for name, case in inputs["ops"].items()}
        out[mesh_name]["seen"] = seen
    hints._INSPECT = None
    return out


def job_tp_step(rank, world, inputs, directory):
    """Each step case on the 1x4 and the 2x2 mesh (the parameters of at
    least ``min_size`` elements sharded), the hint reports of the first
    case, and the parameter and Adam bytes this rank holds at the
    synthetic2 widths on the 1x4 mesh."""
    out = {}
    for mesh_name, (d, m) in (("1x4", (1, 4)), ("2x2", (2, 2))):
        mesh = make_mesh(d, m, "cpu")
        for name, c in inputs["cases"].items():
            seen = _inspect()
            out[(mesh_name, name)] = one_step(c["cfg"], c["arrays"], c.get("state_dict"),
                                              c.get("eps"), mesh, inputs["min_size"])
            out[(mesh_name, name)]["seen"] = seen
    hints._INSPECT = None
    out["bytes"] = state_bytes(inputs["bytes_cfg"], make_mesh(1, world, "cpu"))
    return out


def state_bytes(cfg, mesh=None) -> int:
    """The bytes of the parameters and Adam's moments one process holds for
    ``cfg``'s model (f32) after a first optimizer step, its big parameters
    sharded over ``mesh``'s model axis."""
    model = build_model(cfg, device="cpu")
    if mesh is not None:
        shard_params(model, mesh)
    params = [p for _, p in tp.canonical_parameters(model)]
    opt = ttrain.make_optimizer(cfg, params)
    for p in params:
        p.grad = torch.zeros_like(p)
    opt.step()
    moments = [v for st in opt.state.values() for v in st.values()
               if isinstance(v, torch.Tensor) and v.dim() > 0]
    return sum(t.numel() * t.element_size() for t in params + moments)


def job_tp_trainer(rank, world, inputs, directory):
    """The Trainer of ``inputs["cfg"]``, whose ``mesh`` config names the
    mesh (the Trainer builds it): 2 epochs straight in workdir a (scoring
    ``eval_graphs`` held-out graphs at the config's ``eval_every``, when
    given); with ``single_workdir`` also 1 epoch in workdir b (left for a
    resume in one process) and a resume to 2 epochs of the one-process
    checkpoint the test wrote there; the whole state after each."""
    from snd_vae_tpu_torch.checkpoint import checkpoint_payload

    cfg = inputs["cfg"]
    data = load_dataset(cfg, "train", num_graphs=inputs["graphs"], device="cpu")
    held = (load_dataset(cfg, "test", num_graphs=inputs["eval_graphs"], device="cpu")
            if "eval_graphs" in inputs else None)
    trainer = lambda wd: ttrain.Trainer(cfg, data, device="cpu", workdir=wd, eval_batch=held)
    straight = trainer(str(directory / "a"))
    out = {"means": straight.run(2, verbose=False), "evaluates": straight.evaluates,
           "straight": checkpoint_payload(straight.state),
           "sharded": sorted(tp.sharded(straight.state.model)),
           "checkpoints": sorted(os.listdir(straight.checkpointer.directory))}
    if "single_workdir" in inputs:
        trainer(str(directory / "b")).run(1, verbose=False)
        resumed = trainer(inputs["single_workdir"])
        out["resumed_means"] = resumed.run(2, verbose=False)
        out["resumed"] = checkpoint_payload(resumed.state)
    return out


# --------------------------------------------------------------------------
# The default dispatch's step body under a mesh
# --------------------------------------------------------------------------

def trainer_state(trainer):
    """(parameters, optimizer state, step, generator state) of a Trainer,
    copied."""
    st = trainer.state
    opt = st.optimizer.state_dict()["state"]
    return ([p.detach().clone() for p in st.model.parameters()],
            {i: {k: v.clone() for k, v in s.items()} for i, s in opt.items()},
            st.step, st.generator.get_state())


def _mesh_trainer(case, mesh, workdir, eval_graphs=0):
    cfg = case["cfg"]
    data = load_dataset(cfg, "train", num_graphs=case["graphs"], device="cpu")
    held = load_dataset(cfg, "test", num_graphs=eval_graphs, device="cpu") if eval_graphs else None
    tr = ttrain.Trainer(cfg, data, device="cpu", workdir=str(workdir), eval_batch=held,
                        mesh=mesh)
    if "state_dict" in case:
        tp.load_whole_state_dict(tr.state.model, case["state_dict"])
    return tr


def _body_against_run_epoch(case, mesh, directory):
    """2 epochs through ``StepGraph``'s body (in chunks of ``case["chunk"]``
    epochs) and through ``run_epoch`` from identical Trainers: each one's
    per-step aux values, its state, and what the graph holds."""
    got, want = (_mesh_trainer(case, mesh, directory / n) for n in ("graph", "step"))
    nb, chunk = got.batched.adj.shape[0], case["chunk"]
    graph = ttrain.StepGraph(got, chunk * nb)
    storers = []
    for e in range(0, 2, chunk):
        storers += got.graph_epochs(graph, range(e, e + chunk))
    model = got.state.model
    return {"graph": storers, "step": [want.run_epoch(0), want.run_epoch(1)],
            "graph_state": trainer_state(got), "step_state": trainer_state(want),
            "block": tuple(graph.data.adj.shape), "count": int(graph.count),
            "sliced": sorted(tp.sharded(model)),
            "slices_are_parameters": {id(t) for t in tp.slices(model)}
            <= {id(p) for p in model.parameters()}}


def _chunked_run(case, mesh, directory):
    """``Trainer.run`` of ``case["epochs"]`` epochs with ``epoch_chunk``:
    the chunks ``chunk_end`` gave, and the epochs of the checkpoints, the
    evaluations and the log lines (rank 0's)."""
    tr = _mesh_trainer(case, mesh, directory, case["eval_graphs"])
    chunks, end = [], tr.chunk_end
    tr.chunk_end = lambda e, n, c: (lambda s: chunks.append(s - e) or s)(end(e, n, c))
    tr.run(case["epochs"], verbose=False, epoch_chunk=case["epoch_chunk"])
    if not tr.primary:
        return {"chunks": chunks}
    evals = sorted({int(r.split(",")[0]) for r in open(tr.eval_logger.path).read()
                    .splitlines()[1:]})
    logs = [json.loads(line)["epoch"] for line in open(tr.logger.jsonl_path)]
    return {"chunks": chunks, "saves": tr.checkpointer.steps(), "evals": evals, "logs": logs}


def _jax_eps_epochs(case, mesh, directory):
    """``case["epochs"]`` epochs through the body from the given weights,
    each step's ε this rank's rows of the given global draws: the per-step
    losses."""
    tr = _mesh_trainer(case, mesh, directory)
    d, r = mesh.shape[0], mesh.get_local_rank("data")
    stream = iter([Latents(**{k: torch.from_numpy(np.array_split(v, d)[r]) for k, v in e.items()})
                   for e in case["eps"]])
    step = ttrain.train_step
    ttrain.train_step = lambda st, b, gi: step(st, b, gi, eps=next(stream))
    try:
        nb = tr.batched.adj.shape[0]
        graph = ttrain.StepGraph(tr, nb)
        return [np.asarray(s["loss"]) for e in range(case["epochs"])
                for s in tr.graph_epochs(graph, range(e, e + 1))]
    finally:
        ttrain.train_step = step


def job_dispatch_mesh(rank, world, inputs, directory):
    """Each case on its mesh (d, m) of this world: ``body`` the step body
    against ``run_epoch``, ``chunked`` ``Trainer.run`` with ``epoch_chunk``,
    ``jax_eps`` the body's losses with the given ε.  Parameters of at least
    ``inputs["min_size"]`` elements are sliced over the model axis."""
    run = {"body": _body_against_run_epoch, "chunked": _chunked_run, "jax_eps": _jax_eps_epochs}
    shard = ttrain.shard_params
    ttrain.shard_params = lambda model, mesh: shard(model, mesh, inputs["min_size"])
    out, meshes = {}, {}
    for name, case in inputs["cases"].items():
        if case["mesh"] not in meshes:
            meshes[case["mesh"]] = make_mesh(*case["mesh"], "cpu")
        out[name] = run[case["kind"]](case, meshes[case["mesh"]],
                                      directory / "_".join(map(str, name)) if isinstance(
                                          name, tuple) else directory / name)
    return out


JOBS = {"parallel": job_parallel, "large_graph": job_large_graph, "dp_step": job_dp_step,
        "tp_ops": job_tp_ops, "tp_step": job_tp_step, "tp_trainer": job_tp_trainer,
        "dispatch_mesh": job_dispatch_mesh}


def main(argv) -> None:
    job, rank, world, directory = argv[1], int(argv[2]), int(argv[3]), Path(argv[4])
    torch.set_num_threads(1)
    initialize_distributed(f"file://{directory}/rendezvous", world, rank, device="cpu")
    try:
        inputs = torch.load(directory / "inputs.pt", weights_only=False)
        out = JOBS[job](rank, world, inputs, directory)
        torch.save(out, directory / f"out_{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
