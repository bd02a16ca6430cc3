#!/usr/bin/env python3
"""The mesh's model axis across CUDA cards, against one process.

    python3 benchmarks_torch/tp_cards.py            # needs 4 cards (2 for --cards 2)
    python3 benchmarks_torch/tp_cards.py --part frontier --device cpu --nodes 32  # gloo rehearsal

``--part synthetic2`` trains synthetic2 at full width (the generated
splits, f32) for 2 epochs through the CLI, once in one process and once
under ``torchrun`` on each mesh that fits the cards: (data, model) = (1,
2), and with 4 cards (1, 4) and (2, 2) (``--dp d --tp m --distributed``,
NCCL, one card per process).  Each run's per-epoch mean losses (its
``logs/*.jsonl``) must equal the single process's at rtol 1e-5 (f32 sums
in another order; two single runs on one card differ by ~1e-8), every rank
must print the same result, and the checkpoints written hold whole
tensors (``sg_lin1.kernel`` is [1250, 100] whatever the mesh).

``--part frontier`` takes one f32 train step of the frontier configuration
(``chip_smoke.frontier_config``: synthetic2's widths at ``--nodes`` N, 1024
by default, B = 2 graphs x S = 2 trees) from the seed weights on the train
split's first 2 graphs, in one process and under ``torchrun`` on the
meshes (1, 2) and, with 4 cards, (1, 4), where E2E's layers run on each
rank's rows (``E2E._rows``).  A Trainer takes a warm-up step, then a new
one the timed step: its loss and every gradient (gathered whole) must
equal one process's at rtol 1e-4 (atol 3e-4 of each gradient's largest
magnitude, as ``tests/test_torch_frontier.py`` holds the step to JAX's);
each rank's ms for the step and peak of allocated memory are reported.

``--part graphs`` holds the Trainer's two dispatches against each other
on every mesh that fits the cards: (data, model) = (2, 1) and (1, 2), and
with 4 cards (4, 1), (2, 2) and (1, 4), each under ``torchrun`` (NCCL, one
card per process), synthetic2 at full width, f32.  On each rank two
Trainers from one seed train 2 epochs (at d = 4 on batches of 20 graphs,
5 a rank: synthetic2's 10 do not split over 4 data ranks, in JAX either),
one by the default dispatch
(CUDA-graph replays, the step's NCCL collectives captured) and one
``per_step=True``: every aux value, and the whole state that rank holds
(parameters or their slices, Adam's moments and counts, the step, the
generator), must be bit-equal; each run's peak of allocated memory.  Then
both dispatches' epochs in turns and a profiled epoch of each
(``chip_smoke.compare_dispatches``): steps/s a rank, the kernel records a
step of each kernel and the busy share.  With 4 cards also the
frontier at N = ``--nodes`` f32 on (1, 4): ms of one replayed step against
one eager step on each rank, and its peak.

``--part teardown`` checks that a failing run frees its graph before the
process group goes (``ROADMAP.md`` §3, fault 3.8): on the mesh (1, 2), or
(1, 4) with 4 cards, each rank's ``Trainer.run`` of the frontier at
``--nodes`` N f32 replays its captured step, then fails at its first
checkpoint, and ``destroy_process_group`` runs in a ``finally`` while the
error's traceback is held, as in the CLI; every rank must end within
``TEARDOWN_LIMIT_S``.

``--part all`` (the default) runs the frontier and synthetic2 parts.
Prints one JSON line per run (wall seconds, the losses, the result) and
the cards' name and power limit last.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
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
TEARDOWN_LIMIT_S = 120    # --part teardown: the ranks' whole run, the teardown included


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


def frontier_worker(args) -> None:
    """One rank of ``--part frontier`` (the world from ``torchrun``'s
    environment; 1 without it): a warm-up step, then the timed step from
    the seed weights of a new Trainer; writes ``<out>/rank<r>.pt``."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import frontier_config

    from snd_vae_tpu_torch import train as tt
    from snd_vae_tpu_torch.data.loaders import load_dataset
    from snd_vae_tpu_torch.parallel import initialize_distributed, make_mesh
    from snd_vae_tpu_torch.parallel import tensor_parallel as tp
    from snd_vae_tpu_torch.parallel.mesh import shard_graphbatch

    if args.device == "cpu":
        torch.set_num_threads(1)
    world = int(os.environ.get("WORLD_SIZE", 1))
    mesh = None
    if world > 1:
        initialize_distributed(device=args.device)
        mesh = make_mesh(1, world, args.device)
    rank = int(os.environ.get("RANK", 0))
    dev = torch.device(f"cuda:{torch.cuda.current_device()}") if args.device == "cuda" \
        else torch.device("cpu")
    cfg = frontier_config(args.nodes)
    data = load_dataset(cfg, "train", num_graphs=2, device=dev)
    out = Path(args.frontier_worker)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    for _ in range(2):          # a warm-up step, then the timed one, each from the seed weights
        tr = tt.Trainer(cfg, data, device=dev, workdir=str(out / f"wd{rank}"), mesh=mesh)
        batch = tr.batched._map(lambda t: t[0])
        batch = batch if mesh is None else shard_graphbatch(batch, mesh)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        sync()
        t0 = time.perf_counter()
        aux = tt.train_step(tr.state, batch, torch.zeros((), device=dev))
        sync()
        ms = (time.perf_counter() - t0) * 1e3
    named = dict(tp.canonical_parameters(tr.state.model))
    grads = tp.whole_tensors(tr.state.model, {n: p.grad for n, p in named.items()})
    res = {"rank": rank, "world": world, "loss": aux["loss"].item(), "ms": ms,
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None}
    if rank == 0:
        res["grads"] = {n: g.float().cpu() for n, g in grads.items()}
    torch.save(res, out / f"rank{rank}.pt")
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()


def graphs_worker(args) -> None:
    """One rank of ``--part graphs`` on the mesh ``--mesh d m`` (``torchrun``
    starts d·m of them): the two dispatches from one seed, their turns and
    profiles (and the frontier's replayed step against an eager one where
    ``--frontier-graphs``); writes ``<out>/rank<r>.json``."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import compare_dispatches, frontier_config, state_differs, train_state

    import torch.distributed as dist

    from snd_vae_tpu_torch import train as tt
    from snd_vae_tpu_torch.config import synthetic2_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset
    from snd_vae_tpu_torch.parallel import initialize_distributed, make_mesh
    from snd_vae_tpu_torch.parallel.mesh import shard_graphbatch

    if args.device == "cpu":
        torch.set_num_threads(1)
    d, m = args.mesh
    rank = initialize_distributed(device=args.device)
    mesh = make_mesh(d, m, args.device)
    dev = torch.device(f"cuda:{torch.cuda.current_device()}") if args.device == "cuda" \
        else torch.device("cpu")
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    out = Path(args.graphs_worker)
    cfg = synthetic2_preset(dataset_path=str(ROOT / "dataset"))
    # a batch splits over the data ranks in equal blocks, as in JAX: at
    # d = 4 synthetic2's 10 graphs become 20 (lcm)
    cfg = cfg.with_(train=dataclasses.replace(
        cfg.train, batch_size=math.lcm(cfg.train.batch_size, d)))
    data = load_dataset(cfg, "train", device=dev)
    res = {"rank": rank, "mesh": [d, m], "batch": cfg.train.batch_size}
    trainers, logs, peak = {}, {}, {}
    for path in ("graph", "per_step"):
        tr = trainers[path] = tt.Trainer(cfg, data, device=dev, workdir=str(out / f"{path}{rank}"),
                                         mesh=mesh)
        # each epoch's aux values on every rank, from either dispatch
        got = logs[path] = []
        ge, re_ = tr.graph_epochs, tr.run_epoch
        tr.graph_epochs = lambda g, es, ge=ge, got=got: (lambda r: got.extend(r) or r)(ge(g, es))
        tr.run_epoch = lambda e, re_=re_, got=got: (lambda r: got.append(r) or r)(re_(e))
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        tr.run(EPOCHS, verbose=False, per_step=path == "per_step")
        peak[path] = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
    tg, tp = trainers["graph"], trainers["per_step"]
    res["state_differs"] = state_differs(train_state(tg), train_state(tp))
    res["state_equal"] = not res["state_differs"]
    res["aux_equal"] = len(logs["graph"]) == EPOCHS and logs["graph"] == logs["per_step"]
    res["epoch_mean_loss"] = [sum(s["loss"]) / len(s["loss"]) for s in logs["graph"]]
    res["peak_gb"] = peak
    nb = tg.batched.adj.shape[0]
    graph = tt.StepGraph(tg, nb)
    tg.graph_epochs(graph, range(2, 3))          # the eager step and the capture
    res["capture_s"] = graph.capture_s
    res["kernels_per_replay"], res["copies_per_replay"] = (graph.kernels_per_replay,
                                                           graph.copies_per_replay)
    both = compare_dispatches(lambda e: tg.graph_epochs(graph, range(e, e + 1)), tp.run_epoch,
                              3, nb, sync=sync, profile=cuda)
    res["steps_per_s"] = {p: t["steps_per_s"] for p, t in both["timed"].items()}
    if cuda:
        res["profile"] = {p: {k: v for k, v in r.items() if k != "by_name"}
                          for p, r in both["profile"].items()}
    graph.release()
    del trainers, tg, tp, graph
    if args.frontier_graphs:
        fcfg = frontier_config(args.nodes)
        fdata = load_dataset(fcfg, "train", num_graphs=4, device=dev)
        tr = tt.Trainer(fcfg, fdata, device=dev, workdir=str(out / f"frontier{rank}"), mesh=mesh)
        fgraph = tt.StepGraph(tr, tr.batched.adj.shape[0])
        fgraph.begin()
        fgraph.load(tr.batched)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        fgraph.step()                            # the eager first step and the capture
        sync()
        t0 = time.perf_counter()
        fgraph.step()                            # one replay
        sync()
        replay_ms = (time.perf_counter() - t0) * 1e3
        batch = shard_graphbatch(tr.batched._map(lambda t: t[0]), mesh)
        for _ in range(2):                       # the second on this stream is timed
            t0 = time.perf_counter()
            tt.train_step(tr.state, batch, torch.zeros((), device=dev))
            sync()
        res["frontier"] = {"nodes": args.nodes, "replay_ms": replay_ms,
                           "eager_ms": (time.perf_counter() - t0) * 1e3,
                           "capture_s": fgraph.capture_s,
                           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None}
        # the graph goes before the process group: on four cards the group's
        # teardown did not return while a graph holding its collectives
        # lived (ROADMAP §3, fault 3.8)
        fgraph.release()
        del fgraph, tr
        gc.collect()
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def teardown_worker(args) -> None:
    """One rank of ``--part teardown`` on the mesh ``--mesh d m``:
    ``Trainer.run`` of the frontier at ``--nodes`` N, f32, by the default
    dispatch, failing at its first checkpoint (after the eager step, the
    capture and a replay), then the process group's teardown as the CLI
    makes it, in a ``finally`` with the error's traceback still held;
    writes ``<out>/rank<r>.json`` with the seconds the teardown took."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import frontier_config

    import torch.distributed as dist

    from snd_vae_tpu_torch import train as tt
    from snd_vae_tpu_torch.data.loaders import load_dataset
    from snd_vae_tpu_torch.parallel import initialize_distributed, make_mesh

    if args.device == "cpu":
        torch.set_num_threads(1)
    d, m = args.mesh
    rank = initialize_distributed(device=args.device)
    mesh = make_mesh(d, m, args.device)
    dev = torch.device(f"cuda:{torch.cuda.current_device()}") if args.device == "cuda" \
        else torch.device("cpu")
    out = Path(args.teardown_worker)
    cfg = frontier_config(args.nodes)
    data = load_dataset(cfg, "train", num_graphs=4, device=dev)
    tr = tt.Trainer(cfg, data, device=dev, workdir=str(out / f"run{rank}"), mesh=mesh)
    made, step_graph = [], tt.StepGraph
    tt.StepGraph = lambda *a: made.append(step_graph(*a)) or made[-1]

    def fail(epoch):
        raise OSError("no space left on device")

    tr._save = fail
    res = {"rank": rank, "mesh": [d, m], "nodes": args.nodes}
    try:
        try:
            tr.run(1, verbose=False)
        finally:
            res.update(replays=made[0].replays if made else None,
                       graph_freed=bool(made) and made[0].graph is None)
            t0 = time.perf_counter()
            dist.destroy_process_group()
            res["teardown_s"] = time.perf_counter() - t0
    except OSError as e:
        res["raised"] = str(e)
    (out / f"rank{rank}.json").write_text(json.dumps(res))


def teardown(args, mesh) -> dict:
    """``--part teardown``: its ranks under torchrun, which must all end
    within ``TEARDOWN_LIMIT_S`` (else they are killed and this raises)."""
    d, m = mesh
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(d * m), str(Path(__file__).resolve()),
               "--teardown-worker", tmp, "--mesh", str(d), str(m), "--nodes", str(args.nodes),
               "--device", args.device]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True, start_new_session=True,
                                env=dict(os.environ, PYTHONPATH=str(ROOT)))
        try:
            _, err = proc.communicate(timeout=TEARDOWN_LIMIT_S)
        except subprocess.TimeoutExpired:
            proc.terminate()                  # torchrun ends its ranks (SIGKILL after 30 s)
            try:
                proc.communicate(timeout=45)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
            raise RuntimeError(f"teardown {d}x{m}: the ranks did not end within "
                               f"{TEARDOWN_LIMIT_S} s")
        ranks = [json.loads(f.read_text()) for f in sorted(Path(tmp).glob("rank*.json"))]
        res = {"run": f"teardown_{d}x{m}", "seconds": time.perf_counter() - t0,
               "rc": proc.returncode, "ranks": ranks}
        print(json.dumps(res), flush=True)
        if proc.returncode != 0 or len(ranks) != d * m or not all(
                r.get("raised") and "teardown_s" in r
                and (args.device == "cpu" or (r["graph_freed"] and r["replays"] == 1))
                for r in ranks):
            raise RuntimeError(f"teardown {d}x{m}: {res}\n{err[-2000:]}")
    return res


def graphs(args, meshes) -> dict:
    """``--part graphs``: each mesh under torchrun, the frontier's replayed
    step on (1, 4) with 4 cards."""
    runs = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for d, m in meshes:
            wd = Path(tmp) / f"graphs_{d}x{m}"
            wd.mkdir()
            frontier_too = (d, m) == (1, 4)
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", str(d * m), str(Path(__file__).resolve()),
                   "--graphs-worker", str(wd), "--mesh", str(d), str(m), "--nodes",
                   str(args.nodes), "--device", args.device] + (
                       ["--frontier-graphs"] if frontier_too else [])
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900,
                                  env=dict(os.environ, PYTHONPATH=str(ROOT)))
            if proc.returncode != 0:
                # the ranks' own errors come before torchrun's summary
                errors = [ln for ln in proc.stderr.splitlines() if "Error" in ln]
                raise RuntimeError(f"{cmd} exited {proc.returncode}: {errors[:12]}\n"
                                   f"{proc.stderr[-2000:]}")
            ranks = [json.loads((wd / f"rank{r}.json").read_text()) for r in range(d * m)]
            name = f"graphs_{d}x{m}"
            runs[name] = ranks
            print(json.dumps({"run": name, "seconds": time.perf_counter() - t0,
                              "ranks": ranks}), flush=True)
            bad = [r["rank"] for r in ranks if not (r["state_equal"] and r["aux_equal"])]
            if bad:
                raise RuntimeError(f"{name}: the dispatches differ on ranks {bad}")
    return runs


def frontier(args, meshes) -> dict:
    """``--part frontier``: one process, then each mesh under torchrun."""
    runs = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for m in [1] + [m for d, m in meshes if d == 1]:
            wd = Path(tmp) / f"frontier_1x{m}"
            wd.mkdir()
            me = [sys.executable, str(Path(__file__).resolve()), "--frontier-worker", str(wd),
                  "--nodes", str(args.nodes), "--device", args.device]
            cmd = me if m == 1 else [sys.executable, "-m", "torch.distributed.run",
                                     "--standalone", "--nproc_per_node", str(m), *me[1:]]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900,
                                  env=dict(os.environ, PYTHONPATH=str(ROOT)))
            if proc.returncode != 0:
                raise RuntimeError(f"{cmd} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
            ranks = [torch.load(wd / f"rank{r}.pt", weights_only=False) for r in range(m)]
            name = f"frontier_1x{m}"
            runs[name] = ranks
            print(json.dumps({"run": name, "nodes": args.nodes, "seconds":
                              time.perf_counter() - t0, "loss": ranks[0]["loss"],
                              "ms_per_rank": [r["ms"] for r in ranks],
                              "peak_gb_per_rank": [r["peak_gb"] for r in ranks]}), flush=True)
            if len({r["loss"] for r in ranks}) != 1:
                raise RuntimeError(f"{name}: the ranks' losses {[r['loss'] for r in ranks]}")
            if m == 1:
                continue
            want, got = runs["frontier_1x1"][0], ranks[0]
            if not abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"]):
                raise RuntimeError(f"{name}: loss {got['loss']} vs one process's {want['loss']}")
            worst = {}
            for n, g in want["grads"].items():
                scale = g.abs().max().item()
                gap = (got["grads"][n] - g).abs() - 1e-4 * g.abs()
                worst[n] = gap.max().item() / scale if scale else gap.max().item()
                if not torch.allclose(got["grads"][n], g, rtol=1e-4, atol=3e-4 * scale):
                    raise RuntimeError(f"{name}: gradient {n} off by {worst[n]} of its largest")
            print(json.dumps({"run": name, "gradients_equal": len(worst),
                              "largest_gap_over_scale": max(worst.values())}), flush=True)
    return runs


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cards", type=int, default=4, choices=(2, 4))
    p.add_argument("--part", default="all", choices=("all", "synthetic2", "frontier", "graphs", "teardown"))
    p.add_argument("--nodes", type=int, default=1024, help="the frontier's N")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cpu: gloo ranks on the host (--part frontier), a rehearsal")
    p.add_argument("--frontier-worker", help=argparse.SUPPRESS)
    p.add_argument("--graphs-worker", help=argparse.SUPPRESS)
    p.add_argument("--teardown-worker", help=argparse.SUPPRESS)
    p.add_argument("--mesh", type=int, nargs=2, help=argparse.SUPPRESS)
    p.add_argument("--frontier-graphs", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.frontier_worker:
        frontier_worker(args)
        return 0
    if args.graphs_worker:
        graphs_worker(args)
        return 0
    if args.teardown_worker:
        teardown_worker(args)
        return 0
    if args.device == "cuda" and torch.cuda.device_count() < args.cards:
        print(f"tp_cards: needs {args.cards} CUDA cards, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 1
    cli = ["-m", "snd_vae_tpu_torch.cli", "--type", "train", "--epochs", str(EPOCHS),
           "--dataset-path", str(ROOT / "dataset")]
    meshes = [(1, 2)] + ([(1, 4), (2, 2)] if args.cards == 4 else [])
    out = {}
    os.makedirs(ROOT / "build", exist_ok=True)
    if args.part in ("graphs", "teardown") and args.device == "cuda":
        sys.path.insert(0, str(ROOT))
        from snd_vae_tpu_torch.nn.kernels import build

        build.build()                         # once, before the ranks load the kernels
    if args.part == "teardown":
        teardown(args, (1, args.cards))
    if args.part == "graphs":
        graphs(args, [(2, 1), (1, 2)] + ([(4, 1), (2, 2), (1, 4)] if args.cards == 4 else []))
    if args.part in ("all", "frontier"):
        frontier(args, meshes)
    if args.part in ("frontier", "graphs", "teardown"):
        meshes = []
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        if meshes:
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
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
