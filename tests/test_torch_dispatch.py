"""The port's training dispatch (``snd_vae_tpu_torch.train``: ``StepGraph``,
``Trainer.graph_epochs``, ``Trainer.chunk_end``, ``Trainer.run``'s
``per_step`` / ``epoch_chunk``, the CLI's ``--per-step`` / ``--epoch-chunk``)
on the CPU at small synthetic2 widths, torch on one thread.

On the CPU ``StepGraph`` runs the body the card captures
(static batches, the device batch index, global_iter derived from the
device step count, the aux values written into the chunk's buffer) eagerly:
it equals ``run_epoch``'s per-batch ``train_step`` bit for bit, and JAX's
``make_epoch_step`` epoch within the lockstep test's 2e-3.  Chunks of
epochs end where the JAX trainer's ``_run_chunked`` ends them.  The card's
capture and replay are ``tests/test_torch_cuda.py``'s and
``chip_smoke.py``'s ``graphs`` phase's."""

import contextlib
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict
from torch_parity import configs, init_like
from torch_parity import one_thread  # noqa: F401  (fixture)

from snd_vae_tpu import train as jtrain
from snd_vae_tpu.data.graphbatch import from_numpy as jax_batch
from snd_vae_tpu.models import build_model as jax_build_model
from snd_vae_tpu_torch import cli
from snd_vae_tpu_torch import train as ttrain
from snd_vae_tpu_torch.data.loaders import load_dataset
from snd_vae_tpu_torch.models import Latents
from snd_vae_tpu_torch.params import state_dict_from_flax

pytestmark = pytest.mark.usefixtures("one_thread")


def _with_train(cfg, **kw):
    return cfg.with_(train=dataclasses.replace(cfg.train, **kw))


def _trainer(tmp_path, num_graphs=20, eval_graphs=0, **train):
    _, tc = configs("small")
    tc = _with_train(tc, checkpoint_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "logs"),
                     **train)
    data = load_dataset(tc, "train", num_graphs=num_graphs, device="cpu")
    held = load_dataset(tc, "test", num_graphs=eval_graphs, device="cpu") if eval_graphs else None
    return ttrain.Trainer(tc, data, device="cpu", workdir=str(tmp_path), eval_batch=held)


def _state(tr):
    st = tr.state
    opt = st.optimizer.state_dict()["state"]
    return ([p.detach().clone() for p in st.model.parameters()],
            {i: {k: v.clone() for k, v in s.items()} for i, s in opt.items()},
            st.step, st.generator.get_state())


def _assert_same_state(a, b):
    (pa, oa, sa, ga), (pb, ob, sb, gb) = a, b
    assert sa == sb
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    assert oa.keys() == ob.keys() and len(oa) == len(pa)
    for i in oa:
        assert oa[i].keys() == ob[i].keys() == {"step", "exp_avg", "exp_avg_sq"}
        assert all(torch.equal(oa[i][k], ob[i][k]) for k in oa[i]), i
    assert torch.equal(ga, gb)


@pytest.mark.parametrize("train", [dict(), dict(reshuffle=True), dict(resample_trees_every=1)])
@pytest.mark.parametrize("chunk", [1, 2])
def test_graph_body_equals_train_step(tmp_path, train, chunk):
    """Two epochs through the step body (one chunk of 2, or two of 1),
    run eagerly, against ``run_epoch``: every per-step aux value, every
    parameter, the Adam moments and counts, the step and the generator of
    ε bit for bit; with ``reshuffle`` each epoch's batches are a new
    permutation, with ``resample_trees_every=1`` epoch 1 trains on new
    spanning trees, each copied into the static batches."""
    got, want = (_trainer(tmp_path / n, **train) for n in ("graph", "step"))
    nb = got.batched.adj.shape[0]
    graph = ttrain.StepGraph(got, chunk * nb)
    storers = []
    for e in range(0, 2, chunk):
        storers += got.graph_epochs(graph, range(e, e + chunk))
    assert storers == [want.run_epoch(0), want.run_epoch(1)]
    assert len(storers[0]["loss"]) == nb == 2 and storers[0]["loss"] != storers[1]["loss"]
    assert graph.keys == list(storers[0]) and graph.aux.shape == (chunk * nb, len(graph.keys))
    assert int(graph.count) == got.state.step == 2 * nb and int(graph.row) == chunk * nb
    assert torch.equal(graph.data.adj_samples, got.batched.adj_samples) != bool(
        train.get("reshuffle"))
    _assert_same_state(_state(got), _state(want))


def test_graph_body_reads_each_batch(tmp_path, monkeypatch):
    """The body's batch follows its device row: with the static batches
    replaced by distinct ones in between, the next step reads the new
    batch at row mod nb and derives global_iter from the device count."""
    tr = _trainer(tmp_path)
    graph = ttrain.StepGraph(tr, 4)
    seen = []
    step = ttrain.train_step
    monkeypatch.setattr(ttrain, "train_step", lambda st, b, gi: (
        seen.append((b.adj.clone(), float(gi))), step(st, b, gi))[1])
    graph.begin()
    graph.load(tr.batched)
    for _ in range(3):
        graph.step()
    adj = tr.batched.adj
    assert [torch.equal(a, adj[i % 2]) for (a, _), i in zip(seen, range(3))] == [True] * 3
    assert [gi for _, gi in seen] == [0.0, 0.0, 1.0]


def test_graph_epoch_matches_jax_epoch(tmp_path, monkeypatch):
    """One epoch of the step body from the same f32 parameters and ε as
    JAX's ``make_epoch_step`` (tf1-adam; ε as its scan body draws it from
    the state's key): every step's cost within the lockstep test's 2e-3
    relative, and so the next epoch's first step too."""
    jc, tc = configs("small")
    jc, tc = (_with_train(c, optimizer="tf1-adam") for c in (jc, tc))
    data = load_dataset(tc, "train", num_graphs=20, device="cpu")
    arrays = {k: v.numpy() for k, v in vars(data).items() if v is not None}
    jm = jax_build_model(jc)
    small = jax_batch(**{k: v[:2] for k, v in arrays.items()})
    shapes = jax.eval_shape(lambda k: jm.init(k, small, key=k), jax.random.PRNGKey(0))["params"]
    flat = {k: v.astype(np.float32) for k, v in init_like(shapes, np.random.default_rng(1)).items()}
    params = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    opt = jtrain.make_optimizer(jc)
    state = jtrain.TrainState(params=params, opt_state=opt.init(params),
                              step=jnp.zeros((), jnp.int32), key=jax.random.PRNGKey(3))
    key = jax.random.PRNGKey(3)
    # the ε each step of the scan draws: key, step_key = split(key), then
    # reparameterize's split(step_key, 3) in the order s, sg, g
    stats = jax.eval_shape(lambda p, b: jm.apply({"params": p}, b, method=type(jm).encode),
                           params, jax_batch(**{k: v[:jc.train.batch_size]
                                                for k, v in arrays.items()}))
    eps = []
    nb, epochs = data.batch_size // jc.train.batch_size, 2
    for _ in range(epochs * nb):
        key, step_key = jax.random.split(key)
        k_s, k_sg, k_g = jax.random.split(step_key, 3)
        normal = lambda k, s: torch.from_numpy(np.asarray(jax.random.normal(k, s.shape, s.dtype)))
        eps.append(Latents(z_s=normal(k_s, stats.mean_s), z_sg=normal(k_sg, stats.mean_sg),
                           z_g=normal(k_g, stats.mean_g)))

    epoch_step = jtrain.make_epoch_step(jc, jm, opt)
    batched = jtrain.rebatch(jax_batch(**arrays), jc.train.batch_size)
    want = []
    for _ in range(epochs):
        state, aux = epoch_step(state, batched)
        want.append(np.asarray(aux["loss"]))

    tr = ttrain.Trainer(tc, data, device="cpu", workdir=str(tmp_path))
    assert not tr.state.model.load_state_dict(state_dict_from_flax(flat)).missing_keys
    stream = iter(eps)
    step = ttrain.train_step
    monkeypatch.setattr(ttrain, "train_step",
                        lambda st, b, gi: step(st, b, gi, eps=next(stream)))
    graph = ttrain.StepGraph(tr, nb)
    got = [np.asarray(s["loss"]) for e in range(epochs)
           for s in tr.graph_epochs(graph, range(e, e + 1))]
    gap = np.abs(np.asarray(got) - np.asarray(want)) / np.abs(np.asarray(want))
    assert gap.max() < 2e-3, (got, want)
    assert abs(want[1].mean() - want[0].mean()) > 1e-4    # the trajectory moves


def _jax_chunked(jc, epochs, epoch_chunk, has_eval, tmp_path):
    """JAX's ``Trainer._run_chunked`` on a stand-in trainer: the epochs it
    dispatches in each chunk, saves, evaluates (its own ``_maybe_eval``)
    and logs."""
    seen = {"chunks": [], "saves": [], "evals": [], "logs": []}
    aux = {"loss": np.zeros(2, np.float32)}

    def multi(state, batched, n):
        seen["chunks"].append(n)
        return state, {"loss": np.zeros(n, np.float32)}

    def one(state, batched):
        seen["chunks"].append(1)
        return state, aux

    recorder = lambda name: types.SimpleNamespace(
        log=lambda e, row: seen[name].append(e) or {k: v[0] for k, v in row.items()},
        save=lambda e, state: seen[name].append(e))
    ns = types.SimpleNamespace(
        cfg=jc, state=None, batched=None, maybe_restore=lambda: 0, epoch_step=one,
        multi_epoch_step=multi, _mesh_scope=contextlib.nullcontext,
        _maybe_resample_trees=lambda e: None, logger=recorder("logs"),
        checkpointer=recorder("saves"), eval_batch=object() if has_eval else None,
        evaluate_heldout=lambda: {"edge_auc": 0.5}, eval_logger=recorder("evals"),
        _best_ckpt=recorder("saves_best"), _best_path=str(tmp_path / "best.json"),
        _best_value=None)
    seen["saves_best"] = []
    ns._maybe_eval = types.MethodType(jtrain.Trainer._maybe_eval, ns)
    jtrain.Trainer._run_chunked(ns, epochs, False, epoch_chunk)
    return seen


def _port_chunked(tr, epochs, **run):
    """The port's run: the chunks ``chunk_end`` gave, and the epochs of
    its checkpoints, evaluations and log lines."""
    chunks = []
    end = tr.chunk_end
    tr.chunk_end = lambda e, n, c: (lambda s: chunks.append(s - e) or s)(end(e, n, c))
    tr.run(epochs, verbose=False, **run)
    evals = sorted({int(r.split(",")[0]) for r in open(tr.eval_logger.path).read()
                    .splitlines()[1:]}) if tr.eval_batch is not None else []
    logs = [json.loads(line)["epoch"] for line in open(tr.logger.jsonl_path)]
    return {"chunks": chunks, "saves": tr.checkpointer.steps(), "evals": evals, "logs": logs}


@pytest.mark.parametrize("has_eval", [True, False])
def test_chunks_land_like_jax(tmp_path, has_eval):
    """``Trainer.run(12, epoch_chunk=3)`` with checkpoint_every=2,
    eval_every=3 and resample_trees_every=4: chunks, checkpoints,
    evaluations and log lines on JAX ``_run_chunked``'s epochs (its
    ``max_dispatch_s`` probe off: the port has no dispatch limit), and the
    checkpoints, evaluations and logs of ``epoch_chunk=1``."""
    kw = dict(checkpoint_every=2, eval_every=3, resample_trees_every=4)
    jc, _ = configs("small")
    jc = _with_train(jc, max_dispatch_s=0.0, **kw)
    want = _jax_chunked(jc, 12, 3, has_eval, tmp_path)
    eval_graphs = 10 if has_eval else 0
    got = _port_chunked(_trainer(tmp_path / "c3", 10, eval_graphs, batch_size=10, **kw), 12,
                        epoch_chunk=3)
    assert got == {k: want[k] for k in got}
    # the eval cadence ends the chunks at epochs 3 and 9 (after 8: 9 alone)
    assert want["chunks"] == ([1, 2, 1, 1, 2, 1, 1, 1, 1, 1] if has_eval
                              else [1, 2, 1, 1, 2, 1, 1, 2, 1])
    assert got["evals"] == ([3, 6, 9] if has_eval else [])
    one = _port_chunked(_trainer(tmp_path / "c1", 10, eval_graphs, batch_size=10, **kw), 12)
    assert one["chunks"] == [1] * 12
    assert {k: v for k, v in one.items() if k != "chunks"} == {
        k: v for k, v in got.items() if k != "chunks"}


@pytest.mark.parametrize("run", [dict(per_step=True), dict(profile_dir="profile"),
                                 dict()])
def test_epoch_chunk_is_ignored_per_step_and_profiled(tmp_path, run):
    """``epoch_chunk=2`` over 4 epochs: under ``per_step`` and
    ``profile_dir`` every chunk is one epoch, as in JAX; otherwise chunks
    of 2 (on the CPU each epoch still runs per step, ``run_epoch``)."""
    if "profile_dir" in run:
        run = dict(profile_dir=str(tmp_path / "profile"))
    tr = _trainer(tmp_path, 10, batch_size=10, checkpoint_every=100)
    epochs = []
    run_epoch = tr.run_epoch
    tr.run_epoch = lambda e: epochs.append(e) or run_epoch(e)
    got = _port_chunked(tr, 4, epoch_chunk=2, **run)
    assert got["chunks"] == ([1, 2, 1] if not run else [1, 1, 1, 1])
    assert got["logs"] == [0, 1, 2, 3] and got["saves"] == [0]
    assert epochs == [0, 1, 2, 3]


def test_cpu_run_takes_no_graph(tmp_path, monkeypatch):
    """On the CPU the default dispatch is per step: no ``StepGraph`` is
    made, and the run equals ``per_step=True``'s bit for bit."""
    monkeypatch.setattr(ttrain, "StepGraph", None)
    a, b = _trainer(tmp_path / "a"), _trainer(tmp_path / "b")
    assert a.run(2, verbose=False) == b.run(2, verbose=False, per_step=True)
    _assert_same_state(_state(a), _state(b))


@pytest.mark.parametrize("argv, want", [
    ([], dict(per_step=False, epoch_chunk=1)),
    (["--per-step"], dict(per_step=True, epoch_chunk=1)),
    (["--epoch-chunk", "3"], dict(per_step=False, epoch_chunk=3)),
    (["--per-step", "--epoch-chunk", "2"], dict(per_step=True, epoch_chunk=2)),
])
def test_cli_passes_dispatch_flags(tmp_path, monkeypatch, argv, want):
    """``--per-step`` and ``--epoch-chunk`` reach ``Trainer.run``."""
    seen = {}

    def run(self, epochs=None, verbose=True, per_step=False, profile_dir=None, epoch_chunk=1):
        seen.update(per_step=per_step, epoch_chunk=epoch_chunk, epochs=epochs)
        return {"loss": 0.0}

    monkeypatch.setattr(ttrain.Trainer, "run", run)
    cli.main(["--type", "train", "--device", "cpu", "--epochs", "1", "--workdir",
              str(tmp_path), *argv])
    assert seen == dict(want, epochs=1)


def test_trainer_makes_cudnn_deterministic(tmp_path, monkeypatch):
    """The Trainer's steps take cuDNN's deterministic algorithms (its
    default backward-filter picks sum with atomics: two runs of one step
    differed on the card): ``train_step`` holds the setting through its
    forward and backward and puts the process's back after, and building
    a Trainer leaves it as it was."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    tr = _trainer(tmp_path)
    assert not torch.backends.cudnn.deterministic
    seen = []
    forward, loss = ttrain._forward, ttrain.elbo_loss
    monkeypatch.setattr(ttrain, "_forward", lambda *a: (
        seen.append(torch.backends.cudnn.deterministic), forward(*a))[1])
    monkeypatch.setattr(ttrain, "elbo_loss", lambda *a, **k: (
        seen.append(torch.backends.cudnn.deterministic), loss(*a, **k))[1])
    tr.run(1, verbose=False)
    assert seen == [True] * 2 * tr.batched.adj.shape[0]
    assert not torch.backends.cudnn.deterministic


def test_graph_load_copies_the_trainers_batches_once(tmp_path):
    """Without a reshuffle ``StepGraph.load`` copies the trainer's batches
    on its first call only, and again once new spanning trees replace
    them; any other batches (a reshuffle's) it copies every time."""
    tr = _trainer(tmp_path)
    graph = ttrain.StepGraph(tr, 2)
    graph.load(tr.batched)
    assert torch.equal(graph.data.adj, tr.batched.adj)
    graph.data.adj.zero_()
    graph.load(tr.batched)
    assert not graph.data.adj.any()
    other = tr.batched._map(lambda t: t.flip(0))
    graph.load(other)
    assert torch.equal(graph.data.adj, other.adj)
    graph.load(other)
    graph.load(tr.batched)
    assert torch.equal(graph.data.adj, tr.batched.adj)
    tr.batched = tr.batched._map(lambda t: t.clone())
    graph.data.adj.zero_()
    graph.load(tr.batched)
    assert torch.equal(graph.data.adj, tr.batched.adj)
