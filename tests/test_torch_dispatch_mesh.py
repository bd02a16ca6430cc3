"""The port's default training dispatch under a mesh (``train.StepGraph``
and ``Trainer.run`` with ``--dp`` / ``--tp``) on the CPU, in gloo ranks
(``tests/torch_dist_workers.py``'s ``dispatch_mesh`` job: worlds 2 and 4
started at once), at small synthetic2 widths.

On the CPU the body that the card captures runs eagerly (``StepGraph``
called directly), collectives included:

  * on meshes (2, 1), (1, 2) and (2, 2), the parameters of at least 256
    elements sliced over the model axis, 2 epochs through the body equal
    ``run_epoch``'s per-step ``train_step`` bit for bit (every aux value,
    parameter, Adam moment and count, the step and the generator), with
    and without ``reshuffle``, in one chunk of 2 epochs or two of 1; the
    body's static batches hold the rank's block of each batch alone;
  * ``Trainer.run(epoch_chunk=2)`` on (2, 1) ends its chunks, and writes
    its checkpoints, evaluations and log lines, on the epochs JAX's
    ``_run_chunked`` does;
  * at world 4 on (4, 1), one epoch and the next through the body, with
    each rank's rows of the ε that JAX's scan draws from its key, against
    JAX's ``make_epoch_step`` on the 4x1 virtual mesh under
    ``jax.set_mesh``: every step's cost within the lockstep test's 2e-3.

And the card's two guards on made-up events: ``unrecorded_kernels`` (the
device records a trace of replays must hold, worked out from the host's
launches and the graph's kernel, memcpy and memset nodes) and ``wait_for_replays`` (a chunk
whose replays stop finishing raises); and that ``Trainer.run`` frees its
graph (``StepGraph.release``) before it returns or raises.  The capture and replay themselves
run on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``dp``,
``tp`` and ``cli_dp`` phases)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict
from test_torch_dispatch import _jax_chunked, _trainer
from torch.autograd import DeviceType
from torch_dist_workers import run_many
from torch_parity import configs, init_like
from torch_parity import one_thread  # noqa: F401  (fixture)

from snd_vae_tpu import train as jtrain
from snd_vae_tpu.data.graphbatch import from_numpy as jax_batch
from snd_vae_tpu.models import build_model as jax_build_model
from snd_vae_tpu.parallel import make_mesh as jax_make_mesh
from snd_vae_tpu.parallel import shard_graphbatch as jax_shard_graphbatch
from snd_vae_tpu.parallel import shard_params as jax_shard_params
from snd_vae_tpu_torch import train as ttrain
from snd_vae_tpu_torch.data.loaders import load_dataset
from snd_vae_tpu_torch.params import state_dict_from_flax

pytestmark = pytest.mark.usefixtures("one_thread")

MESHES = {(2, 1): 2, (1, 2): 2, (2, 2): 4}
CHUNK = dict(checkpoint_every=2, eval_every=3, resample_trees_every=4)
JAX_B = 8          # (4, 1): 2 graphs a rank


def _with_train(cfg, **kw):
    return cfg.with_(train=dataclasses.replace(cfg.train, **kw))


def _body_case(mesh, reshuffle):
    cfg = _with_train(configs("small")[1], reshuffle=reshuffle)
    return {"kind": "body", "mesh": mesh, "cfg": cfg, "graphs": 20,
            "chunk": 2 if reshuffle else 1}


def _jax_case():
    """The small config with tf1-adam at B = 8 on 16 graphs: float32 flax
    parameters from a seed, and 2 epochs of JAX's ``make_epoch_step`` on
    the 4x1 mesh from them with the ε its scan draws: (the per-step costs,
    the worker's case)."""
    jc, tc = (_with_train(c, optimizer="tf1-adam", batch_size=JAX_B) for c in configs("small"))
    data = load_dataset(tc, "train", num_graphs=2 * JAX_B, device="cpu")
    arrays = {k: v.numpy() for k, v in vars(data).items() if v is not None}
    jm = jax_build_model(jc)
    small = jax_batch(**{k: v[:2] for k, v in arrays.items()})
    shapes = jax.eval_shape(lambda k: jm.init(k, small, key=k), jax.random.PRNGKey(0))["params"]
    flat = {k: v.astype(np.float32) for k, v in init_like(shapes, np.random.default_rng(1)).items()}
    params = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    opt = jtrain.make_optimizer(jc)
    mesh = jax_make_mesh(4, 1)
    params = jax_shard_params(params, mesh)
    state = jtrain.TrainState(params=params, opt_state=jax_shard_params(opt.init(params), mesh),
                              step=jnp.zeros((), jnp.int32), key=jax.random.PRNGKey(3))
    # the ε each step of the scan draws: key, step_key = split(key), then
    # reparameterize's split(step_key, 3) in the order s, sg, g
    stats = jax.eval_shape(lambda p, b: jm.apply({"params": p}, b, method=type(jm).encode),
                           params, jax_batch(**{k: v[:JAX_B] for k, v in arrays.items()}))
    key, eps, epochs = jax.random.PRNGKey(3), [], 2
    for _ in range(epochs * 2):
        key, step_key = jax.random.split(key)
        keys = jax.random.split(step_key, 3)
        eps.append({name: np.asarray(jax.random.normal(k, s.shape, s.dtype))
                    for name, k, s in zip(("z_s", "z_sg", "z_g"), keys,
                                          (stats.mean_s, stats.mean_sg, stats.mean_g))})
    epoch_step = jtrain.make_epoch_step(jc, jm, opt)
    batched = jtrain.rebatch(jax_shard_graphbatch(jax_batch(**arrays), mesh), JAX_B)
    want = []
    with jax.set_mesh(mesh):
        for _ in range(epochs):
            state, aux = epoch_step(state, batched)
            want.append(np.asarray(aux["loss"]))
    return np.asarray(want), {"kind": "jax_eps", "mesh": (4, 1), "cfg": tc,
                              "graphs": 2 * JAX_B, "epochs": epochs, "eps": eps,
                              "state_dict": state_dict_from_flax(flat)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Worlds 2 and 4 at once: every body case on its mesh, the chunked
    run on (2, 1) (world 2), the JAX case on (4, 1) (world 4)."""
    cases = {2: {}, 4: {}}
    for mesh, world in MESHES.items():
        for reshuffle in (False, True):
            cases[world][("body", mesh, reshuffle)] = _body_case(mesh, reshuffle)
    chunk_cfg = _with_train(configs("small")[1], batch_size=10, **CHUNK)
    cases[2]["chunked"] = {"kind": "chunked", "mesh": (2, 1), "cfg": chunk_cfg, "graphs": 10,
                           "eval_graphs": 10, "epochs": 12, "epoch_chunk": 2}
    want, cases[4]["jax"] = _jax_case()
    outs = run_many([("dispatch_mesh", w, tmp_path_factory.mktemp(f"dispatch{w}"),
                      {"cases": cases[w], "min_size": 256}) for w in (2, 4)], timeout=600)
    return dict(zip((2, 4), outs)), want


def _assert_same_state(a, b):
    (pa, oa, sa, ga), (pb, ob, sb, gb) = a, b
    assert sa == sb
    assert len(pa) == len(pb) and all(torch.equal(x, y) for x, y in zip(pa, pb))
    assert oa.keys() == ob.keys() and oa
    for i in oa:
        assert oa[i].keys() == ob[i].keys() == {"step", "exp_avg", "exp_avg_sq"}
        assert all(torch.equal(oa[i][k], ob[i][k]) for k in oa[i]), i
    assert torch.equal(ga, gb)


@pytest.mark.parametrize("reshuffle", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_graph_body_under_mesh_equals_run_epoch(worlds, mesh, reshuffle):
    """Every rank: the body's 2 epochs equal ``run_epoch``'s bit for bit,
    and the ranks agree; the static batches hold the rank's block of each
    batch (B / d graphs); under a model axis some parameters are slices,
    and those are among the model's parameters (whose ``.grad``
    ``StepGraph`` restores after a chunk)."""
    outs, _ = worlds
    d, m = mesh
    ranks = [o[("body", mesh, reshuffle)] for o in outs[MESHES[mesh]]]
    for r in ranks:
        assert r["graph"] == r["step"]
        assert len(r["graph"][0]["loss"]) == 2 and r["graph"][0]["loss"] != r["graph"][1]["loss"]
        _assert_same_state(r["graph_state"], r["step_state"])
        assert r["block"][:2] == (2, 10 // d) and r["count"] == 4
        assert bool(r["sliced"]) == (m > 1) and r["slices_are_parameters"]
    assert all(r["graph"] == ranks[0]["graph"] for r in ranks)


def test_chunks_under_mesh_land_like_jax(worlds, tmp_path):
    """``Trainer.run(12, epoch_chunk=2)`` on (2, 1) with checkpoint_every=2,
    eval_every=3 and resample_trees_every=4: chunks, checkpoints,
    evaluations and log lines on JAX ``_run_chunked``'s epochs (rank 0
    writes them; both ranks take the same chunks)."""
    outs, _ = worlds
    jc = _with_train(configs("small")[0], batch_size=10, max_dispatch_s=0.0, **CHUNK)
    want = _jax_chunked(jc, 12, 2, True, tmp_path)
    r0, r1 = (o["chunked"] for o in outs[2])
    assert r0 == {k: want[k] for k in r0}
    assert r1 == {"chunks": r0["chunks"]}
    # chunks of 2 where no checkpoint, evaluation or tree draw ends one
    assert r0["chunks"] == [1, 2, 1, 1, 2, 1, 1, 1, 1, 1] and r0["evals"] == [3, 6, 9]


def test_world4_body_matches_jax_epoch_on_4x1_mesh(worlds):
    """World 4 on (4, 1): 2 epochs of the body from JAX's f32 parameters,
    each rank on its 2 graphs of every batch with its rows of JAX's ε,
    against ``make_epoch_step`` on the 4x1 mesh: every step's cost within
    2e-3 relative on every rank, and the trajectory moves."""
    outs, want = worlds
    for o in outs[4]:
        got = np.asarray(o["jax"])
        gap = np.abs(got - want) / np.abs(want)
        assert got.shape == want.shape == (2, 2) and gap.max() < 2e-3, (got, want)
    assert abs(want[1].mean() - want[0].mean()) > 1e-4


class _Event:
    def __init__(self, name, corr, device=False, start=0, end=None, linked=0):
        self._name, self._corr, self._linked = name, corr, linked
        self._dev = DeviceType.CUDA if device else DeviceType.CPU
        self._start, self._end = start, start if end is None else end

    def name(self):
        return self._name

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end


def _trace(drop_graph_record=False, drop_eager=False, copy_as_kernel=False):
    """Host and device events of a window: two eager launches (one before
    the capture, one after) and an eager memcpy, a capture range holding
    two launches that leave no record, two graph replays of 3 kernel nodes
    and a memset node each (its record a memset, or, for a graph
    instantiated before tracing began, a kernel)."""
    ev = [_Event("cudaLaunchKernel", 1, start=10), _Event("k_first", 1, device=True),
          _Event(ttrain.CAPTURE_RANGE, 0, start=20, end=30),
          _Event("cudaLaunchKernel", 2, start=22), _Event("cuLaunchKernelEx", 3, start=25),
          _Event("cudaLaunchKernel", 4, start=40),
          _Event("cudaMemcpyAsync", 5, start=41), _Event("Memcpy DtoH", 5, device=True)]
    if not drop_eager:
        ev.append(_Event("k_after", 4, device=True, linked=4))
    for corr, start in ((6, 50), (7, 60)):
        ev.append(_Event("cudaGraphLaunch", corr, start=start))
        kernels = 2 if drop_graph_record and corr == 7 else 3
        ev += [_Event(f"k{j}", corr, device=True) for j in range(kernels)]
        ev.append(_Event("memset32" if copy_as_kernel else "Memset (Device)", corr, device=True))
    return ev


@pytest.mark.parametrize("case, want", [
    (dict(), (2 + 2 * 4, 0)),
    (dict(copy_as_kernel=True), (10, 0)),
    (dict(drop_graph_record=True), (10, 1)),
    (dict(drop_eager=True), (10, 1)),
])
def test_unrecorded_kernels_counts_replays(case, want):
    """The device records a window must hold: its eager launches outside
    the capture (the capture's launches run nothing) and, for each replay,
    the graph's kernel, memcpy and memset nodes (4), from the graph and the
    caller's count, never from the records; a copy node's record counts
    as a memset or as a kernel; one record missing from a replay, or an
    eager launch without a record, is counted."""
    assert ttrain.unrecorded_kernels(_trace(**case), replays=2, per_replay=4) == want


def test_unrecorded_kernels_counts_unseen_replays():
    """A replay the caller made whose graph launch the host events do not
    show lacks all its records; without replays only eager launches
    count."""
    assert ttrain.unrecorded_kernels(_trace(), replays=3, per_replay=4) == (14, 4)
    assert ttrain.unrecorded_kernels(_trace()) == (2, 0)


class _Done:
    def __init__(self, polls):
        self.polls = polls

    def query(self):
        self.polls -= 1
        return self.polls < 0


def test_wait_for_replays_raises_on_a_stall(monkeypatch):
    """Replays that keep finishing are waited for however long the chunk
    takes; one that does not finish within the stall time aborts the
    process groups and raises, naming the replay."""
    aborted = []
    monkeypatch.setattr(ttrain, "_abort_groups", lambda: aborted.append(True))
    ttrain.wait_for_replays([_Done(3) for _ in range(4)], stall_s=5.0)
    assert not aborted
    with pytest.raises(RuntimeError, match="replay 1 of the chunk's 3 did not finish"):
        ttrain.wait_for_replays([_Done(0), _Done(10 ** 9), _Done(0)], stall_s=0.05)
    assert aborted == [True]


class _CapturedGraph:
    """Stands in for the captured ``torch.cuda.CUDAGraph``."""

    def __init__(self):
        self.resets = 0

    def reset(self):
        self.resets += 1


@pytest.mark.parametrize("fails", [False, True])
def test_run_frees_its_graph_on_return_and_on_error(tmp_path, monkeypatch, fails):
    """``Trainer.run`` frees its ``StepGraph``'s captured graph (``reset``,
    and drops the graph and the gradients' list) before it returns, and
    before an error raised after the capture leaves it, whose traceback
    would keep the graph alive into the caller's ``destroy_process_group``
    (fault 3.8).  The run takes the card's dispatch; on the CPU the graph's
    body runs eagerly and a stand-in holds the captured graph's place."""
    tr = _trainer(tmp_path)
    made = []

    class Graph(ttrain.StepGraph):
        def __init__(self, trainer, rows):
            trainer.device = torch.device("cpu")
            super().__init__(trainer, rows)
            self.graph, self.grads = _CapturedGraph(), []
            made.append((self, self.graph))

    monkeypatch.setattr(ttrain, "StepGraph", Graph)
    monkeypatch.setattr(tr, "device", torch.device("cuda"))
    if fails:
        monkeypatch.setattr(tr, "_save", lambda epoch: (_ for _ in ()).throw(OSError("full")))
        with pytest.raises(OSError, match="full"):
            tr.run(2, verbose=False)
    else:
        tr.run(2, verbose=False)
    ((graph, captured),) = made
    assert captured.resets == 1 and graph.graph is None and graph.grads is None
    assert tr.state.step == (2 if fails else 4)
