"""Spans inside the port (``snd_vae_tpu_torch.spans``) on the CPU at small
synthetic2 widths, torch on one thread: the step's stamps (there
``time.perf_counter_ns()``, on the card ``%globaltimer``), the epoch loop's
host spans (``Trainer.counters``), what ``Trainer.run(profile_dir=...)``
writes of both, and the model's profiler ranges.  A stamped run trains
bit for bit as an unstamped one; the card's stamp kernel and its captured
graph are ``tests/test_torch_cuda.py``'s."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_parity import configs
from torch_parity import one_thread  # noqa: F401  (fixture)

from snd_vae_tpu_torch import serve, spans
from snd_vae_tpu_torch import train as ttrain
from snd_vae_tpu_torch.data.loaders import load_dataset
from snd_vae_tpu_torch.models import build_model

pytestmark = pytest.mark.usefixtures("one_thread")

OLD_KEYS = ("host_launches", "graph_replays", "kernels_per_replay", "copies_per_replay",
            "launches_without_device_record")


def _cfg(model_type="disentangled", compute_dtype="float32", remat=False, **train):
    _, tc = configs("small")
    return tc.with_(model_type=model_type, compute_dtype=compute_dtype, remat=remat,
                    train=dataclasses.replace(tc.train, **train))


def _trainer(tmp_path, cfg, eval_graphs=0):
    data = load_dataset(cfg, "train", num_graphs=20, device="cpu")
    held = load_dataset(cfg, "test", num_graphs=eval_graphs, device="cpu") if eval_graphs else None
    return ttrain.Trainer(cfg, data, device="cpu", workdir=str(tmp_path), eval_batch=held)


def _state(tr):
    st = tr.state
    return ([p.detach().clone() for p in st.model.parameters()],
            [{k: v.clone() for k, v in st.optimizer.state[p].items()}
             for p in st.model.parameters()], st.step, st.generator.get_state())


def _logs(tr):
    with open(tr.logger.jsonl_path) as f:     # each epoch's means, its clock aside
        return [dict(json.loads(line), time=None) for line in f]


def _launches(profile_dir):
    with open(profile_dir / "trace_rank0.launches.json") as f:
        return json.load(f)


CASES = {
    "disentangled": dict(),
    "base_dropout": dict(model_type="base", dropout_keep_prob=0.8),
    "remat": dict(remat=True),
    "bf16": dict(compute_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stamped_run_equals_an_unstamped_one(tmp_path, case):
    """3 epochs of ``Trainer.run`` with ``profile_dir`` (every step stamped)
    against 3 without: every epoch's losses, every parameter, the Adam
    moments and counts, the step and the generator bit for bit; every
    stamp of the traced epoch's 2 steps was taken, in ``STAMPS``' order
    (a recomputed region under ``remat`` stamps no second time)."""
    kw = dict(CASES[case])
    cfg = _cfg(model_type=kw.pop("model_type", "disentangled"),
               compute_dtype=kw.pop("compute_dtype", "float32"), remat=kw.pop("remat", False),
               **kw)
    runs = {}
    for name, profile_dir in (("stamped", tmp_path / "stamped" / "profile"),
                              ("unstamped", None)):
        tr = _trainer(tmp_path / name, cfg)
        tr.run(3, verbose=False, profile_dir=None if profile_dir is None else str(profile_dir))
        runs[name] = (_logs(tr), _state(tr))
    (logs, state), (want_logs, want) = runs["stamped"], runs["unstamped"]
    assert logs == want_logs and len(logs) == 3
    (pa, oa, sa, ga), (pb, ob, sb, gb) = state, want
    assert sa == sb and torch.equal(ga, gb)
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    assert all(torch.equal(x[k], y[k]) for x, y in zip(oa, ob) for k in x)
    steps = np.array(_launches(tmp_path / "stamped" / "profile")["spans"]["steps_ns"])
    assert steps.shape == (2, len(spans.STAMPS))
    assert (steps[:, 0] == 0).all() and (np.diff(steps, axis=1) > 0).all()


def test_mark_passes_gradients_through_untouched():
    """``marked`` inside ``stamping``: the same values, and the gradients
    of a loss through it bit-equal to the loss's without it (``x`` read
    twice, so its gradient arrives in two parts); the forward stamp taken
    at the call, the backward's once the whole gradient is there.  Outside
    ``stamping`` it hands back its input itself."""
    g = torch.Generator().manual_seed(0)
    x, y = (torch.randn(5, 3, generator=g, requires_grad=True) for _ in range(2))

    def loss(a, b):
        return (a.sin() * a).sum() + (a @ b.T).square().sum()

    want = torch.autograd.grad(loss(x, y), (x, y))
    stamps = spans.Stamps(1, torch.zeros((), dtype=torch.int64))
    k = spans.INDEX
    with spans.stamping(stamps):
        mx = spans.marked("adj_head.forward.start", "adj_head.backward.end", x)
        assert torch.equal(mx, x) and mx is not x
        start = int(stamps.times[0, k["adj_head.forward.start"]])
        assert start > 0 and stamps.times[0, k["adj_head.backward.end"]] == 0
        got = torch.autograd.grad(loss(mx, y), (x, y))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert stamps.times[0, k["adj_head.backward.end"]] > start
    assert stamps.launched == 2 and int((stamps.times != 0).sum()) == 2
    assert spans.marked("step.start", "step.end", x) is x


def test_after_grads_stamps_once_every_parameter_has_its_gradient():
    """``after_grads`` called in a module's forward stamps once the
    backward has computed the gradient of each parameter the module reads
    (the casts under ``torch.func.functional_call``), once, and its hook is
    gone after ``stamping``; outside ``stamping`` it registers nothing.  It
    keeps no gradient: each leaf's ``.grad`` is the tensor the backward
    made (AccumulateGrad takes it, and copies nothing)."""
    lin = torch.nn.Linear(3, 2)
    made = {}
    for n, p in lin.named_parameters():
        p.register_hook(lambda g, n=n: made.__setitem__(n, g.data_ptr()))
    lin.register_forward_pre_hook(lambda m, _: spans.after_grads("sg_conv.backward.end", m))
    casts = {n: p.double() for n, p in lin.named_parameters()}
    runs = (lambda x: lin(x),
            lambda x: torch.func.functional_call(lin, casts, (x.double(),)))
    stamps = spans.Stamps(2, torch.zeros((), dtype=torch.int64))
    k = spans.INDEX["sg_conv.backward.end"]
    for row, run in enumerate(runs):
        stamps.row.fill_(row)
        lin.zero_grad(set_to_none=True)
        with spans.stamping(stamps):
            out = run(torch.randn(4, 3))
            assert stamps.times[row, k] == 0
            out.square().sum().backward()
            assert stamps.times[row, k] > 0
        assert not stamps._hooks
        if row == 0:
            assert {n: p.grad.data_ptr() for n, p in lin.named_parameters()} == made
    lin(torch.randn(4, 3)).sum().backward()
    assert stamps.launched == 2 and int((stamps.times != 0).sum()) == 2


def test_host_counters_count_each_epoch_once(tmp_path):
    """``Trainer.counters`` after a 5-epoch run with a checkpoint every 2
    epochs, an evaluation every 2 and new trees every 2: each epoch's new
    trees, load, launch, fetch, log and evaluation timed once (the check,
    and at its cadence the work), the first step once and the checkpoints
    where they were saved, at epochs 0, 2 and 4 (on the CPU no capture);
    a second run counts anew."""
    cfg = _cfg(checkpoint_every=2, eval_every=2, resample_trees_every=2)
    tr = _trainer(tmp_path, cfg, eval_graphs=20)
    tr.run(5, verbose=False)
    c = tr.counters
    assert c.count == {"run.first_step": 1, "epoch.resample": 5, "epoch.load": 5,
                       "epoch.launch": 5, "epoch.fetch": 5, "epoch.log": 5,
                       "epoch.checkpoint": 3, "epoch.eval": 5}
    assert all(c.total_s[n] > 0 for n, k in c.count.items() if k) and c.capture_s is None
    assert c.as_dict()["epoch.checkpoint"] == {"count": 3, "total_s": c.total_s["epoch.checkpoint"]}
    tr.run(7, verbose=False)                      # resumes at epoch 5
    assert tr.counters.count["epoch.load"] == 2 and tr.counters.count["run.first_step"] == 1


def test_graph_epochs_count_and_stamp_on_the_cpu(tmp_path):
    """``StepGraph`` with stamps runs its body eagerly on the CPU: the same
    aux values and state as without, each step's stamps in its row, fetched
    into ``Trainer.last_stamps``, and per epoch one load, one launch and per
    chunk one fetch (no capture, so no first step)."""
    cfg = _cfg()
    got, want = (_trainer(tmp_path / n, cfg) for n in ("stamped", "unstamped"))
    graphs = [ttrain.StepGraph(got, 4), ttrain.StepGraph(want, 4)]
    graphs[0].stamps = spans.Stamps(4, graphs[0].row)
    storers = [tr.graph_epochs(g, range(0, 2)) for tr, g in zip((got, want), graphs)]
    assert storers[0] == storers[1]
    for a, b in zip(_state(got)[0], _state(want)[0]):
        assert torch.equal(a, b)
    assert got.last_stamps.shape == (4, len(spans.STAMPS)) and want.last_stamps is None
    assert (np.diff(got.last_stamps, axis=1) > 0).all()
    assert (got.last_stamps[1:, 0] > got.last_stamps[:-1, -1]).all()
    assert got.counters.count["epoch.load"] == got.counters.count["epoch.launch"] == 2
    assert got.counters.count["epoch.fetch"] == 1 and got.counters.count["run.first_step"] == 0


@pytest.mark.parametrize("epochs", [3, 1])
def test_launches_json_keeps_its_keys_and_gains_spans(tmp_path, epochs):
    """``trace_rank0.launches.json`` of a profiled run: its old keys as
    ``_profiled_epoch`` counts them, and ``spans`` (the kernel's name, the
    stamps' order, each traced step's stamps and each span's median ms),
    ``counters`` (the run's host spans and ``capture_s``) and
    ``stamps_per_replay`` (0: the CPU replays nothing)."""
    tr = _trainer(tmp_path, _cfg(checkpoint_every=2))
    profile_dir = tmp_path / "profile"
    tr.run(epochs, verbose=False, profile_dir=str(profile_dir))
    written = _launches(profile_dir)
    assert list(written) == [*OLD_KEYS, "spans", "counters", "stamps_per_replay"]
    assert all(written[k] == 0 for k in OLD_KEYS) and written["stamps_per_replay"] == 0
    s = written["spans"]
    assert s["kernel"] == spans.STAMP_KERNEL and s["order"] == list(spans.STAMPS)
    assert len(s["steps_ns"]) == 2 and set(s["ms"]) == set(spans.SPANS)
    ms = s["ms"]
    assert all(v > 0 for v in ms.values())
    assert ms["forward"] + ms["backward"] + ms["optimizer"] <= ms["step"]
    assert ms["sg_conv.forward"] < ms["forward"] and ms["adj_head.backward"] < ms["backward"]
    assert written["counters"] == tr.counters.as_dict()
    assert written["counters"]["capture_s"] is None
    assert written["counters"]["epoch.load"]["count"] == epochs
    assert written["counters"]["epoch.checkpoint"]["count"] == (epochs + 1) // 2


def test_fetch_copies_values_and_stamps_bit_for_bit():
    """``spans.fetch`` returns the float64 values bit for bit (NaN, -0.0 and
    a subnormal included) and the stamps as they were, from one copy; no
    stamps, only the values."""
    values = torch.tensor([[1.5, float("nan"), -0.0], [5e-324, -2.25, 1e300]],
                          dtype=torch.float64)
    stamps = torch.arange(2 * len(spans.STAMPS), dtype=torch.int64).view(2, -1) * 10 ** 9
    got, got_stamps = spans.fetch(values, stamps)
    assert got.dtype == np.float64 and got_stamps.dtype == np.int64
    assert got.tobytes() == values.numpy().tobytes()
    assert np.array_equal(got_stamps, stamps.numpy())
    alone, none = spans.fetch(values, None)
    assert alone.tobytes() == values.numpy().tobytes() and none is None


def test_span_ms_and_export_of_hand_made_stamps():
    """``span_ms``: each span's median over the steps that took both its
    stamps, None where none did; ``export`` leaves out unstamped rows and
    writes a missing stamp as -1."""
    n = len(spans.STAMPS)
    times = np.zeros((4, n), dtype=np.int64)
    times[0] = 1_000_000_000 + 1_000_000 * np.arange(n)       # 1 ms between stamps
    times[1] = 2_000_000_000 + 3_000_000 * np.arange(n)       # 3 ms
    times[2] = 3_000_000_000 + 2_000_000 * np.arange(n)       # 2 ms
    times[2, spans.INDEX["sg_conv.forward.start"]] = 0
    ms = spans.span_ms(times)
    gap = lambda name: spans.INDEX[spans.SPANS[name][1]] - spans.INDEX[spans.SPANS[name][0]]
    assert ms["step"] == 2.0 * (n - 1)
    assert ms["forward"] == 2.0 * gap("forward")
    assert ms["sg_conv.forward"] == 2.0 * gap("sg_conv.forward")      # of rows 0 and 1
    assert spans.span_ms(times[3:]) == dict.fromkeys(spans.SPANS)
    out = spans.export(times)
    assert out["kernel"] == spans.STAMP_KERNEL and len(out["steps_ns"]) == 3
    assert out["steps_ns"][0] == (1_000_000 * np.arange(n)).tolist()
    assert out["steps_ns"][2][spans.INDEX["sg_conv.forward.start"]] == -1
    assert out["ms"] == ms


@pytest.mark.parametrize("model_type", ["disentangled", "base"])
def test_model_ranges_under_a_profiler_and_none_without(monkeypatch, model_type):
    """``serve.reconstruct`` and ``serve.sample`` under ``torch.profiler``
    carry ``model.encode`` (the conv stack's ``model.encode.sg_conv.<i>``
    inside) and ``model.decode`` (``model.decode.adj_head`` inside), names
    that start with neither ``sg_conv.`` nor ``adj_head``; with no profiler
    recording, no span opens a ``record_function`` at all, and none stamps
    outside ``stamping``."""
    cfg = _cfg(model_type=model_type)
    model = build_model(cfg, "cpu").eval()
    batch = load_dataset(cfg, "test", num_graphs=4, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve.reconstruct(model, batch)
        serve.sample(model, 2, torch.Generator().manual_seed(0))
    names = [e.name for e in prof.events()]
    want = {"model.encode": 1, "model.encode.sg_conv.0": 1, "model.encode.sg_conv.1": 1,
            "model.decode": 2, "model.decode.adj_head": 2}
    assert {n: names.count(n) for n in want} == want
    assert not any(n.startswith(("sg_conv.", "adj_head")) for n in names)
    opened = []
    monkeypatch.setattr(spans, "record_function", lambda name: opened.append(name))
    serve.reconstruct(model, batch)
    serve.sample(model, 2, torch.Generator().manual_seed(0))
    host = spans.HostSpans()
    with host.span("epoch.log"):
        pass
    spans.stamp("step.start")
    assert opened == [] and host.count["epoch.log"] == 1
