"""The readers of the program's own spans (``metrics/train.*_ms``,
``train.replay_idle_pct``, ``train.epoch_host_ms``, ``train.first_step_s``,
``serve.encode_ms``, ``serve.decode_ms``) on a hand-made trace and
``launches`` dict: the numbers, and None where what they read is absent, as
in a run of a program without the spans."""

from __future__ import annotations

import pytest

from portbench.drive import Run
from portbench.run import metric_reader
from portbench.traces import Trace

TRAIN = ("train.forward_ms", "train.backward_ms", "train.optimizer_ms", "train.adj_head_ms",
         "train.sg_conv_ms", "train.replay_idle_pct", "train.epoch_host_ms",
         "train.first_step_s")
SERVE = ("serve.encode_ms", "serve.decode_ms")
KERNEL = "span_stamp_kernel"

MS = {"step": 5.0, "forward": 1.5, "backward": 2.75, "optimizer": 0.5,
      "sg_conv.forward": 0.25, "sg_conv.backward": 0.5,
      "adj_head.forward": 0.125, "adj_head.backward": 0.625}
COUNTERS = {"run.first_step": {"count": 1, "total_s": 2.5},
            "epoch.resample": {"count": 0, "total_s": 0.0},
            "epoch.load": {"count": 4, "total_s": 0.002},
            "epoch.launch": {"count": 4, "total_s": 0.4},
            "epoch.fetch": {"count": 4, "total_s": 0.3},
            "epoch.log": {"count": 4, "total_s": 0.004},
            "epoch.checkpoint": {"count": 1, "total_s": 0.01},
            "epoch.eval": {"count": 0, "total_s": 0.0},
            "capture_s": 1.25}


def train_trace() -> Trace:
    """Two replays (correlations 1 and 2) in a window of 250 µs: the first
    idle 7 µs between its first and last stamp, the second 2 µs; an eager
    kernel (correlation 3) outside both."""
    t = Trace()
    t.device = sorted([
        (100, 101, f"{KERNEL}(long*, long const*, int, int, int)", 1),
        (102, 110, "gemm", 1), (115, 120, "reduce", 1),
        (121, 122, f"{KERNEL}(long*, long const*, int, int, int)", 1),
        (200, 201, f"{KERNEL}(long*, long const*, int, int, int)", 2),
        (201, 230, "conv", 2),
        (232, 233, f"{KERNEL}(long*, long const*, int, int, int)", 2),
        (260, 280, "cat", 3)])
    return t


def train_run(launches) -> Run:
    return Run("s2_train", "train", {}, {}, trace=train_trace(), window=(50.0, 300.0),
               launches=launches, units=2)


def serve_run(ranges=True) -> Run:
    """Two requests: the encode's records 5 and 30 µs (the second inside
    ``model.encode.sg_conv.0``), the decode's 10, one outside any range, and
    the benchmark's own ``sg_conv.0`` range beside the program's."""
    t = Trace()
    names = ["model.encode", "model.encode.sg_conv.0", "model.decode"] if ranges else []
    for (a, b), name in zip(((0, 100), (10, 40), (100, 150)), names):
        t.host.append((a, b, name, 1, "user_annotation"))
    t.host.append((12, 38, "sg_conv.0", 1, "user_annotation"))
    t.launch_ts = {11: (5, 1), 12: (20, 1), 13: (120, 1), 14: (160, 1)}
    t.device = [(6, 11, "k", 11), (21, 51, "k", 12), (121, 131, "k", 13), (161, 171, "k", 14)]
    return Run("protein_recon", "reconstruct", {}, {}, trace=t, window=(0.0, 200.0), units=2)


def read(name, run):
    return metric_reader(name)(run)


def test_train_readers_on_the_programs_spans_and_counters():
    run = train_run({"spans": {"kernel": KERNEL, "order": [], "steps_ns": [], "ms": MS},
                     "counters": COUNTERS, "stamps_per_replay": 14})
    got = {name: read(name, run) for name in TRAIN}
    assert got == {"train.forward_ms": 1.5, "train.backward_ms": 2.75,
                   "train.optimizer_ms": 0.5, "train.adj_head_ms": 0.75,
                   "train.sg_conv_ms": 0.75, "train.replay_idle_pct": pytest.approx(3.6),
                   "train.epoch_host_ms": pytest.approx(4.0), "train.first_step_s": 2.5}


@pytest.mark.parametrize("launches", [
    None,
    {"host_launches": 10, "graph_replays": 20, "kernels_per_replay": 900,
     "copies_per_replay": 39, "launches_without_device_record": 0},
    {"spans": None, "counters": {}},
])
def test_train_readers_find_nothing_without_the_programs_spans(launches):
    """A program without spans (the keys absent, or empty) reads None in
    every one of them, and so does a serving run."""
    run = train_run(launches)
    assert {name: read(name, run) for name in TRAIN} == dict.fromkeys(TRAIN)
    assert {name: read(name, serve_run()) for name in TRAIN} == dict.fromkeys(TRAIN)


def test_train_readers_of_a_span_left_out():
    """A span the configuration has none of (a model without motif convs)
    reads None; no stamp record in the trace leaves the idle share None; no
    epoch or no first step leaves the counters' readers None."""
    ms = {**MS, "sg_conv.forward": None, "sg_conv.backward": None}
    run = train_run({"spans": {"kernel": KERNEL, "ms": ms},
                     "counters": {**COUNTERS, "epoch.load": {"count": 0, "total_s": 0.0},
                                  "run.first_step": {"count": 0, "total_s": 0.0}}})
    assert read("train.sg_conv_ms", run) is None and read("train.adj_head_ms", run) == 0.75
    assert read("train.epoch_host_ms", run) is None and read("train.first_step_s", run) is None
    run.trace.device = [d for d in run.trace.device if KERNEL not in d[2]]
    assert read("train.replay_idle_pct", run) is None


def test_serve_readers_on_the_programs_ranges():
    run = serve_run()
    assert read("serve.encode_ms", run) == pytest.approx((5 + 30) / 1e3 / 2)
    assert read("serve.decode_ms", run) == pytest.approx(10 / 1e3 / 2)
    # the benchmark's own range reads what the program's conv range does
    assert run.trace.range_device_us(run.window, "sg_conv.") == {"sg_conv.0": 30.0}
    assert run.trace.range_device_us(run.window, "model.encode.sg_conv.") == {
        "model.encode.sg_conv.0": 30.0}


def test_serve_readers_find_nothing_without_the_programs_ranges():
    no_trace = serve_run()
    no_trace.trace = None
    for run in (serve_run(ranges=False), train_run(None), no_trace):
        assert {name: read(name, run) for name in SERVE} == dict.fromkeys(SERVE)
