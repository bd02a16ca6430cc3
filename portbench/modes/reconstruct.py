"""Reconstruction: a closed loop of one client.  Each request is one
``serve.reconstruct`` of ``graphs_per_request`` graphs of the split, cycled,
timed from the call until its outputs are synchronized.  The answers of one
request in ``check_one_in``, drawn from the seed, and the window's last are
copied to the host after it, and compared with the reference's once the
window has closed.  With ``--trace 1`` the window's first
``traced_requests`` requests run under ``torch.profiler``, each motif conv
and the adjacency head inside a range of the benchmark's own
(``label_model``).

Parameters (``traffic/<name>.json``): ``split``, ``graphs_per_request``,
``warmup_requests``, ``traced_requests``, ``check_one_in``.
"""

from __future__ import annotations

import gc
import os
import tempfile
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from portbench import check, inputs
from portbench.drive import (TRACE_MARGIN_S, Outcome, Run, graphbatch, load_weights, peak_bytes,
                             port_config, reset_peak, sync)
from portbench.reference import model as ref
from portbench.traces import Trace


def label_model(model) -> Callable[[], None]:
    """A profiler range ``sg_conv.<i>`` around each motif conv's forward and
    ``adj_head`` around the adjacency head, from outside the program (module
    hooks; the head's method wrapped on the instance).  Returns the undo."""
    from torch.profiler import record_function

    handles, open_ranges = [], {}
    for i, conv in enumerate(model.sg_convs):
        def enter(_m, _args, i=i):
            open_ranges[i] = record_function(f"sg_conv.{i}")
            open_ranges[i].__enter__()

        def leave(_m, _args, _out, i=i):
            open_ranges.pop(i).__exit__(None, None, None)

        handles += [conv.register_forward_pre_hook(enter), conv.register_forward_hook(leave)]
    head = model._adj_head

    def labelled(*args, **kw):
        with record_function("adj_head"):
            return head(*args, **kw)

    model._adj_head = labelled

    def undo():
        for h in handles:
            h.remove()
        del model._adj_head
    return undo


def answer(out) -> Dict[str, torch.Tensor]:
    """What a request returned that the check compares, on the host."""
    return {"adj_prob": out.decoded.adj_prob.cpu(), "mean_sg": out.stats.mean_sg.cpu(),
            "mean_s": out.stats.mean_s.cpu(), "mean_g": out.stats.mean_g.cpu()}


def _batch_dict(gb) -> Dict[str, torch.Tensor]:
    return {k: getattr(gb, k) for k in ("adj", "features", "coords", "rel", "adj_samples")}


@torch.no_grad()
def reference_answers(cfg: dict, P0, distinct, requests: List[int]) -> List[Dict]:
    """The reference's posterior-mean reconstruction of each request's
    batch."""
    answers = {}
    for i, b in enumerate(distinct):
        if any(r % len(distinct) == i for r in requests):
            st, out = ref.forward(P0, cfg, _batch_dict(b))
            answers[i] = {**out, **st}
    return [answers[r % len(distinct)] for r in requests]


def drive(ctx) -> Outcome:
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    from snd_vae_tpu_torch import serve
    from snd_vae_tpu_torch.models import build_model

    cfg, tr, dev, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    G = tr["graphs_per_request"]
    P0 = inputs.make_weights(ref.param_spec(cfg), seed, dev)
    model = build_model(port_config(cfg, seed), dev)
    load_weights(model, P0)
    model.eval()
    ctx.patch_program(model)
    keep_every = tr["check_one_in"]
    keep_at = seed % keep_every
    data = inputs.make_split(cfg, cfg["splits"][tr["split"]], seed, tr["split"])
    whole = graphbatch(data, dev)
    distinct = [whole.slice_batch(i * G, G) for i in range(whole.batch_size // G)]
    call = lambda r: serve.reconstruct(model, distinct[r % len(distinct)])
    for r in range(tr["warmup_requests"]):
        call(r)
    sync(dev)
    peak_setup = peak_bytes(dev)
    reset_peak(dev)
    kept: Dict[int, Dict[str, torch.Tensor]] = {}
    last: list = []
    times: List[tuple] = []
    traced = tr["traced_requests"] if ctx.trace else 0
    run = Run(ctx.name, "reconstruct", cfg, tr, graphs_per_unit=G) if ctx.trace else None
    prof = None

    def request(r: int) -> None:
        tc = time.perf_counter()
        out = call(r)
        te = time.perf_counter()
        sync(dev)
        times.append((tc, te, time.perf_counter()))
        # the sampled answers leave the card, as a scoring job's results do:
        # answers kept there grew the allocator's pool through the window,
        # and its new segments stalled requests by up to 0.9 s (PERF.md, §6)
        if r % keep_every == keep_at:
            kept[r] = answer(out)
        last[:] = [r, out]

    sync(dev)
    t0 = time.perf_counter()
    ctx.setup_s = t0 - ctx.t_start
    deadline = t0 + ctx.seconds
    r = 0
    if traced:
        undo = label_model(model)
        with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                                          if dev.type == "cuda" else []),
                     acc_events=True, schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            call(0)
            sync(dev)
            prof.step()
            time.sleep(TRACE_MARGIN_S)
            with record_function("serve_window"):
                for r in range(traced):
                    request(r)
            time.sleep(TRACE_MARGIN_S)
        undo()
        r = traced
    while time.perf_counter() < deadline or r == traced:
        request(r)
        r += 1
    kept.setdefault(last[0], answer(last[1]))  # the window's last answer too
    wall = times[-1][2] - t0
    peak_window = peak_bytes(dev)
    lat_ms = [(c - a) * 1e3 for a, _, c in times]
    if run is not None:
        path = os.path.join(tempfile.gettempdir(), f"portbench-trace-{os.getpid()}.json")
        try:
            prof.export_chrome_trace(path)
            run.trace = Trace.load(path)
        finally:
            if os.path.exists(path):
                os.remove(path)
        run.window = run.trace.range_window("serve_window")
        run.units = traced
        run.trees = [data["adj_samples"][(i % len(distinct)) * G:(i % len(distinct) + 1) * G]
                     for i in range(traced)]
        run.enqueue_ms = [(b - a) * 1e3 for a, b, _ in times[traced:]]
        run.peak_bytes_window = peak_window
    failed = sum(not all(bool(torch.isfinite(t).all()) for t in f.values())
                 for f in kept.values())
    del model, prof, last
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref.set_precision(False)
    order = sorted(kept)
    pairs = list(zip((kept[r] for r in order), reference_answers(cfg, P0, distinct, order)))
    e2e = {"served_graphs_per_s": len(times) * G / wall,
           "serve_ms_p95": float(np.percentile(lat_ms, 95)), "setup_s": ctx.setup_s}
    return Outcome(e2e, len(times), failed, check.serve_numbers(pairs),
                   max(peak_setup, peak_window), run)
