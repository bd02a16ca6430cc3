"""Spans measured inside the program: device stamps in the train step, host
spans of the epoch loop, and profiler ranges of the model.

Device stamps (``Stamps``).  A stamp writes the time into
``Stamps.times[row, k]``, k its place in ``STAMPS`` and ``row`` a device
int64 (``train.StepGraph``'s row counter, or the step's index per step).  On
a CUDA device it is the one-thread kernel ``span_stamp_kernel``
(``nn/kernels/csrc/span_stamp.cu``), which reads the card's ``%globaltimer``
in ns and the row on the device, launched on the stream the step runs on:
a captured step replays its stamps into each replay's row.  On the CPU it
writes ``time.perf_counter_ns()``.  Inside ``stamping(stamps)``:

  * ``stamp(name)`` stamps now, in stream order;
  * ``marked(fwd, bwd, x)`` returns ``x`` through an identity autograd
    Function that stamps ``fwd`` in its forward and ``bwd`` in its backward,
    once the whole of its gradient is there, and hands that back untouched;
  * ``after_grads(name, module)`` stamps once the backward has computed the
    gradient of every parameter ``module`` holds (the start of a stack whose
    input has no gradient).

Outside ``stamping`` each does nothing and returns its input, so a step
without stamps launches and records exactly what it did before.  Under
``cfg.remat`` a recomputed region runs its forward again inside the
backward; no forward stamp is taken there, so a span keeps the first
forward's pair of stamps.  ``SPANS`` names the intervals between stamps and
``span_ms`` gives each one's median ms a step; ``%globaltimer`` may tick
only every microsecond, and each of these spans is tens of microseconds or
longer.

Host spans (``HostSpans``): the count and total seconds of each of
``HOST_SPANS``, timed by ``time.perf_counter``, always on.

Ranges (``labelled``, ``ranged``): a ``record_function`` range while a
profiler records, and otherwise nothing but the one check
(``torch.autograd.profiler._is_profiler_enabled``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import time
from contextvars import ContextVar
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch.profiler import record_function

# the train step's stamps, in the order a step takes them
STAMPS = (
    "step.start", "train_step.forward",
    "sg_conv.forward.start", "sg_conv.forward.end",
    "adj_head.forward.start", "adj_head.forward.end",
    "train_step.backward",
    "adj_head.backward.start", "adj_head.backward.end",
    "sg_conv.backward.start", "sg_conv.backward.end",
    "train_step.optimizer", "train_step.end", "step.end",
)
INDEX = {name: k for k, name in enumerate(STAMPS)}
# span -> (the stamp that opens it, the stamp that closes it)
SPANS = {
    "step": ("step.start", "step.end"),
    "forward": ("train_step.forward", "train_step.backward"),
    "backward": ("train_step.backward", "train_step.optimizer"),
    "optimizer": ("train_step.optimizer", "train_step.end"),
    "sg_conv.forward": ("sg_conv.forward.start", "sg_conv.forward.end"),
    "sg_conv.backward": ("sg_conv.backward.start", "sg_conv.backward.end"),
    "adj_head.forward": ("adj_head.forward.start", "adj_head.forward.end"),
    "adj_head.backward": ("adj_head.backward.start", "adj_head.backward.end"),
}
STAMP_KERNEL = "span_stamp_kernel"
# the epoch loop's host spans (``train.Trainer.run``)
HOST_SPANS = ("run.first_step", "epoch.resample", "epoch.load", "epoch.launch",
              "epoch.fetch", "epoch.log", "epoch.checkpoint", "epoch.eval")

_ACTIVE: ContextVar[Optional["Stamps"]] = ContextVar("stamps", default=None)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from .nn.kernels import build

    p, i = ctypes.c_void_p, ctypes.c_int
    return build.load("span_stamp", {"span_stamp_launch": [p, p, i, i, i, p]})


class Stamps:
    """The stamps of up to ``rows`` steps, [rows, len(STAMPS)] int64 on the
    device of ``row`` (zero where a step took no such stamp).  On a CUDA
    device the kernel is built, or loaded, here.  ``launched`` counts the
    stamps taken (a capture's are its replays')."""

    def __init__(self, rows: int, row: torch.Tensor):
        self.row = row
        self.times = torch.zeros((rows, len(STAMPS)), dtype=torch.int64, device=row.device)
        self.launched = 0
        self._stream: Optional[int] = None
        self._hooks: list = []
        if row.device.type == "cuda":
            _library()

    def stamp(self, name: str) -> None:
        k = INDEX[name]
        if self.times.device.type == "cuda":
            code = _library().span_stamp_launch(self.times.data_ptr(), self.row.data_ptr(),
                                                self.times.shape[0], self.times.shape[1], k,
                                                self._stream)
            if code != 0:
                raise RuntimeError(f"{STAMP_KERNEL}: CUDA launch failed with cudaError {code}")
        else:
            self.times[int(self.row), k] = time.perf_counter_ns()
        self.launched += 1


@contextlib.contextmanager
def stamping(stamps: Optional[Stamps]) -> Iterator[None]:
    """``stamps`` take the stamps inside the block (None: no stamps), on the
    stream current at its start; its ``after_grads`` hooks are removed at
    its end."""
    if stamps is None:
        yield
        return
    if stamps.times.device.type == "cuda":
        stamps._stream = torch.cuda.current_stream(stamps.times.device).cuda_stream
    token = _ACTIVE.set(stamps)
    try:
        yield
    finally:
        _ACTIVE.reset(token)
        for h in stamps._hooks:
            h.remove()
        stamps._hooks.clear()


def _active() -> Optional[Stamps]:
    """The stamps of the block, outside a backward (where a recomputed
    region runs its forward again)."""
    stamps = _ACTIVE.get()
    if stamps is None or torch._C._current_graph_task_id() != -1:
        return None
    return stamps


def stamp(name: str) -> None:
    stamps = _active()
    if stamps is not None:
        stamps.stamp(name)


class _Mark(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stamps: Stamps, fwd: str, bwd: str, x: torch.Tensor):
        ctx.stamps, ctx.bwd = stamps, bwd
        stamps.stamp(fwd)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.stamps.stamp(ctx.bwd)
        return None, None, None, grad


def marked(fwd: str, bwd: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` itself; inside ``stamping``, a view of it through ``_Mark``."""
    stamps = _active()
    return x if stamps is None else _Mark.apply(stamps, fwd, bwd, x)


def after_grads(name: str, module: torch.nn.Module) -> None:
    """Called in a forward: the parameters ``module`` holds now (the casts
    under ``torch.func.functional_call``) each get a hook, the last of
    which stamps ``name``."""
    stamps = _active()
    if stamps is None or not torch.is_grad_enabled():
        return
    tensors = [t for t in module.parameters() if t.requires_grad]
    # one plain hook a tensor, which keeps no gradient: a multi-grad hook
    # holds each until the last arrives, and a leaf's AccumulateGrad then
    # copies the gradient it would have taken (a copy node more a tensor)
    left = [len(tensors)]

    def arrived(_grad):
        left[0] -= 1
        if left[0] == 0:
            stamps.stamp(name)

    stamps._hooks += [t.register_hook(arrived) for t in tensors]


def span_ms(times: np.ndarray) -> Dict[str, Optional[float]]:
    """Each of ``SPANS``' median ms a step over the rows of ``times``
    ([steps, len(STAMPS)] ns) that hold both its stamps; None where none
    does."""
    out: Dict[str, Optional[float]] = {}
    for name, (a, b) in SPANS.items():
        ta, tb = times[:, INDEX[a]], times[:, INDEX[b]]
        took = (ta != 0) & (tb != 0)
        out[name] = float(np.median(tb[took] - ta[took]) / 1e6) if took.any() else None
    return out


def export(times: np.ndarray) -> dict:
    """What ``trace_rank<r>.launches.json`` holds of a traced epoch's
    stamps: the kernel's name, the stamps' order, each stamped step's stamps
    in ns from its first, and each span's median ms a step."""
    rows = times[(times != 0).any(axis=1)]
    first = np.where(rows != 0, rows, np.iinfo(np.int64).max).min(axis=1, keepdims=True)
    return {"kernel": STAMP_KERNEL, "order": list(STAMPS),
            "steps_ns": np.where(rows != 0, rows - first, -1).tolist(), "ms": span_ms(rows)}


def fetch(values: torch.Tensor, stamps: Optional[torch.Tensor]) -> tuple:
    """``values`` [rows, k] float64 and ``stamps`` [rows, len(STAMPS)] int64
    (or None) on the host, in one copy: a second copy after the first one's
    sync would hold a traced window open for the host's time between the
    two (3.4-4.1 ms an epoch of synthetic2 on an H100)."""
    if stamps is None:
        return values.cpu().numpy(), None
    k = values.shape[1]
    both = torch.cat([values.view(torch.int64), stamps], 1).cpu().numpy()
    return both[:, :k].view(np.float64), both[:, k:]


def labelled(name: str):
    """A ``record_function`` range ``name`` while a profiler records, else
    nothing."""
    if torch.autograd.profiler._is_profiler_enabled:
        return record_function(name)
    return contextlib.nullcontext()


def ranged(name: str):
    """A method run inside ``labelled(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with labelled(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


class HostSpans:
    """The count and total seconds of each of ``HOST_SPANS`` (a run's,
    ``train.Trainer.counters``) and the capture's seconds; each span is also
    a ``labelled`` range."""

    def __init__(self):
        self.count = dict.fromkeys(HOST_SPANS, 0)
        self.total_s = dict.fromkeys(HOST_SPANS, 0.0)
        self.capture_s: Optional[float] = None

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        with labelled(name):
            yield
        self.total_s[name] += time.perf_counter() - t0
        self.count[name] += 1

    def as_dict(self) -> dict:
        return {**{n: {"count": self.count[n], "total_s": self.total_s[n]} for n in HOST_SPANS},
                "capture_s": self.capture_s}
