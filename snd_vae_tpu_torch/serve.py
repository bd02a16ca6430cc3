"""Serving: posterior-mean reconstruction and decoding from the prior.

  * ``reconstruct(model, batch)`` — the counterpart of the JAX
    ``make_eval_step`` (``snd_vae_tpu/train.py:292-300``): encode, take the
    posterior means, decode.  On a CUDA card it is a replay of the encode
    and the decode captured as CUDA graphs once per batch signature
    (``ServeGraphs``), so the host launches two graphs and a few copies a
    call in place of every kernel of the forward.  The eager forward stays
    where no graph applies: on the CPU, for a model with parametrizations
    (the mesh's model axis, ``parallel/tensor_parallel.py``) and under an
    ambient mesh (``parallel.hints.use_mesh``; ``Trainer.evaluate_heldout``
    under the model axis).
  * ``sample(model, num, generator)`` — the counterpart of the models'
    ``generate`` (``models/disentangled.py:367-372``, ``models/joint.py:
    253-255``); ``num_samples`` (prior draws of z_sg averaged per graph)
    applies to the disentangled family only.  Always eager: its draws
    would need the generator registered with a graph.

Both take either model family and run without autograd, on the model's
device and in its dtype; the batch is moved and cast to match.  Both are
entry points, so both turn TF32 off first (``device.full_f32``): an f32
model computes in full f32 on the card, as on the CPU.
"""

from __future__ import annotations

import gc
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass, fields, replace
from typing import Optional

import torch
from torch.profiler import record_function

from . import spans
from .data.graphbatch import GraphBatch
from .device import full_f32
from .models import DecodedGraph, JointSNDVAE, Latents, LatentStats, Model, ModelOutput
from .parallel.hints import ambient_mesh

# the batch signatures a model's ServeGraphs keeps captured
KEEP_SIGNATURES = 4
CAPTURE_RANGE = "ServeGraphs.capture"

_HOLDERS: "weakref.WeakKeyDictionary[Model, ServeGraphs]" = weakref.WeakKeyDictionary()


def reconstruct(model: Model, batch: GraphBatch) -> ModelOutput:
    full_f32()
    with torch.inference_mode():
        addresses = graphable(model) if model.device.type == "cuda" else None
        if addresses is None:
            return model(batch.to(model.device, model.dtype), deterministic_z=True)
        holder = _HOLDERS.get(model)
        if holder is None:
            holder = _HOLDERS[model] = ServeGraphs(model)
        return holder(batch, addresses)


def graphs(model: Model) -> Optional["ServeGraphs"]:
    """The ``ServeGraphs`` that ``reconstruct`` made for ``model``, or None."""
    return _HOLDERS.get(model)


def sample(model: Model, num: int, generator: torch.Generator,
           num_samples: Optional[int] = None) -> DecodedGraph:
    full_f32()
    with torch.inference_mode():
        if isinstance(model, JointSNDVAE):
            if num_samples not in (None, 1):
                raise ValueError("the joint model draws one z_sg per graph")
            return model.generate(generator, num)
        return model.generate(generator, num, num_samples)


def graphable(model: Model) -> Optional[tuple]:
    """``tensor_addresses(model)`` where captured graphs may serve it; None
    under an ambient mesh (its collectives and node rows are decided per
    call) and for a model with parametrizations."""
    return None if ambient_mesh() is not None else tensor_addresses(model)


def tensor_addresses(model: Model) -> Optional[tuple]:
    """The address of every parameter and buffer of ``model``, which a
    captured graph reads; None where a module is parametrized (its
    parameter is computed in the forward: a model rank's gather)."""
    # a walk of the modules' own dicts: every call reads them, and
    # ``modules()`` with ``parametrize.is_parametrized`` took six times as long
    out, stack = [], [model]
    while stack:
        m = stack.pop()
        if "parametrizations" in m._modules:
            return None
        out += [t.data_ptr() for t in m._parameters.values() if t is not None]
        out += [t.data_ptr() for t in m._buffers.values() if t is not None]
        stack += [c for c in m._modules.values() if c is not None]
    return tuple(out)


def signature(batch: GraphBatch) -> tuple:
    """Each field's shape, dtype and device, None where it is None."""
    return tuple(None if t is None else (tuple(t.shape), t.dtype, t.device)
                 for t in (getattr(batch, f.name) for f in fields(batch)))


def _means(stats: LatentStats) -> Latents:
    """The posterior means as latents (``deterministic_z``); the joint
    model's stats hold z_sg's alone."""
    return Latents(z_sg=stats.mean_sg, z_s=stats.mean_s, z_g=stats.mean_g)


def _copied(*values) -> list:
    """Dataclasses of tensors with every tensor copied, by one
    ``_foreach_copy_`` for each device and dtype (a fused launch each)."""
    names = [[f.name for f in fields(v) if getattr(v, f.name) is not None] for v in values]
    src = [getattr(v, n) for v, ns in zip(values, names) for n in ns]
    dst = [torch.empty_like(t) for t in src]
    groups: dict = {}
    for i, t in enumerate(src):
        groups.setdefault((t.device, t.dtype), []).append(i)
    for group in groups.values():
        torch._foreach_copy_([dst[i] for i in group], [src[i] for i in group])
    copies = iter(dst)
    return [replace(v, **{n: next(copies) for n in ns}) for v, ns in zip(values, names)]


@dataclass
class _Entry:
    """One batch signature: the static inputs, what the encode and the
    decode leave in their graphs' memory, and the two graphs (none on the
    CPU)."""
    batch: GraphBatch
    stats: Optional[LatentStats] = None
    decoded: Optional[DecodedGraph] = None
    graphs: tuple = ()
    kernels: Optional[int] = None
    copies: Optional[int] = None

    def release(self) -> None:
        for g in self.graphs:
            g.reset()
        self.graphs = ()


class ServeGraphs:
    """``reconstruct`` of one model as replays: per batch signature
    (``signature``), static input buffers, into which each call copies its
    batch (``copy_``: moved and cast as ``GraphBatch.to`` does), and two
    CUDA graphs, the encode and the decode, captured as ``train.StepGraph``
    captures the train step: an eager pass on a side stream (cuBLAS's
    workspace for that stream, cuDNN's plans, the kernels' libraries), then
    one capture of each, the decode into the encode's memory pool, reading
    the encode's posterior means where the capture left them.  Each call
    replays both on the caller's stream, the encode inside the profiler
    range ``model.encode`` and the decode inside ``model.decode`` (so a
    trace attributes each replay's records to the model's ranges, as it
    does an eager call's), and returns copies of the outputs: answers that
    a later call's replay would overwrite are never handed out.  The
    outputs are those of the eager ``model(batch, deterministic_z=True)``.

    The ``KEEP_SIGNATURES`` signatures used last stay captured; the one
    used longest ago is freed when another comes.  Every graph is dropped
    and captured again once a parameter or buffer lives at another address
    (``tensor_addresses``: a tensor replaced, the model moved or cast);
    updates in place (``load_state_dict``, an optimizer's step) keep them.
    The holder keeps a weak reference to the model and is freed with it.
    One caller at a time: a call writes the static buffers.

    On the CPU, which has no graphs, each call runs the same body eagerly
    through the same static buffers (the tests hold it there).  Counters:
    ``captures`` (signatures captured, or on the CPU made), ``replays``
    (calls), ``capture_s`` (the captures' seconds, from the eager pass's
    end), and the last call's signature's ``kernels_per_replay`` and
    ``copies_per_replay``: the two graphs' kernel nodes and their memcpy
    and memset nodes (``train.graph_device_nodes``; None on the CPU)."""

    def __init__(self, model: Model):
        self._model = weakref.ref(model)
        self.capture = model.device.type == "cuda"
        self.entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self.addresses: Optional[tuple] = None
        self.captures = self.replays = 0
        self.capture_s = 0.0
        self._stream: Optional[torch.cuda.Stream] = None

    @property
    def kernels_per_replay(self) -> Optional[int]:
        return next(reversed(self.entries.values())).kernels if self.entries else None

    @property
    def copies_per_replay(self) -> Optional[int]:
        return next(reversed(self.entries.values())).copies if self.entries else None

    def __call__(self, batch: GraphBatch, addresses: Optional[tuple] = None) -> ModelOutput:
        model = self._model()
        with torch.inference_mode():
            addresses = tensor_addresses(model) if addresses is None else addresses
            if addresses != self.addresses:
                self.release()
                self.addresses = addresses
            key = signature(batch)
            entry = self.entries.get(key)
            if entry is None:
                entry = self._make(model, batch)
                self.entries[key] = entry
                while len(self.entries) > KEEP_SIGNATURES:
                    self.entries.popitem(last=False)[1].release()
            else:
                self.entries.move_to_end(key)
                self._load(entry, batch)
            self._run(model, entry)
            stats, decoded = _copied(entry.stats, entry.decoded)
            return ModelOutput(stats=stats, latents=_means(stats), decoded=decoded)

    def release(self) -> None:
        """Free every captured graph."""
        for entry in self.entries.values():
            entry.release()
        self.entries.clear()

    @staticmethod
    def _load(entry: _Entry, batch: GraphBatch) -> None:
        for f in fields(batch):
            t = getattr(batch, f.name)
            if t is not None:
                getattr(entry.batch, f.name).copy_(t)

    def _run(self, model: Model, entry: _Entry) -> None:
        if self.capture:
            encode, decode = entry.graphs
            with spans.labelled("model.encode"):
                encode.replay()
            with spans.labelled("model.decode"):
                decode.replay()
        else:
            self._write(entry.stats, model.encode(entry.batch))
            self._write(entry.decoded, model.decode(_means(entry.stats)))
        self.replays += 1

    @staticmethod
    def _write(static, got) -> None:
        for f in fields(static):
            if getattr(static, f.name) is not None:
                getattr(static, f.name).copy_(getattr(got, f.name))

    def _make(self, model: Model, batch: GraphBatch) -> _Entry:
        """A new signature's static inputs, loaded with ``batch``, and its
        graphs (on the CPU its outputs' static buffers)."""
        static = batch.to(model.device, model.dtype)._map(torch.empty_like)
        entry = _Entry(batch=static)
        self._load(entry, batch)
        if not self.capture:
            entry.stats = model.encode(static)
            entry.decoded = model.decode(_means(entry.stats))
            self.captures += 1
            return entry
        from .train import _failed_at, graph_device_nodes

        dev = model.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        current = torch.cuda.current_stream(dev)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            model.decode(_means(model.encode(static)))
            # as torch.cuda.graph does: the cache goes back to the card first
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            gc.collect()
            torch.cuda.empty_cache()
            # kept after the capture so that their nodes can be counted
            encode, decode = (torch.cuda.CUDAGraph(keep_graph=True) for _ in range(2))
            with record_function(CAPTURE_RANGE):
                try:
                    capturing = encode
                    encode.capture_begin()
                    entry.stats = model.encode(static)
                    encode.capture_end()
                    capturing = decode
                    decode.capture_begin(pool=encode.pool())
                    entry.decoded = model.decode(_means(entry.stats))
                    decode.capture_end()
                except BaseException as e:
                    try:
                        capturing.capture_end()
                    except RuntimeError:
                        pass
                    encode.reset()
                    decode.reset()
                    raise RuntimeError(f"capturing serve.reconstruct as CUDA graphs failed at "
                                       f"{_failed_at(e)}: {e}") from e
            nodes = [graph_device_nodes(g.raw_cuda_graph()) for g in (encode, decode)]
            entry.kernels = sum(n["kernel"] for n in nodes)
            entry.copies = sum(n["memcpy"] + n["memset"] for n in nodes)
            encode.instantiate()
            decode.instantiate()
            self.capture_s += time.perf_counter() - t0
        current.wait_stream(self._stream)
        self.captures += 1
        entry.graphs = (encode, decode)
        return entry
