"""Serving through captured graphs (``serve.ServeGraphs``) on the CPU, at small
widths, torch on one thread.  The CPU has no graphs, so the holder runs its
body eagerly through the same static buffers a replay reads and writes:
these tests hold that body to the eager ``model(batch, deterministic_z=True)``
bit for bit in both families (and the fourth-order conv), and check what
the card's replays rely on: outputs that are copies, one capture per batch
signature within a fixed count, a new capture when a parameter is replaced
(not when it is updated in place), and the eager path where no graph
applies.  The card's replays against the eager forward are
``tests/test_torch_cuda.py``'s."""

import gc
import weakref
from dataclasses import fields

import pytest
import torch
from torch.nn.utils import parametrize
from torch_parity import configs
from torch_parity import one_thread  # noqa: F401  (fixture)

from snd_vae_tpu_torch import serve
from snd_vae_tpu_torch.data.loaders import load_dataset
from snd_vae_tpu_torch.models import build_model
from snd_vae_tpu_torch.parallel.hints import use_mesh

pytestmark = pytest.mark.usefixtures("one_thread")

CASES = {"disentangled": ("synthetic2", {}),
         "base": ("synthetic2", {}),
         "protein": ("protein", dict(num_nodes=6,
                                     encoder=dict(sg_conv_hidden=((3, 3, 3, 3), (3, 3, 3, 3)))))}


def _model(case, graphs=6):
    dataset, over = CASES[case]
    _, tc = configs("small", dataset=dataset, encoder=over.get("encoder"),
                    **{k: v for k, v in over.items() if k != "encoder"})
    if case == "base":
        tc = tc.with_(model_type="base")
    model = build_model(tc, device="cpu")
    return model, load_dataset(tc, "test", num_graphs=graphs, device="cpu")


def _eager(model, batch):
    with torch.inference_mode():
        return model(batch, deterministic_z=True)


def _tensors(out):
    """Every tensor of a ModelOutput, by name (None fields left out)."""
    got = {}
    for part in ("stats", "latents", "decoded"):
        value = getattr(out, part)
        got |= {f"{part}.{f.name}": getattr(value, f.name) for f in fields(value)
                if getattr(value, f.name) is not None}
    return got


def _assert_equal(got, want):
    g, w = _tensors(got), _tensors(want)
    assert g.keys() == w.keys()
    for k in g:
        assert torch.equal(g[k], w[k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_holder_body_equals_eager_bit_for_bit(case):
    model, data = _model(case)
    holder = serve.ServeGraphs(model)
    for lo in (0, 2, 0):
        batch = data.slice_batch(lo, 2)
        _assert_equal(holder(batch), _eager(model, batch))
    assert (holder.captures, holder.replays) == (1, 3)
    assert holder.kernels_per_replay is None and holder.copies_per_replay is None


@pytest.mark.parametrize("case", ["disentangled", "base"])
def test_outputs_are_copies_a_later_call_leaves_alone(case):
    model, data = _model(case)
    holder = serve.ServeGraphs(model)
    a, b = data.slice_batch(0, 2), data.slice_batch(2, 2)
    first = holder(a)
    kept = {k: v.clone() for k, v in _tensors(first).items()}
    second = holder(b)
    assert all(torch.equal(v, kept[k]) for k, v in _tensors(first).items())
    _assert_equal(first, _eager(model, a))
    _assert_equal(second, _eager(model, b))
    assert not torch.equal(first.stats.mean_sg, second.stats.mean_sg)
    (entry,) = holder.entries.values()
    static = {t.data_ptr() for part in (entry.stats, entry.decoded, entry.batch)
              for t in vars(part).values() if isinstance(t, torch.Tensor)}
    assert not static & {t.data_ptr() for t in _tensors(second).values()}
    # the latents are the posterior means, as the eager forward's are
    assert second.latents.z_sg is second.stats.mean_sg


def test_a_new_signature_captures_and_the_oldest_is_freed():
    assert serve.KEEP_SIGNATURES == 4
    model, data = _model("disentangled", graphs=6)
    holder = serve.ServeGraphs(model)
    for n in [1, 2, 3, 4, 5, 2, 1]:
        batch = data.slice_batch(0, n)
        _assert_equal(holder(batch), _eager(model, batch))
        assert len(holder.entries) <= 4
    # 1-5 each new, 5 frees 1; 2 kept; 1 captured again, freeing 3
    assert (holder.captures, holder.replays) == (6, 7)
    assert [k[0][0][0] for k in holder.entries] == [4, 5, 2, 1]
    holder(data.slice_batch(0, 2).to(dtype=torch.float64))     # another dtype: another signature
    assert holder.captures == 7 and len(holder.entries) == 4


def test_a_replaced_parameter_captures_again_an_update_in_place_does_not():
    model, data = _model("disentangled")
    batch = data.slice_batch(0, 2)
    holder = serve.ServeGraphs(model)
    holder(batch)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.01)
    model.load_state_dict({k: v * 0.99 for k, v in model.state_dict().items()})
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    _assert_equal(holder(batch), _eager(model, batch))
    assert holder.captures == 1
    model.d_s_lin2.kernel = torch.nn.Parameter(model.d_s_lin2.kernel.detach() + 1.0)
    _assert_equal(holder(batch), _eager(model, batch))
    assert holder.captures == 2 and len(holder.entries) == 1


class _Twice(torch.nn.Module):
    def forward(self, x):
        return 2 * x


def test_eager_where_no_graph_applies():
    model, data = _model("disentangled")
    batch = data.slice_batch(0, 2)
    assert serve.graphable(model) == serve.tensor_addresses(model) is not None
    with use_mesh(object()):                    # any ambient mesh
        assert serve.graphable(model) is None
    # the CPU: the eager forward, and no holder made
    _assert_equal(serve.reconstruct(model, batch), _eager(model, batch))
    assert serve.graphs(model) is None
    # a parametrized module (the model axis's slices are)
    parametrize.register_parametrization(model.d_s_lin2, "kernel", _Twice())
    assert serve.graphable(model) is None and serve.tensor_addresses(model) is None


def test_the_holder_keeps_no_model_alive():
    model, data = _model("base")
    holder = serve.ServeGraphs(model)
    holder(data.slice_batch(0, 2))
    alive = weakref.ref(model)
    serve._HOLDERS[model] = holder
    del model
    gc.collect()
    assert alive() is None and len(serve._HOLDERS) == 0
