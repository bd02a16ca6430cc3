"""Rematerialization (``cfg.remat``, ``cfg.remat_policy``; ``nn/ckpt.py``) in
both model families, third and fourth order, with and without
``motif_block_rows``:

  * one float64 step's loss and every gradient equal to the step without
    remat (1e-12), the level-3 kernel's wrapper called once more per motif
    conv in the backward's recompute, dropout's masks the same;
  * against ``jax.value_and_grad`` of the JAX model built with
    ``remat=True`` and the same policy (1e-8; compiled without XLA's
    ``algsimp``, as ``tests/test_torch_protein_train.py`` explains);
  * under ``recompute-big`` no tensor produced in a ``big(...)`` region is
    kept for the backward (``saved_tensors_hooks`` and the policy's cache);
  * every preset runs a remat step; bf16 steps equal;
  * ``BIG_NAMES`` covers the ``big(...)`` sites (a source scan) and
    ``policy_from_config`` resolves as JAX's."""

import dataclasses
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from test_torch_protein_train import _eps, _jax_loss_and_grads, _port_step
from torch_parity import exact_f64, one_thread  # noqa: F401  (fixtures)
from torch_parity import configs, random_params, setup_models

from snd_vae_tpu.data.graphbatch import from_numpy as jax_batch
from snd_vae_tpu_torch import train as ttrain
from snd_vae_tpu_torch.data.loaders import load_dataset
from snd_vae_tpu_torch.models import Latents, build_model
from snd_vae_tpu_torch.nn import ckpt
from snd_vae_tpu_torch.nn.kernels import motif_level3 as ml
from snd_vae_tpu_torch.params import torch_layout, torch_name

pytestmark = pytest.mark.usefixtures("one_thread")
POLICIES = [None, "recompute-big", "dots-no-batch"]
SG_3D = dict(encoder=dict(sg_conv_hidden=((3, 3, 3, 3), (3, 3, 3, 3))))
NODES = {"protein": 6, "synthetic2": 8}


def _cfg(dataset, model_type, **over):
    extra = SG_3D if dataset == "protein" else {}
    _, tc = configs("small", dataset, num_nodes=NODES[dataset], model_type=model_type,
                    **extra, **over)
    return tc.with_(train=dataclasses.replace(tc.train, batch_size=2))


def _step(cfg, dtype=torch.float64, keep=1.0, count=None):
    """One train step from the seed weights on 2 train graphs with fixed ε;
    returns the loss, the gradients and the level-3 wrapper's calls."""
    cfg = cfg.with_(train=dataclasses.replace(cfg.train, dropout_keep_prob=keep))
    model = build_model(cfg.with_(compute_dtype="float32"), "cpu").to(
        torch.float64 if dtype == torch.float64 else torch.float32).train()
    data = load_dataset(cfg, "train", num_graphs=2, device="cpu")
    state = ttrain.TrainState(cfg=cfg, model=model,
                              optimizer=ttrain.make_optimizer(cfg, model.parameters()),
                              generator=torch.Generator().manual_seed(0))
    g, enc = torch.Generator().manual_seed(3), cfg.encoder
    S = 1 if cfg.model_type in ("base", "geoGCN", "posGCN") else cfg.sampling_num
    eps = Latents(z_sg=torch.randn(2, S, enc.sg_latent_size, generator=g, dtype=torch.float64),
                  z_s=torch.randn(2, enc.s_latent_size, generator=g, dtype=torch.float64),
                  z_g=torch.randn(2, enc.g_latent_size, generator=g, dtype=torch.float64))
    if count is not None:
        count[0] = 0
    batch = data.to(dtype=torch.float64) if dtype == torch.float64 else data
    aux = ttrain.train_step(state, batch, torch.tensor(0.0), eps=eps)
    # scene's loss leaves the node head without a gradient
    return aux["loss"].item(), {k: p.grad.clone() for k, p in model.named_parameters()
                                if p.grad is not None}


@pytest.fixture
def level3_calls(monkeypatch):
    """Calls of ``fused_motif_level3`` (the kernel's wrapper), counted."""
    count, wrapped = [0], ml.fused_motif_level3

    def counting(*args):
        count[0] += 1
        return wrapped(*args)

    monkeypatch.setattr(ml, "fused_motif_level3", counting)
    return count


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("dataset,model_type,block_rows,keep", [
    ("synthetic2", "disentangled", None, 1.0), ("synthetic2", "base", None, 0.8),
    ("protein", "disentangled", None, 1.0), ("protein", "base", None, 0.8),
    ("synthetic2", "disentangled", 4, 1.0), ("protein", "base", 3, 1.0),
])
def test_remat_step_equals_the_step_without(level3_calls, dataset, model_type, block_rows,
                                            keep, policy):
    """Float64: loss and gradients at 1e-12 (the same operations run); the
    joint model with dropout draws the same masks (none lies in a region);
    each third-order conv's wrapper runs again in the recompute."""
    cfg = _cfg(dataset, model_type, motif_block_rows=block_rows)
    loss0, ref = _step(cfg, keep=keep, count=level3_calls)
    calls0 = level3_calls[0]
    loss, got = _step(cfg.with_(remat=True, remat_policy=policy), keep=keep,
                      count=level3_calls)
    np.testing.assert_allclose(loss, loss0, rtol=1e-12)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=1e-12,
                                   atol=1e-14 * ref[name].abs().max().item(), err_msg=name)
    convs = 0 if dataset == "protein" else 2
    assert (calls0, level3_calls[0]) == (convs, 2 * convs)


@pytest.mark.parametrize("dataset,model_type,policy", [
    ("synthetic2", "disentangled", "recompute-big"), ("synthetic2", "base", "dots-no-batch"),
    ("protein", "disentangled", None), ("protein", "base", "recompute-big"),
])
def test_remat_step_matches_jax_remat_f64(exact_f64, dataset, model_type, policy):
    """The JAX model built with the same remat and policy: loss and every
    gradient at rtol 1e-8."""
    over = dict(SG_3D) if dataset == "protein" else {}
    jc, tc, jm, p, tm, arrays = setup_models(
        "small", np.float64, dataset, split="train", init=random_params, model_type=model_type,
        num_nodes=NODES[dataset], remat=True, remat_policy=policy, **over)
    eps = _eps(jc, model_type, len(arrays["adj"]))
    j_total, grads = _jax_loss_and_grads(jc, jm, p, jax_batch(**arrays, dtype=np.float64),
                                         {k: jnp.asarray(v) for k, v in eps.items()})
    loss, got = _port_step(tc, tm, arrays, eps)
    np.testing.assert_allclose(loss, float(j_total), rtol=1e-8)
    flat_g = flatten_dict(grads, sep="/")
    assert len(flat_g) == len(got)
    for path, g in flat_g.items():
        g = torch_layout(path, np.asarray(g))
        np.testing.assert_allclose(got[torch_name(path)].numpy(), g, rtol=1e-8,
                                   atol=1e-10 * np.abs(g).max(), err_msg=path)


def _storages(tree):
    return {t.untyped_storage().data_ptr() for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


class _TaggedOutputs(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the tensors that ops inside ``big(...)`` regions write into
    new memory (a view of an op's input is not one of them), and holds
    them, so that no later tensor reuses their memory."""

    def __init__(self):
        super().__init__()
        self.tensors = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if ckpt.open_regions():
            inputs = _storages((args, kwargs))
            self.tensors += [t for t in torch.utils._pytree.tree_leaves(out)
                             if isinstance(t, torch.Tensor)
                             and t.untyped_storage().data_ptr() not in inputs]
        return out

    @property
    def storages(self):
        return {t.untyped_storage().data_ptr() for t in self.tensors}


def _cached_tensors(mode):
    """The tensors a selective-checkpoint forward mode keeps (its storage
    maps each op to its entries, a list or a dict by call index)."""
    out = []
    for entries in mode.storage.values():
        for entry in (entries.values() if isinstance(entries, dict) else entries):
            for leaf in torch.utils._pytree.tree_leaves(entry):
                if isinstance(getattr(leaf, "val", None), torch.Tensor):
                    out.append(leaf.val)
    return out


@pytest.mark.parametrize("dataset,model_type", [("synthetic2", "disentangled"),
                                                ("protein", "base")])
def test_recompute_big_keeps_no_tagged_tensor(dataset, model_type):
    """Without remat the backward keeps tagged tensors (the m4_sum, the E2E
    maps); under recompute-big neither autograd's saved tensors outside the
    regions nor the policy's cache inside them hold one, while the cache
    does hold the small tensors."""
    cfg = _cfg(dataset, model_type, decoder=dict(adj_head_factored=False))
    data = load_dataset(cfg, "train", num_graphs=2, device="cpu")
    kept = {}
    for policy in (None, "recompute-big"):
        model = build_model(cfg.with_(remat=policy is not None, remat_policy=policy), "cpu")
        model.train()
        saved, caches = [], []
        if policy is not None:
            make = model.remat_context

            def capture():
                fwd, recompute = make()
                caches.append(fwd)
                return fwd, recompute

            model.remat_context = capture
        tagged = _TaggedOutputs()
        with tagged, torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
            out = model(data, generator=torch.Generator().manual_seed(0))
        cached = [t for c in caches for t in _cached_tensors(c)]
        kept[policy] = (_storages(saved) | _storages(cached)) & tagged.storages
        assert tagged.storages
        if policy is not None:
            assert cached and len(caches) == 3      # two motif convs and the head
        out.decoded.adj_prob.sum().backward()
    assert kept[None] and not kept["recompute-big"], kept


@pytest.mark.parametrize("dataset", ["synthetic1", "synthetic2", "synthetic3", "protein",
                                     "mnist", "scene"])
def test_remat_runs_on_every_preset(dataset):
    """A float64 remat step (recompute-big) at the small widths on each
    preset, both families where the dataset has trees (and geoGCN on
    synthetic1), equal to the step without."""
    types = {"scene": ["base"], "synthetic1": ["disentangled", "geoGCN"]}.get(
        dataset, ["disentangled", "base"])
    for model_type in types:
        over = dict(SG_3D) if dataset in ("protein", "mnist") else {}
        _, tc = configs("small", dataset, num_nodes=10 if dataset == "scene" else 6,
                        model_type=model_type, **over)
        tc = tc.with_(train=dataclasses.replace(tc.train, batch_size=2))
        loss0, ref = _step(tc)
        loss, got = _step(tc.with_(remat=True, remat_policy="recompute-big"))
        assert np.isfinite(loss) and loss == pytest.approx(loss0, rel=1e-12), model_type
        assert got.keys() == ref.keys()
        for name, g in got.items():
            torch.testing.assert_close(g, ref[name], rtol=1e-12, atol=1e-14)


def test_remat_bf16_step_equals_the_step_without():
    """bf16 runs on casts of the f32 masters (functional_call); the
    recompute binds the same casts, so the gradients are the same bits."""
    cfg = _cfg("synthetic2", "disentangled", compute_dtype="bfloat16")
    loss0, ref = _step(cfg, dtype=torch.float32)
    for policy in POLICIES:
        loss, got = _step(cfg.with_(remat=True, remat_policy=policy), dtype=torch.float32)
        assert loss == loss0, policy
        for name, g in got.items():
            assert torch.equal(g, ref[name]), (policy, name)


def test_policy_from_config_resolution():
    assert ckpt.policy_from_config(False, "recompute-big") is None
    assert ckpt.policy_from_config(True, None) is None
    for name in ("recompute-big", "dots-no-batch"):
        assert callable(ckpt.policy_from_config(True, name))
    for bad in ("bogus", "offload-big"):
        with pytest.raises(ValueError):
            ckpt.policy_from_config(True, bad)
    with pytest.raises(ValueError):
        build_model(_cfg("synthetic2", "disentangled", remat=True, remat_policy="bogus"), "cpu")
    with pytest.raises(ValueError, match="BIG_NAMES"):
        with ckpt.big("sgc.unregistered"):
            pass


def test_big_names_cover_the_region_sites():
    """Every ``big(...)`` in the port names a registered tensor, and every
    registered name has its site."""
    root = pathlib.Path(__file__).resolve().parents[1] / "snd_vae_tpu_torch"
    used = set()
    for f in root.rglob("*.py"):
        used |= set(re.findall(r"""\bbig\(\s*["']([a-z0-9._]+)["']\s*\)""", f.read_text()))
    used.discard("sgc.unregistered")
    assert used == set(ckpt.BIG_NAMES), used ^ set(ckpt.BIG_NAMES)
