"""The port's JointSNDVAE (the "base" model) against the JAX package's, with
the flax parameters carried across by ``params.state_dict_from_flax``: a
small config and the full synthetic2 width, synthetic3 (linear coordinate
head) and scene (categorical node and K-way edge heads over a directed,
integer-weighted adjacency), encode / decode / forward with shared ε / the
served path, and dropout at keep 0.8 with the masks JAX draws.

float64 at rtol 1e-8 / atol 1e-10 under ``exact_f64``; f32 at rtol 1e-4 /
atol 1e-5 (sums in another order), but scene at full width: its raw
distances (up to ~10) and edge codes (up to 4) grow the motif convs'
activations to ~10^12, where the f32 sums cancel to a few 1e-6 of the
largest magnitude; there atol is 1e-5 of each output's largest magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import exact_f64, one_thread  # noqa: F401  (fixtures)
from torch_parity import init_like, random_params, setup_models

from snd_vae_tpu.data.graphbatch import from_numpy as jax_batch
from snd_vae_tpu.models import JointSNDVAE as JaxJoint
from snd_vae_tpu.models.outputs import Latents as JaxLatents
from snd_vae_tpu_torch import config as tcfg
from snd_vae_tpu_torch.data.graphbatch import from_numpy as torch_batch
from snd_vae_tpu_torch.data.loaders import load_dataset
from snd_vae_tpu_torch.models import JointSNDVAE, build_model
from snd_vae_tpu_torch.models.outputs import Latents
from snd_vae_tpu_torch.serve import reconstruct, sample

pytestmark = pytest.mark.usefixtures("one_thread")
TOL = {np.float64: (1e-8, 1e-10), np.float32: (1e-4, 1e-5)}
CASES = [("small", "synthetic2"), ("synthetic2", "synthetic2"), ("small", "synthetic3"),
         ("small", "scene"), ("synthetic2", "scene")]


def _close(got, want, np_dtype, what="", atol_of_max=None):
    rtol, atol = TOL[np_dtype]
    if atol_of_max is not None:
        atol = atol_of_max * np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _check_decoded(td, jd, np_dtype, scene, atol_of_max=None):
    for f in ("adj_prob", "coords") + (("node_feat_prob",) if scene else ("node_feat",)):
        _close(getattr(td, f), getattr(jd, f), np_dtype, f, atol_of_max)
    # the argmaxes, wherever the best two logits are apart
    for got, want, logits in ((td.adj, jd.adj, jd.adj_prob),) + (
            ((td.node_feat[..., 0], jd.node_feat[..., 0], jd.node_feat_prob),) if scene else ()):
        top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
        decided = top2[..., 1] - top2[..., 0] > 1e-6
        np.testing.assert_array_equal(got.numpy()[decided], np.asarray(want)[decided])


def _check(case, dataset, np_dtype, **over):
    # f32 at full width at the initializers' scale (see init_like)
    init = init_like if (case, np_dtype) == ("synthetic2", np.float32) else random_params
    jc, _, jm, p, tm, arrays = setup_models(case, np_dtype, dataset, init=init,
                                            model_type="base", **over)
    assert isinstance(tm, JointSNDVAE)
    scene = dataset == "scene"
    big = 1e-5 if (case, scene, np_dtype) == ("synthetic2", True, np.float32) else None
    jb, tb = jax_batch(**arrays, dtype=np_dtype), torch_batch(**arrays, dtype=tm.dtype)
    apply = lambda method=None, **kw: jax.jit(
        lambda p, *a: jm.apply({"params": p}, *a, method=method, **kw))

    js, ts = apply(JaxJoint.encode)(p, jb), tm.encode(tb)
    assert ts.mean_sg.shape == (2, 1, jc.encoder.sg_latent_size) and ts.mean_s is None
    _close(ts.mean_sg, js.mean_sg, np_dtype, atol_of_max=big)
    _close(ts.logstd_sg, js.logstd_sg, np_dtype, atol_of_max=big)

    z = np.random.default_rng(2).standard_normal(js.mean_sg.shape).astype(np_dtype)
    jd = apply(JaxJoint.decode)(p, JaxLatents(z_sg=jnp.asarray(z)))
    td = tm.decode(Latents(z_sg=torch.from_numpy(z)))
    _check_decoded(td, jd, np_dtype, scene, big)

    # forward with JAX's own ε (no dropout: the key is not split)
    key = jax.random.PRNGKey(3)
    jo = apply()(p, jb, key)
    eps = np.array(jax.random.normal(key, js.mean_sg.shape, js.mean_sg.dtype))
    to = tm(tb, eps=Latents(z_sg=torch.from_numpy(eps)))
    _close(to.latents.z_sg, jo.latents.z_sg, np_dtype, atol_of_max=big)
    _check_decoded(to.decoded, jo.decoded, np_dtype, scene, big)

    # the served path: encode, posterior mean, decode
    jo = apply(deterministic_z=True)(p, jb)
    _check_decoded(reconstruct(tm, tb).decoded, jo.decoded, np_dtype, scene, big)


@pytest.mark.parametrize("case,dataset", CASES)
def test_joint_matches_jax_f64(case, dataset, exact_f64):
    with torch.no_grad():
        _check(case, dataset, np.float64)


@pytest.mark.parametrize("case,dataset", CASES)
def test_joint_matches_jax_f32(case, dataset):
    with torch.no_grad():
        _check(case, dataset, np.float32)


def _jax_masks(jc, drop_key, keep, B):
    """The masks JointSNDVAE.__call__ draws at keep < 1: encoder layer i from
    fold_in(drop_key, i); decoder site i (coords i, node 100 + i) from
    fold_in(fold_in(drop_key, 101), i)."""
    enc, dec, N = jc.encoder, jc.decoder, jc.num_nodes
    bern = lambda k, i, width: torch.from_numpy(np.array(
        jax.random.bernoulli(jax.random.fold_in(k, i), keep, (B, N, width))))
    masks = {("encode", i): bern(drop_key, i, h[-1]) for i, h in enumerate(enc.sg_conv_hidden)}
    dk = jax.random.fold_in(drop_key, 101)
    masks.update({("decode", i): bern(dk, i, c) for i, c in enumerate(dec.s_d_channels)})
    masks.update({("decode", 100 + i): bern(dk, 100 + i, c)
                  for i, c in enumerate(dec.n_d_channels)})
    return masks


@pytest.mark.parametrize("np_dtype,dataset", [(np.float64, "synthetic2"),
                                              (np.float32, "synthetic2"),
                                              (np.float64, "scene")])
def test_joint_dropout_matches_jax(request, np_dtype, dataset):
    """keep 0.8: JAX's forward with its key against the port's forward fed
    the masks jax.random.bernoulli draws on the folded keys and JAX's ε."""
    if np_dtype == np.float64:
        request.getfixturevalue("exact_f64")
    keep = 0.8
    _, _, jm, p, tm, arrays = setup_models("small", np_dtype, dataset, model_type="base")
    jb, tb = jax_batch(**arrays, dtype=np_dtype), torch_batch(**arrays, dtype=tm.dtype)
    key = jax.random.PRNGKey(5)
    jo = jax.jit(lambda p, b, k: jm.apply({"params": p}, b, k, dropout_keep=keep))(p, jb, key)
    z_key, drop_key = jax.random.split(key)
    masks = _jax_masks(jm.cfg, drop_key, keep, 2)
    assert 0 < sum(int((~m).sum()) for m in masks.values())        # some units dropped
    eps = torch.from_numpy(np.array(
        jax.random.normal(z_key, jo.stats.mean_sg.shape, jo.stats.mean_sg.dtype)))
    with torch.no_grad():
        to = tm(tb, eps=Latents(z_sg=eps), dropout_keep=keep, dropout_masks=masks)
    _close(to.stats.mean_sg, jo.stats.mean_sg, np_dtype)
    _check_decoded(to.decoded, jo.decoded, np_dtype, dataset == "scene")


def test_dropout_is_reproducible_and_drops():
    """Masks drawn from the generator: the same seed gives the same output,
    another seed another; keep 1 is the identity."""
    cfg = tcfg.synthetic2_preset(model_type="base")
    tm = build_model(cfg, device="cpu")
    b = load_dataset(cfg, "test", num_graphs=2, device="cpu")
    run = lambda seed, keep: tm(b, deterministic_z=True, dropout_keep=keep,
                                generator=torch.Generator().manual_seed(seed)).decoded.adj_prob
    with torch.no_grad():
        assert torch.equal(run(0, 0.8), run(0, 0.8))
        assert not torch.equal(run(0, 0.8), run(1, 0.8))
        assert torch.equal(run(0, 1.0), reconstruct(tm, b).decoded.adj_prob)


def test_dropout_op():
    from snd_vae_tpu_torch.nn import dropout

    x = torch.arange(1.0, 2001.0)
    y = dropout(x, 0.8, torch.Generator().manual_seed(0))
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.8)
    assert 0.75 < kept.float().mean() < 0.85
    mask = torch.arange(2000) % 2 == 0
    assert torch.equal(dropout(x, 0.5, mask=mask), torch.where(mask, 2 * x, 0.0))
    assert dropout(x, 1.0) is x
    with pytest.raises(ValueError):
        dropout(x, 0.5)


@pytest.mark.parametrize("dataset", ["synthetic2", "scene"])
def test_generate_shapes(dataset):
    cfg = tcfg.preset(dataset, model_type="base")
    tm = build_model(cfg, device="cpu")
    d = sample(tm, 3, torch.Generator().manual_seed(0))
    N, K = cfg.num_nodes, cfg.decoder.num_edge_feature
    F = 1 if dataset == "scene" else cfg.num_features       # scene: the shape's index
    assert d.adj.shape == (3, N, N) and d.adj_prob.shape == (3, N, N, K)
    assert d.coords.shape == (3, N, cfg.spatial_dim) and d.node_feat.shape == (3, N, F)
    assert int(d.adj.max()) < K and torch.isfinite(d.adj_prob).all()
    with pytest.raises(ValueError):
        sample(tm, 3, torch.Generator().manual_seed(0), num_samples=10)
