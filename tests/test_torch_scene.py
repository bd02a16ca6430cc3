"""Scene (CLEVR) in the port: the loader's arrays bit-equal to the JAX
package's ``load_data_scene`` (the seeded fallback generator, train and
val, and a tiny CLEVR JSON written here), the directed adjacency kept as it
is, and the joint model's level 3 on it: ``motif_level3_plain`` against the
JAX default path and the Pallas kernel (interpret mode) on an asymmetric,
integer-weighted A."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import exact_f64, one_thread  # noqa: F401  (fixtures)

from snd_vae_tpu import config as jcfg
from snd_vae_tpu import nn as jops
from snd_vae_tpu.data import loaders as jloaders
from snd_vae_tpu.nn.pallas.blocked_spmm import fused_motif_combine
from snd_vae_tpu_torch import config as tcfg
from snd_vae_tpu_torch.data import loaders as tloaders
from snd_vae_tpu_torch.nn import spatial_graph_conv
from snd_vae_tpu_torch.nn.kernels.motif_level3 import motif_level3, motif_level3_plain

pytestmark = pytest.mark.usefixtures("one_thread")
FIELDS = ("adj", "features", "coords", "rel", "adj_samples", "factors", "node_mask",
          "feat_samples", "rel_samples")


@pytest.mark.parametrize("split", ["train", "test"])
def test_fallback_bit_equal(tmp_path, split):
    """No JSON under the dataset path: both packages generate from the seed."""
    cfg = dict(dataset_path=str(tmp_path))
    want = jloaders.load_dataset(jcfg.scene_preset(**cfg), split, num_graphs=12)
    got = tloaders.load_dataset(tcfg.scene_preset(**cfg), split, num_graphs=12, device="cpu")
    for f in FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
    adj = got.adj.numpy()
    assert got.adj_samples is None and adj.shape == (12, 10, 10)
    assert not np.allclose(adj, np.swapaxes(adj, 1, 2))              # directed
    assert set(np.unique(adj)) == {0.0, 1.0, 2.0} and not np.diagonal(adj, 0, 1, 2).any()


def _clevr(rng, n_scenes):
    """CLEVR-layout scenes: objects with shape and 3d_coords; relationships
    ``rel[k]`` = the objects that stand in that relation to object k."""
    shapes = ["sphere", "cylinder", "cube"]
    scenes = []
    for s in range(n_scenes):
        n = 9 if s == 1 else 10                                       # skipped: not 10 objects
        pts = rng.uniform(-3, 3, (n, 3))
        rel = {"right": [[m for m in range(n) if pts[m, 0] > pts[k, 0]] for k in range(n)],
               "left": [[m for m in range(n) if pts[m, 0] < pts[k, 0]] for k in range(n)],
               "behind": [[m for m in range(n) if pts[m, 1] > pts[k, 1]] for k in range(n)],
               "front": [[m for m in range(n) if pts[m, 1] < pts[k, 1]] for k in range(n)]}
        scenes.append({"objects": [{"shape": shapes[rng.integers(3)],
                                    "3d_coords": pts[j].tolist()} for j in range(n)],
                       "relationships": rel})
    return {"scenes": scenes}


def test_clevr_json_bit_equal(tmp_path, rng):
    for split in ("train", "val"):
        (tmp_path / f"CLEVR_{split}_scenes.json").write_text(json.dumps(_clevr(rng, 5)))
    for split in ("train", "test"):
        cfg = dict(dataset_path=str(tmp_path))
        want = jloaders.load_dataset(jcfg.scene_preset(**cfg), split)
        got = tloaders.load_dataset(tcfg.scene_preset(**cfg), split, device="cpu")
        assert got.batch_size == 4
        for f in ("adj", "features", "coords", "rel"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), err_msg=f)
        assert set(np.unique(got.adj.numpy())) <= {0.0, 1.0, 2.0, 3.0, 4.0}


def _asym_level3(rng, B, N, h, R=1):
    """adj, φ(rel), a_i, v_j, deg, M1d, M1f, bias at scene's kind of A:
    directed, integer weights 0..4, zero diagonal."""
    adj = rng.integers(0, 5, (B, N, N)).astype(np.float64)
    adj[:, np.arange(N), np.arange(N)] = 0
    assert not np.allclose(adj, np.swapaxes(adj, 1, 2))
    rel = rng.uniform(0, 8, (B, N, N, R))
    draw = lambda *s: rng.standard_normal(s)
    return [adj, np.maximum(rel, 0.2 * rel), draw(B, N, h), draw(B, N, h), adj.sum(-1),
            draw(R, h), draw(R, h), draw(h)]


def _jax_level3(adj, phi_r, a_i, v_j, deg, m1d, m1f, bias):
    """Level 3 as the JAX default path writes it (snd_vae_tpu/nn/
    spatial_conv.py:208-238, the j-only terms folded into v_j)."""
    f32 = dict(preferred_element_type=jnp.float32)
    rf = jnp.einsum("bjk,bikr->bijr", adj, phi_r, **f32).astype(adj.dtype)
    d_ij = jnp.einsum("...f,fo->...o", phi_r, m1d, **f32).astype(adj.dtype)
    wf = jnp.einsum("...f,fo->...o", rf, m1f, **f32).astype(adj.dtype)
    m3 = adj[..., None] * (deg[:, None, :, None] * (a_i[:, :, None] + d_ij + bias)
                           + v_j[:, None] + wf)
    return jnp.einsum("bij,bijh->bih", adj, jops.lrelu(m3), **f32).astype(adj.dtype)


@pytest.mark.parametrize("h", [20, 50])
def test_level3_plain_on_asymmetric_weighted_adj_f64(rng, exact_f64, h):
    """Scene's shapes [2,10,10,h]: the plain version against the JAX
    formula in float64 (rtol 1e-10), and its gradients against jax.vjp."""
    x = _asym_level3(rng, 2, 10, h)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in x]
    got = motif_level3(*ts)
    want, vjp = jax.vjp(_jax_level3, *map(jnp.asarray, x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-10, atol=1e-10)
    g = rng.standard_normal(got.shape)
    grads = torch.autograd.grad(got, ts, torch.from_numpy(g))
    for name, a, b in zip(("adj", "phi_r", "a_i", "v_j", "deg", "m1d", "m1f", "bias"),
                          grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-9, err_msg=name)


def test_level3_plain_matches_pallas_kernel_on_asymmetric_adj(rng):
    """f32: the plain version against the Pallas motif-combine kernel run in
    interpret mode (then lrelu and the j-sum, as the JAX Pallas branch
    does), on a directed integer-weighted A, at rtol 1e-5 / atol 1e-4 of
    outputs ~10^3 (f32 sums in another order)."""
    adj, phi_r, a_i, v_j, deg, m1d, m1f, bias = (a.astype(np.float32)
                                                 for a in _asym_level3(rng, 2, 10, 20))
    m3 = fused_motif_combine(*map(jnp.asarray, (adj, a_i, phi_r @ m1d, v_j, phi_r @ m1f, bias)),
                             interpret=True)
    want = np.einsum("bij,bijh->bih", adj, np.asarray(jops.lrelu(m3)))
    got = motif_level3_plain(*map(torch.from_numpy, (adj, phi_r, a_i, v_j, deg, m1d, m1f, bias)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_spatial_graph_conv_on_scene_batch_matches_jax_f64(rng, key, exact_f64):
    """The whole motif conv on the fallback scene data: a directed A of codes
    1 and 2, raw distances, one-hot shapes."""
    b = tloaders.load_dataset(tcfg.scene_preset(), "train", num_graphs=2, device="cpu")
    adj, x, rel = (t.double().numpy() for t in (b.adj, b.features, b.rel))
    jm = jops.SpatialGraphConv(hidden=(20, 20, 20))
    p = jm.init(key, *(jnp.asarray(a, jnp.float32) for a in (adj, x, rel)))["params"]
    p = jax.tree.map(lambda t: 0.1 * rng.standard_normal(t.shape), p)
    want = jops.spatial_graph_conv(*map(jnp.asarray, (adj, x, rel)), p)
    got = spatial_graph_conv(*map(torch.from_numpy, (adj, x, rel)),
                             {k: torch.from_numpy(v) for k, v in p.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-9)
