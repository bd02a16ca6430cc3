"""The port's geometric stack (``snd_vae_tpu_torch.nn.geometric``) and the
geoGCN / posGCN models against the JAX package: each helper and both
layers on 2D (lifted to z = 0) and 3D coordinates in float64 at rtol 1e-8
/ atol 1e-10, the layers' f32 at rtol 1e-4 / atol 1e-5, and the two
baseline models (encode, decode, reparameterize, the served path) as
``tests/test_torch_model.py`` holds the disentangled one.  The geoGCN /
posGCN encoders run on the truth graph with S = 1; their g-branch
GraphConv goes through K3's wrapper (its plain version here).

Two places where the quaternion features depend on rounding in JAX as in
the port, so the inputs or tolerances below avoid them:
  * each node's first neighbour is itself, whose relative rotation is the
    identity up to rounding; a quaternion component there is
    sign(r_ij - r_ji)·sqrt(|rounding|) ~ 1e-8 in float64, so the 3D
    orientation features and posGCN's layer are held at atol 1e-7;
  * on planar coordinates, neighbours whose frames turn opposite ways are
    rotated by 180°, where r is symmetric and the sign of a unit component
    is that of a rounding residue; the 2D cases take points along a convex
    arc, whose frames all turn one way."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from torch_parity import exact_f64, one_thread  # noqa: F401  (fixtures)
from torch_parity import init_like, random_params, setup_models

from snd_vae_tpu.data.graphbatch import from_numpy as jax_batch
from snd_vae_tpu.models import DisentangledSNDVAE as JaxModel
from snd_vae_tpu.models.outputs import Latents as JaxLatents
from snd_vae_tpu.nn import geometric as jgeo
from snd_vae_tpu_torch.data.graphbatch import from_numpy as torch_batch
from snd_vae_tpu_torch.models.outputs import Latents
from snd_vae_tpu_torch.nn import geometric as tgeo
from snd_vae_tpu_torch.nn.kernels import adj_matmul as am
from snd_vae_tpu_torch.nn.kernels import motif_level3 as ml
from snd_vae_tpu_torch.params import state_dict_from_flax
from snd_vae_tpu_torch.serve import reconstruct

pytestmark = pytest.mark.usefixtures("one_thread")
GEN = torch.Generator().manual_seed(0)


def _coords(rng, B, L, D):
    """3D: uniform in a box; 2D: along a convex arc (see the docstring)."""
    if D == 3:
        return rng.uniform(-2.0, 2.0, (B, L, D))
    t = np.sort(rng.uniform(0.0, 1.5 * np.pi, (B, L)), axis=1)
    r = 2.0 + 0.1 * rng.random((B, 1))
    return np.stack([r * np.cos(t), r * np.sin(t)], -1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=1e-8, atol=1e-10):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("D", [2, 3])
def test_helpers_match_jax_f64(rng, exact_f64, D):
    """knn_dist (values and indices), rbf_expand, positional_embedding,
    gather_nodes, orientations and quaternions, at L = 12, top_k = 5."""
    x = _coords(rng, 2, 12, D)
    x3 = np.concatenate([x, np.zeros(x.shape[:-1] + (3 - D,))], -1)
    jd, jidx = jgeo.knn_dist(jnp.asarray(x3), top_k=5)
    td, tidx = tgeo.knn_dist(_t(x3), top_k=5)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(td, jd)
    assert (tidx[..., 0] == torch.arange(12)).all()                   # itself first
    _close(tgeo.rbf_expand(td), jgeo.rbf_expand(jd))
    # float32 in JAX, float64 under exact_f64 (see torch_parity.py)
    pe = tgeo.positional_embedding(tidx, dtype=torch.float64)
    _close(pe, jgeo.positional_embedding(jidx))
    np.testing.assert_allclose(tgeo.positional_embedding(tidx).numpy(), pe.numpy(),
                               rtol=1e-6, atol=1e-6)
    nodes = rng.standard_normal((2, 12, 4))
    _close(tgeo.gather_nodes(_t(nodes), tidx), jgeo.gather_nodes(jnp.asarray(nodes), jidx))
    jad, jo = jgeo.orientations(jnp.asarray(x3), jidx)
    tad, to = tgeo.orientations(_t(x3), tidx)
    _close(tad, jad)
    _close(to, jo, atol=1e-7 if D == 3 else 1e-10)
    r = rng.standard_normal((5, 3, 3))
    _close(tgeo.quaternions(_t(r)), jgeo.quaternions(jnp.asarray(r)))


def test_knn_ties_go_to_the_lower_index():
    """Equal distances keep lax.top_k's order: the lower index first."""
    x = torch.tensor([[[0.0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0]]], dtype=torch.float64)
    _, idx = tgeo.knn_dist(x, top_k=4)
    _, jidx = jgeo.knn_dist(jnp.asarray(x.numpy()), top_k=4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[0, 0].tolist() == [0, 1, 2, 3]


def _layer_pair(layer, rng, key, x, geo, adj, np_dtype, **kw):
    """The JAX layer's params (randomised) and the port layer carrying them."""
    jl = getattr(jgeo, layer)(5, **kw)
    p = jl.init(key, *(jnp.asarray(a, jnp.float32) for a in (adj, x, geo)))["params"]
    p = jax.tree.map(lambda t: (0.3 * rng.standard_normal(t.shape)).astype(np_dtype), p)
    tl = getattr(tgeo, layer)(x.shape[-1], 5, GEN, **kw).to(torch.from_numpy(x).dtype)
    tl.load_state_dict(state_dict_from_flax(flatten_dict(p, sep="/")))
    return jl, p, tl


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("R", [1, 2])
def test_geo_graph_conv_matches_jax(request, rng, key, np_dtype, R):
    if np_dtype == np.float64:
        request.getfixturevalue("exact_f64")
    tol = (1e-8, 1e-10) if np_dtype == np.float64 else (1e-4, 1e-5)
    adj = (rng.random((2, 9, 9)) < 0.4).astype(np_dtype)
    x = rng.standard_normal((2, 9, 3)).astype(np_dtype)
    rel = rng.random((2, 9, 9, R)).astype(np_dtype)
    jl, p, tl = _layer_pair("GeoGraphConv", rng, key, x, rel, adj, np_dtype)
    want = jl.apply({"params": p}, *map(jnp.asarray, (adj, x, rel)))
    got = tl(_t(adj), _t(x), _t(rel))
    assert got.shape == (2, 9, 5 * R)
    _close(got, want, *tol)


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("D", [2, 3])
def test_struct_graph_conv_matches_jax(request, rng, key, np_dtype, D):
    """posGCN's layer, 2D coordinates lifted to z = 0, top_k = 6 of 11."""
    if np_dtype == np.float64:
        request.getfixturevalue("exact_f64")
    tol = (1e-8, 1e-10) if np_dtype == np.float64 else (1e-4, 1e-5)
    adj = (rng.random((2, 11, 11)) < 0.4).astype(np_dtype)
    x = rng.standard_normal((2, 11, 3)).astype(np_dtype)
    c = _coords(rng, 2, 11, D).astype(np_dtype)
    jl, p, tl = _layer_pair("StructGraphConv", rng, key, x, c, adj, np_dtype, top_k=6)
    want = jl.apply({"params": p}, *map(jnp.asarray, (adj, x, c)))
    got = tl(_t(adj), _t(x), _t(c))
    assert got.shape == (2, 11, 5)
    _close(got, want, tol[0], 1e-7 if (np_dtype, D) == (np.float64, 3) else tol[1])


def test_layer_gradients_reach_every_parameter(rng):
    adj = _t((rng.random((2, 9, 9)) < 0.4).astype(np.float32))
    x = _t(rng.standard_normal((2, 9, 3)).astype(np.float32))
    c = _t(_coords(rng, 2, 9, 2).astype(np.float32))
    for layer, geo in ((tgeo.GeoGraphConv(3, 5, GEN), adj[..., None]),
                       (tgeo.StructGraphConv(3, 5, GEN, top_k=4), c)):
        layer(adj, x, geo).square().sum().backward()
        for name, prm in layer.named_parameters():
            assert prm.grad is not None and torch.isfinite(prm.grad).all(), name
            assert prm.grad.abs().sum() > 0, name


# --------------------------------------------------------------------------
# The geoGCN / posGCN models
# --------------------------------------------------------------------------

def _check_model(model_type, case, np_dtype):
    rtol, atol = (1e-8, 1e-10) if np_dtype == np.float64 else (1e-4, 1e-5)
    close = lambda g, w: _close(g, w, rtol, atol)
    init = init_like if (case, np_dtype) == ("synthetic2", np.float32) else random_params
    jc, _, jm, p, tm, arrays = setup_models(case, np_dtype, init=init, model_type=model_type)
    jb, tb = jax_batch(**arrays, dtype=np_dtype), torch_batch(**arrays, dtype=tm.dtype)
    apply = lambda method=None, **kw: jax.jit(
        lambda p, *a: jm.apply({"params": p}, *a, method=method, **kw))
    js, ts = apply(JaxModel.encode)(p, jb), tm.encode(tb)
    assert ts.mean_sg.shape == (2, 1, jc.encoder.sg_latent_size)
    for f in ("mean_sg", "logstd_sg", "mean_s", "logstd_s", "mean_g", "logstd_g"):
        close(getattr(ts, f), getattr(js, f))
    rng = np.random.default_rng(2)
    enc = jc.encoder
    lat = {"z_sg": rng.standard_normal((2, 1, enc.sg_latent_size)),
           "z_s": rng.standard_normal((2, enc.s_latent_size)),
           "z_g": rng.standard_normal((2, enc.g_latent_size))}
    lat = {k: v.astype(np_dtype) for k, v in lat.items()}
    jd = apply(JaxModel.decode)(p, JaxLatents(**{k: jnp.asarray(v) for k, v in lat.items()}))
    td = tm.decode(Latents(**{k: torch.from_numpy(v) for k, v in lat.items()}))
    for f in ("adj_prob", "coords", "node_feat"):
        close(getattr(td, f), getattr(jd, f))
    key = jax.random.PRNGKey(3)
    jz = apply(JaxModel.reparameterize)(p, js, key)
    k_s, k_sg, k_g = jax.random.split(key, 3)
    noise = lambda k, t: torch.from_numpy(np.array(jax.random.normal(k, t.shape, t.dtype)))
    tz = tm.reparameterize(ts, eps=Latents(z_sg=noise(k_sg, js.mean_sg),
                                           z_s=noise(k_s, js.mean_s), z_g=noise(k_g, js.mean_g)))
    for f in ("z_sg", "z_s", "z_g"):
        close(getattr(tz, f), getattr(jz, f))
    jo = apply(deterministic_z=True)(p, jb)
    to = reconstruct(tm, tb)
    for f in ("adj_prob", "coords", "node_feat"):
        close(getattr(to.decoded, f), getattr(jo.decoded, f))


@pytest.mark.parametrize("model_type", ["geoGCN", "posGCN"])
@pytest.mark.parametrize("case", ["small", "synthetic2"])
def test_baseline_model_matches_jax_f64(model_type, case, exact_f64):
    with torch.no_grad():
        _check_model(model_type, case, np.float64)


@pytest.mark.parametrize("model_type", ["geoGCN", "posGCN"])
@pytest.mark.parametrize("case", ["small", "synthetic2"])
def test_baseline_model_matches_jax_f32(model_type, case):
    with torch.no_grad():
        _check_model(model_type, case, np.float32)


@pytest.mark.parametrize("model_type", ["geoGCN", "posGCN"])
def test_baseline_reconstruct_runs_no_motif_kernel(monkeypatch, model_type):
    """The baselines' joint branch has no motif conv: a reconstructed batch
    calls the level-3 wrapper never and K3's wrapper twice (the g-branch)."""
    seen = []
    for mod, name in ((ml, "fused_motif_level3"), (am, "blocked_adj_matmul")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name: (seen.append(_n), _fn(*a))[1])
    _, _, _, _, tm, arrays = setup_models("small", np.float32, model_type=model_type)
    reconstruct(tm, torch_batch(**arrays))
    assert seen == ["blocked_adj_matmul"] * 2


def test_planar_orientations_do_not_depend_on_rounding(rng):
    """On planar coordinates in general position (frames turning both ways,
    so 180° relative rotations occur), the port's orientation features in
    f32 equal its float64 ones within f32 rounding: no quaternion sign is
    taken of a rounding residue (the fixed-order product in
    ``orientations``), so the card and the CPU agree too."""
    x = np.concatenate([rng.uniform(0, 1, (2, 25, 2)), np.zeros((2, 25, 1))], -1)
    _, idx = tgeo.knn_dist(_t(x), top_k=10)
    _, o64 = tgeo.orientations(_t(x), idx)
    _, o32 = tgeo.orientations(_t(x.astype(np.float32)), idx)
    assert (o64[..., 6].abs() < 1e-6).any()                          # w = 0: rotations by 180°
    np.testing.assert_allclose(o32.double().numpy(), o64.numpy(), rtol=0, atol=2e-5)
