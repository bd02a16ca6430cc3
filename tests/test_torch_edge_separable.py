"""The port's separable E2E lowering (``E2E._separable``) and the factored
adjacency head, against the JAX package and against the port's own dense
path, as ``tests/test_edge_factored.py`` holds the JAX package's:

  * op level: the factor form against JAX's ``_separable`` and against the
    port's dense E2E on the tile-concat map, in float64 (rtol 1e-10) over
    k_h = 3 and k_h = N (and 5, 9: odd < N, > N), with and without the
    pairwise channels D; f32 against JAX at rtol 1e-4 / atol 1e-5;
  * BatchStatNorm per channel block equals the full map sliced;
  * model level: ``adj_head_factored`` True vs False give the same
    outputs and gradients for both families, and the factored model equals
    the JAX factored model in float64; the auto switch at N >= 96."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import exact_f64, one_thread  # noqa: F401  (fixtures)
from torch_parity import configs, setup_models

from snd_vae_tpu.data.graphbatch import from_numpy as jax_batch
from snd_vae_tpu.nn.edge_conv import E2E as JaxE2E
from snd_vae_tpu_torch.data.graphbatch import from_numpy as torch_batch
from snd_vae_tpu_torch.data.loaders import load_dataset
from snd_vae_tpu_torch.losses import elbo_loss
from snd_vae_tpu_torch.models import Latents, build_model
from snd_vae_tpu_torch.nn import E2E, BatchStatNorm
from snd_vae_tpu_torch.params import state_dict_from_flax

pytestmark = pytest.mark.usefixtures("one_thread")
GEN = torch.Generator().manual_seed(0)


def _dense_map(P, Q, D=None):
    B, N, _ = P.shape
    parts = [P[:, :, None, :].expand(B, N, N, P.shape[-1]),
             Q[:, None, :, :].expand(B, N, N, Q.shape[-1])]
    return torch.cat(parts + ([D] if D is not None else []), dim=-1)


def _pair(rng, key, k_h, c_in, O, np_dtype):
    """JAX's E2E params (randomised) and the port's E2E carrying them."""
    jm = JaxE2E(O, k_h=k_h, use_matmul=False)
    p = jm.init(key, jnp.zeros((1, 6, 6, c_in), jnp.float32))["params"]
    p = {k: rng.standard_normal(v.shape).astype(np_dtype) for k, v in p.items()}
    tm = E2E(c_in, O, k_h, GEN).to(torch.from_numpy(np.zeros(0, np_dtype)).dtype)
    tm.load_state_dict(state_dict_from_flax(p))
    return jm, p, tm


@pytest.mark.parametrize("k_h", [6, 5, 3, 9])      # == N, odd < N, 3, > N
@pytest.mark.parametrize("with_d", [False, True])
def test_e2e_separable_matches_jax_and_dense_f64(rng, key, k_h, with_d):
    B, N, C, O = 2, 6, 4, 5
    P, Q = rng.standard_normal((B, N, C)), rng.standard_normal((B, N, C))
    D = rng.standard_normal((B, N, N, 2)) if with_d else None
    jm, p, tm = _pair(rng, key, k_h, 2 * C + (2 if with_d else 0), O, np.float64)
    with jax.enable_x64():
        want = jm.apply({"params": p}, factors=tuple(
            None if a is None else jnp.asarray(a) for a in (P, Q, D)))
    tP, tQ = torch.from_numpy(P), torch.from_numpy(Q)
    tD = None if D is None else torch.from_numpy(D)
    with torch.no_grad():
        got = tm(factors=(tP, tQ, tD))
        dense = tm(_dense_map(tP, tQ, tD))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("with_d", [False, True])
def test_e2e_separable_matches_jax_f32(rng, key, with_d):
    B, N, C, O = 2, 25, 40, 50
    P = rng.standard_normal((B, N, C)).astype(np.float32)
    Q = rng.standard_normal((B, N, C)).astype(np.float32)
    D = rng.standard_normal((B, N, N, 1)).astype(np.float32) if with_d else None
    jm, p, tm = _pair(rng, key, N, 2 * C + (1 if with_d else 0), O, np.float32)
    p = {k: 0.02 * v for k, v in p.items()}               # the initializer's scale
    tm.load_state_dict(state_dict_from_flax(p))
    want = jm.apply({"params": p}, factors=tuple(
        None if a is None else jnp.asarray(a) for a in (P, Q, D)))
    with torch.no_grad():
        got = tm(factors=tuple(None if a is None else torch.from_numpy(a) for a in (P, Q, D)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_e2e_takes_one_input():
    e = E2E(4, 3, 5, GEN)
    with pytest.raises(ValueError):
        e()
    with pytest.raises(ValueError):
        e(torch.zeros(1, 5, 5, 4), factors=(torch.zeros(1, 5, 2),) * 2 + (None,))
    with pytest.raises(ValueError):
        e(factors=(torch.zeros(1, 5, 2), torch.zeros(1, 4, 2), None))


def test_batch_stat_norm_blocks_match_full_map(rng):
    """Replication along the broadcast axis changes neither moment, so the
    factor blocks normalise as the full map does."""
    B, N, C = 2, 5, 3
    P, Q = (torch.from_numpy(rng.normal(size=(B, N, C))) for _ in range(2))
    D = torch.from_numpy(rng.normal(size=(B, N, N, 2)))
    bn = BatchStatNorm(2 * C + 2).double()
    with torch.no_grad():
        bn.gamma.copy_(torch.from_numpy(rng.normal(size=2 * C + 2)))
        bn.beta.copy_(torch.from_numpy(rng.normal(size=2 * C + 2)))
        full = bn(_dense_map(P, Q, D))
        for got, want in ((bn(P, block=(0, C)), full[:, :, 0, :C]),
                          (bn(Q, block=(C, 2 * C)), full[:, 0, :, C:2 * C]),
                          (bn(D, block=(2 * C, 2 * C + 2)), full[..., 2 * C:])):
            torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def _model_pair(model_type, efc, parity):
    """The small config at N = 8, forced dense and forced factored; the same
    seed gives both the same weights."""
    dense, fact = (configs("small", decoder=dict(edge_from_coords=efc, adj_head_factored=f),
                           model_type=model_type, parity=parity)[1] for f in (False, True))
    assert fact.adj_factored_engaged and not dense.adj_factored_engaged
    return [build_model(c, device="cpu").double().train() for c in (dense, fact)]


def _loss_and_grads(model, batch, eps):
    out = model(batch, eps=eps)
    total, _ = elbo_loss(model.cfg, out, batch.adj, batch.features, batch.coords, 0.0)
    grads = torch.autograd.grad(total, list(model.parameters()))
    return out.decoded.adj_prob, grads


@pytest.mark.parametrize("model_type", ["disentangled", "base"])
@pytest.mark.parametrize("efc", [False, True])
@pytest.mark.parametrize("parity", [True, False])
def test_model_factored_head_equals_dense(model_type, efc, parity):
    """Same weights, same outputs and gradients in float64 (rtol 1e-10):
    only the lowering differs."""
    m_d, m_f = _model_pair(model_type, efc, parity)
    assert [n for n, _ in m_d.named_parameters()] == [n for n, _ in m_f.named_parameters()]
    m_f.load_state_dict(m_d.state_dict())
    batch = load_dataset(m_d.cfg, "train", num_graphs=2, device="cpu").to(dtype=torch.float64)
    g = torch.Generator().manual_seed(0)
    S, enc = (1 if model_type == "base" else batch.num_samples), m_d.cfg.encoder
    eps = Latents(z_sg=torch.randn(2, S, enc.sg_latent_size, generator=g, dtype=torch.float64),
                  z_s=torch.randn(2, enc.s_latent_size, generator=g, dtype=torch.float64),
                  z_g=torch.randn(2, enc.g_latent_size, generator=g, dtype=torch.float64))
    p_d, g_d = _loss_and_grads(m_d, batch, eps)
    p_f, g_f = _loss_and_grads(m_f, batch, eps)
    torch.testing.assert_close(p_f, p_d, rtol=1e-10, atol=1e-12)
    for (name, _), a, b in zip(m_d.named_parameters(), g_d, g_f):
        torch.testing.assert_close(b, a, rtol=1e-10, atol=1e-12, msg=name)


@pytest.mark.parametrize("model_type", ["disentangled", "base"])
def test_factored_model_matches_jax_f64(exact_f64, model_type):
    """The forced-factored model (edge_from_coords on) against the JAX
    package's forced-factored model: the served path in float64."""
    _, _, jm, p, tm, arrays = setup_models(
        "small", np.float64, decoder=dict(adj_head_factored=True), model_type=model_type)
    assert tm.cfg.adj_factored_engaged
    jo = jax.jit(lambda p, b: jm.apply({"params": p}, b, deterministic_z=True))(
        p, jax_batch(**arrays, dtype=np.float64))
    with torch.no_grad():
        to = tm(torch_batch(**arrays, dtype=torch.float64), deterministic_z=True)
    for f in ("adj_prob", "coords", "node_feat"):
        np.testing.assert_allclose(getattr(to.decoded, f).numpy(),
                                   np.asarray(getattr(jo.decoded, f)), rtol=1e-8, atol=1e-10)


def test_auto_engages_from_96_nodes(monkeypatch):
    """The auto rule: separable from num_nodes >= 96, and the model's head
    then calls the first E2E with factors only."""
    _, cfg = configs("small", decoder=dict(adj_head_factored=None, edge_from_coords=False))
    assert not cfg.adj_factored_engaged
    big = cfg.with_(num_nodes=96)
    assert big.adj_factored_engaged and not cfg.with_(num_nodes=95).adj_factored_engaged
    model = build_model(big.with_(sampling_num=1), device="cpu")
    calls = []
    sep = E2E._separable
    monkeypatch.setattr(E2E, "_separable", lambda self, *f: (calls.append(len(f)),
                                                             sep(self, *f))[1])
    with torch.no_grad():
        d = model.generate(torch.Generator().manual_seed(0), 1)
    assert calls == [3] and d.adj_prob.shape == (1, 96, 96, 2)
