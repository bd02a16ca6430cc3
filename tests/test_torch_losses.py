"""The port's ELBO family (``snd_vae_tpu_torch.losses``) against the JAX
package's (``snd_vae_tpu.losses``) on the same seeded numpy arrays, in
float64 at rtol 1e-10: each loss function, ``elbo_loss`` for every
``model_type`` branch, weighted BCE and scene's categorical CE; a bf16
ModelOutput gives an f32 loss; and the checks of ``tests/test_losses.py``
repeated on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import exact_f64, one_thread  # noqa: F401  (fixtures)

from snd_vae_tpu import config as jcfg
from snd_vae_tpu import losses as jl
from snd_vae_tpu.models import outputs as jout
from snd_vae_tpu_torch import config as tcfg
from snd_vae_tpu_torch import losses as tl
from snd_vae_tpu_torch.models import outputs as tout

pytestmark = pytest.mark.usefixtures("one_thread")
RTOL = 1e-10


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), rtol=rtol, atol=0)


def _arrays(rng):
    r = lambda *s: rng.standard_normal(s)
    return {
        "logits": r(2, 5, 5, 2), "adj": (rng.random((2, 5, 5)) < 0.4).astype(np.float64),
        "pred": r(3, 4), "target": r(3, 4), "mean": r(6, 3), "logstd": 0.3 * r(6, 3),
        "z": r(6, 3), "sigma": np.exp(0.3 * r(4)), "mu1": r(4), "sigma1": np.exp(0.3 * r(4)),
        "mu": r(4), "groups": [r(5, d) for d in (2, 2, 2, 3, 3, 3, 4, 4, 4)],
        "k_logits": r(2, 5, 5, 5), "k_adj": rng.integers(0, 5, (2, 5, 5)).astype(np.float64),
    }


# name -> (args from the arrays, extra non-array args)
FUNCTIONS = {
    "edge_cross_entropy": lambda a: ((a["logits"], a["adj"]), ()),
    "edge_categorical_cross_entropy": lambda a: ((a["k_logits"], a["k_adj"]), (5,)),
    "edge_weighted_bce": lambda a: ((a["logits"], a["adj"]), (3.0, 0.7)),
    "mse": lambda a: ((a["pred"], a["target"]), ()),
    "kl_diag_gaussian": lambda a: ((a["mean"], a["logstd"]), ()),
    "capacity_schedule": lambda a: ((np.array([0.0, 19.0, 20.0, 45.0, 1e4]),), (100.0, 100.0, 20.0)),
    "kl_between_gaussians": lambda a: ((a["mu"], a["sigma"], a["mu1"], a["sigma1"]), ()),
    "dip_regularizer": lambda a: ((a["mean"],), (10.0, 100.0)),
    "gaussian_log_density": lambda a: ((a["z"], a["mean"], a["logstd"]), ()),
    "total_correlation": lambda a: ((a["z"], a["mean"], a["logstd"]), ()),
    "hierarchical_total_correlation": lambda a: (tuple(a["groups"]), ()),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_loss_function_matches_jax(name, rng):
    arrays, extra = FUNCTIONS[name](_arrays(rng))
    with jax.enable_x64():
        want = getattr(jl, name)(*(jnp.asarray(x) for x in arrays), *extra)
    got = getattr(tl, name)(*(torch.from_numpy(x) for x in arrays), *extra)
    assert got.dtype == torch.float64
    _close(got, want)


def _outputs(cfg, rng, B=3, S=2, N=6, L=4, scene=False):
    """The same random ModelOutput and truth in both packages (float64)."""
    r = lambda *s: rng.standard_normal(s)
    K = cfg.decoder.num_edge_feature if scene else 2
    F = cfg.num_features
    stats = dict(mean_sg=r(B, S, L), logstd_sg=0.3 * r(B, S, L))
    lat = dict(z_sg=r(B, S, L))
    if cfg.model_type != "base":
        stats.update(mean_s=r(B, L), logstd_s=0.3 * r(B, L), mean_g=r(B, L),
                     logstd_g=0.3 * r(B, L))
        lat.update(z_s=r(B, L), z_g=r(B, L))
    logits = r(B, N, N, K)
    dec = dict(adj=np.argmax(logits, -1).astype(np.float64), adj_prob=logits,
               coords=rng.random((B, N, cfg.spatial_dim)), node_feat=rng.random((B, N, F)))
    if scene:
        dec["node_feat_prob"] = r(B, N, F)
        adj_true = rng.integers(0, K, (B, N, N)).astype(np.float64)
        node_true = np.eye(F)[rng.integers(0, F, (B, N))]
    else:
        adj_true = (rng.random((B, N, N)) < 0.3).astype(np.float64)
        node_true = rng.random((B, N, F))
    truth = (adj_true, node_true, rng.random((B, N, cfg.spatial_dim)))
    mask = np.ones((B, N))
    mask[0, -2:] = 0.0

    def build(mod, conv):
        return mod.ModelOutput(
            stats=mod.LatentStats(**{k: conv(v) for k, v in stats.items()}),
            latents=mod.Latents(**{k: conv(v) for k, v in lat.items()}),
            decoded=mod.DecodedGraph(**{k: conv(v) for k, v in dec.items()}))
    return build(jout, jnp.asarray), build(tout, torch.from_numpy), truth, mask


ELBO_CASES = {
    "disentangled": dict(),
    "geoGCN": dict(model_type="geoGCN"),
    "disentangled_C-iter0": dict(model_type="disentangled_C", global_iter=0.0),
    "disentangled_C-iter1": dict(model_type="disentangled_C", global_iter=1.0),
    "disentangled_C-iter-large": dict(model_type="disentangled_C", global_iter=1e4),
    "NED-VAE-IP": dict(model_type="NED-VAE-IP"),
    "beta-TCVAE": dict(model_type="beta-TCVAE"),
    "base": dict(model_type="base"),
    "weighted-bce-given": dict(bce=True, pos_weight=3.0, norm=0.7),
    "weighted-bce-derived-masked": dict(bce=True, mask=True),
    "weighted-bce-derived": dict(bce=True),
    "scene": dict(scene=True),
    "scene-node-loss": dict(scene=True, scene_node_loss=True),
}


def _elbo_configs(case):
    kw = dict(ELBO_CASES[case])
    over = {}
    if "model_type" in kw:
        over["model_type"] = kw.pop("model_type")
    pair = []
    for mod in (jcfg, tcfg):
        cfg = (mod.scene_preset(**over) if kw.get("scene") else
               mod.synthetic2_preset(**over))
        loss = dict(beta=1.5, use_weighted_bce=kw.get("bce", False),
                    scene_node_loss=kw.get("scene_node_loss", False))
        pair.append(cfg.with_(loss=mod.LossConfig(**loss)))
    return pair, kw


@pytest.mark.parametrize("case", list(ELBO_CASES))
def test_elbo_matches_jax(case, rng, exact_f64):
    (jc, tc), kw = _elbo_configs(case)
    jo, to, truth, mask = _outputs(jc, rng, scene=kw.get("scene", False))
    call = dict(global_iter=kw.get("global_iter", 0.0), pos_weight=kw.get("pos_weight"),
                norm=kw.get("norm"))
    jm = jnp.asarray(mask) if kw.get("mask") else None
    tm = torch.from_numpy(mask) if kw.get("mask") else None
    j_total, j_aux = jl.elbo_loss(jc, jo, *(jnp.asarray(t) for t in truth), node_mask=jm, **call)
    t_total, t_aux = tl.elbo_loss(tc, to, *(torch.from_numpy(t) for t in truth), node_mask=tm,
                                  **call)
    assert sorted(t_aux) == sorted(j_aux)
    assert t_total.dtype == torch.float64
    _close(t_total, j_total)
    for k in j_aux:
        _close(t_aux[k], j_aux[k])


def test_bf16_output_gives_f32_loss(rng):
    """The ELBO runs in f32 on a bf16 ModelOutput, and equals the ELBO of
    that output cast to f32 first."""
    (_, tc), _ = _elbo_configs("beta-TCVAE")
    _, to, truth, _ = _outputs(tc, rng)
    bf = _cast(to, torch.bfloat16)
    truth_bf = [torch.from_numpy(t).to(torch.bfloat16) for t in truth]
    total, aux = tl.elbo_loss(tc, bf, *truth_bf)
    want, _ = tl.elbo_loss(tc, _cast(bf, torch.float32), *(t.float() for t in truth_bf))
    assert total.dtype == torch.float32 and all(v.dtype == torch.float32 for v in aux.values())
    assert torch.equal(total, want)


def _cast(x, dtype):
    from dataclasses import fields, is_dataclass, replace

    if is_dataclass(x):
        return replace(x, **{f.name: _cast(getattr(x, f.name), dtype) for f in fields(x)})
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(dtype)
    return x


# --------------------------------------------------------------------------
# The checks of tests/test_losses.py, on the port
# --------------------------------------------------------------------------

def _kl_matches_closed_form(rng):
    mean = rng.standard_normal((4, 6)).astype(np.float32)
    logstd = rng.standard_normal((4, 6)).astype(np.float32) * 0.3
    got = tl.kl_diag_gaussian(torch.from_numpy(mean), torch.from_numpy(logstd)).item()
    want = -0.5 * np.mean(1 + 2 * logstd - mean**2 - np.exp(logstd) ** 2)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _kl_zero_at_standard_normal(rng):
    assert abs(tl.kl_diag_gaussian(torch.zeros(3, 5), torch.zeros(3, 5)).item()) < 1e-6


def _capacity_schedule(rng):
    c = lambda it: tl.capacity_schedule(torch.tensor(it), 100.0, 100.0, 20.0).item()
    assert c(0.0) == 0.0 and c(25.0) == 20.0 and c(1000.0) == 100.0


def _edge_cross_entropy_matches_manual(rng):
    logits = rng.standard_normal((2, 4, 4, 2)).astype(np.float32)
    adj = (rng.random((2, 4, 4)) < 0.5).astype(np.float32)
    got = tl.edge_cross_entropy(torch.from_numpy(logits), torch.from_numpy(adj)).item()
    e = np.exp(logits - logits.max(-1, keepdims=True))
    p = e / e.sum(-1, keepdims=True)
    want = -np.mean(np.sum(np.stack([1 - adj, adj], -1) * np.log(p), -1))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _dip_regularizer_identity_cov(rng):
    z = rng.standard_normal((1000, 4))
    z = (z - z.mean(0)) / z.std(0)
    zw = z @ np.linalg.inv(np.linalg.cholesky(np.cov(z.T, bias=True))).T
    assert tl.dip_regularizer(torch.from_numpy(zw), 10.0, 100.0).item() < 1e-6


def _total_correlation_matches_numpy(rng):
    z = rng.standard_normal((6, 3))
    mean = rng.standard_normal((6, 3)) * 0.1
    logstd = rng.standard_normal((6, 3)) * 0.1
    got = tl.total_correlation(*(torch.from_numpy(x) for x in (z, mean, logstd))).item()
    logvar = 2 * logstd
    diff = z[:, None, :] - mean[None, :, :]
    log_prob = -0.5 * (diff**2 * np.exp(-logvar[None]) + logvar[None] + np.log(2 * np.pi))

    def lse(a, axis):
        m = a.max(axis=axis, keepdims=True)
        return np.squeeze(m, axis) + np.log(np.exp(a - m).sum(axis=axis))

    want = np.mean(lse(log_prob.sum(2), 1) - lse(log_prob, 1).sum(1))
    np.testing.assert_allclose(got, want, rtol=1e-8)


def _weighted_bce_matches_tf_formula(rng):
    logits2 = rng.standard_normal((2, 3, 3, 2))
    adj = (rng.random((2, 3, 3)) < 0.4).astype(np.float64)
    got = tl.edge_weighted_bce(torch.from_numpy(logits2), torch.from_numpy(adj), 3.0, 0.7).item()
    lg = logits2[..., 1] - logits2[..., 0]
    want = 0.7 * np.mean((1 - adj) * lg + (1 + 2.0 * adj) * np.log1p(np.exp(-lg)))
    np.testing.assert_allclose(got, want, rtol=1e-9)


def _weighted_bce_auto_stats(rng):
    cfg = tcfg.synthetic2_preset()
    cfg = cfg.with_(loss=tcfg.LossConfig(use_weighted_bce=True))
    B, N = 2, 4
    logits2 = torch.from_numpy(rng.standard_normal((B, N, N, 2)).astype(np.float32))
    adj = torch.from_numpy((rng.random((B, N, N)) < 0.4).astype(np.float32))
    node = torch.from_numpy(rng.random((B, N, 1)).astype(np.float32))
    coords = torch.from_numpy(rng.random((B, N, 2)).astype(np.float32))
    d = tout.DecodedGraph(adj=logits2.argmax(-1), adj_prob=logits2, node_feat=node,
                          coords=coords)
    rec = tl.reconstruction_losses(cfg, tout.ModelOutput(stats=None, latents=None, decoded=d),
                                   adj, node, coords)
    n_pos = adj.sum().item()
    pw = (adj.numel() - n_pos) / n_pos
    nm = adj.numel() / (2 * (adj.numel() - n_pos))
    want = tl.edge_weighted_bce(logits2, adj, pw, nm).item()
    np.testing.assert_allclose(rec["adj_loss"].item(), want, rtol=1e-6)


def _hierarchical_tc_runs(rng):
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    out = tl.hierarchical_total_correlation(f(5, 2), f(5, 2), f(5, 2), f(5, 3), f(5, 3),
                                            f(5, 3), f(5, 4), f(5, 4), f(5, 4))
    assert np.isfinite(out.item())


def _kl_between_gaussians_zero_same(rng):
    t = torch.tensor
    assert abs(tl.kl_between_gaussians(t(1.0), t(2.0), t(1.0), t(2.0)).item()) < 1e-7


GOLDEN = [_kl_matches_closed_form, _kl_zero_at_standard_normal, _capacity_schedule,
          _edge_cross_entropy_matches_manual, _dip_regularizer_identity_cov,
          _total_correlation_matches_numpy, _weighted_bce_matches_tf_formula,
          _weighted_bce_auto_stats, _hierarchical_tc_runs, _kl_between_gaussians_zero_same]


@pytest.mark.parametrize("check", GOLDEN, ids=[f.__name__.strip("_") for f in GOLDEN])
def test_golden_checks_on_the_port(check, rng):
    check(rng)
