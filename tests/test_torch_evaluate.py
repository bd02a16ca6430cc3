"""The port's ``evaluate.py`` against ``snd_vae_tpu.evaluate`` on the same
numpy inputs (rtol / atol 1e-12; DCI within 1e-6), and its numpy versions
of sklearn's ranking metrics and Lasso against sklearn itself: AUC / AP at
1e-12 with tied and with all-equal scores, the Lasso's coefficients at
``tol=1e-10`` within 1e-8 and at sklearn's default tolerance, iterate for
iterate."""

import numpy as np
import pytest
from sklearn.linear_model import Lasso
from sklearn.metrics import average_precision_score, roc_auc_score

import snd_vae_tpu.evaluate as jev
import snd_vae_tpu_torch.evaluate as tev
from snd_vae_tpu.data import generate_synthetic

DCI = ("dci_disentanglement", "dci_completeness", "dci_informativeness")


def _same(got, want, dci_atol=1e-12):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        atol = dci_atol if k in DCI else 1e-12
        np.testing.assert_allclose(got[k], v, rtol=1e-12, atol=atol, err_msg=k)


def _saturated_scores(rng, shape):
    """Edge probabilities as a trained decoder gives them: many exactly 0
    or 1 (saturated) and ties among the rest (rounded to 2 decimals)."""
    s = np.round(rng.random(shape), 2)
    s[rng.random(shape) < 0.3] = 0.0
    s[rng.random(shape) < 0.1] = 1.0
    return s


def _recon_case(case, rng):
    data = generate_synthetic(6, num_nodes=8, seed=0)
    adj, node, geo = data["adj"], data["node"], data["geometry"]
    kw = {}
    if case == "scores_with_ties":
        scores = _saturated_scores(rng, adj.shape)
        gen = (scores > 0.5).astype(np.int64)
        kw["adj_scores"] = scores
    elif case == "hard_decode":
        gen = (rng.random(adj.shape) < 0.2).astype(np.int64)
    elif case == "directed":
        adj = (rng.random(adj.shape) < 0.3).astype(np.float64)
        gen = (rng.random(adj.shape) < 0.3).astype(np.int64)
        kw["adj_scores"] = rng.random(adj.shape)
    elif case == "scene_categorical":
        # K-way relation codes and class-index node decodes against one-hot truth
        adj = rng.integers(0, 5, adj.shape).astype(np.float64)
        gen = rng.integers(0, 5, adj.shape)
        kw["adj_scores"] = _saturated_scores(rng, adj.shape)
        node = np.eye(3)[rng.integers(0, 3, (6, 8))]
        gen_nodes = rng.integers(0, 3, (6, 8, 1)).astype(np.float64)
        kw["node_categorical"] = True
        return gen, gen_nodes, geo / 600 + 0.01, adj, node, geo / 600, kw
    elif case == "one_class":
        adj = np.zeros_like(adj)
        gen = (rng.random(adj.shape) < 0.2).astype(np.int64)
    gen_nodes = node + 0.1 * rng.standard_normal(node.shape)
    return gen, gen_nodes, geo / 600 + 0.01 * rng.standard_normal(geo.shape), adj, node, \
        geo / 600, kw


@pytest.mark.parametrize("case", ["scores_with_ties", "hard_decode", "directed",
                                  "scene_categorical", "one_class"])
def test_reconstruct_evaluation_matches_jax(case):
    gen, gen_nodes, gen_geo, adj, node, geo, kw = _recon_case(case, np.random.default_rng(3))
    want = jev.reconstruct_evaluation(gen, gen_nodes, gen_geo, adj, node, geo, "x", **kw)
    got = tev.reconstruct_evaluation(gen, gen_nodes, gen_geo, adj, node, geo, "x", **kw)
    _same(got, want)
    assert ("edge_auc" in got) == (case != "one_class")
    assert ("relation_acc" in got) == (case == "scene_categorical")


def test_edge_presence_scores_match_jax():
    logits = np.random.default_rng(0).standard_normal((3, 6, 6, 5)).astype(np.float32) * 30
    np.testing.assert_allclose(tev.edge_presence_scores(logits),
                               jev.edge_presence_scores(logits), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("case", ["unit_box", "raw_scale", "shifted", "directed_labels",
                                  "tree_samples"])
def test_generation_evaluation_matches_jax(case):
    rng = np.random.default_rng(1)
    a = generate_synthetic(5, num_nodes=8, seed=1)
    b = generate_synthetic(7, num_nodes=8, seed=2)
    gen_adj, ref_adj = a["adj"], b["adj"]
    scale, shift = {"raw_scale": (20.0, 0.0), "shifted": (1.0, 10.0)}.get(case, (1.0, 0.0))
    gen_geo = a["geometry"] / 600 * scale + shift
    ref_geo = b["geometry"] / 600 * scale + shift
    if case == "directed_labels":
        gen_adj = rng.integers(0, 5, gen_adj.shape) * (rng.random(gen_adj.shape) < 0.3)
    if case == "tree_samples":
        ref_adj = np.stack([ref_adj, ref_adj], axis=1)          # [G,S,N,N]
    args = (gen_adj, a["node"], gen_geo, ref_adj, b["node"], ref_geo, "x")
    _same(tev.generation_evaluation(*args), jev.generation_evaluation(*args))


@pytest.mark.parametrize("case", ["aligned", "constant_factor", "one_factor", "batched_sg"])
def test_disentangle_evaluation_matches_jax(case):
    """Every score at 1e-12 but DCI's, which comes from the Lasso (sklearn's
    in JAX, ours here), within 1e-6."""
    rng = np.random.default_rng(4)
    n = 120
    f = rng.standard_normal((n, 3))
    z_s = np.concatenate([f[:, :1] + 0.1 * rng.standard_normal((n, 1)),
                          rng.standard_normal((n, 5))], axis=1)
    z_g = np.concatenate([f[:, 1:2], rng.standard_normal((n, 5))], axis=1)
    z_sg = rng.standard_normal((n, 6)) + 0.5 * f[:, 2:3]
    if case == "constant_factor":
        f[:, 1] = 2.0
    elif case == "one_factor":
        f = f[:, 0]
    elif case == "batched_sg":
        z_sg = z_sg.reshape(n // 2, 2, 6)       # [G, S, L]: rows beyond the factors drop
    want = jev.disentangle_evaluation(z_s, z_g, z_sg, f, "x")
    got = tev.disentangle_evaluation(z_s, z_g, z_sg, f, "x")
    _same(got, want, dci_atol=1e-6)


@pytest.mark.parametrize("case", ["continuous", "ties", "all_equal", "saturated"])
def test_roc_auc_and_average_precision_match_sklearn(case):
    rng = np.random.default_rng(5)
    y = rng.random(2000) < 0.2
    s = {"continuous": rng.random(2000) + 0.3 * y,
         "ties": np.round(rng.random(2000) + 0.2 * y, 1),
         "all_equal": np.full(2000, 0.7),
         "saturated": _saturated_scores(rng, 2000)}[case]
    np.testing.assert_allclose(tev.roc_auc(y, s), roc_auc_score(y, s), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tev.average_precision(y, s), average_precision_score(y, s),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n,p", [(200, 300), (150, 20), (40, 60)])
def test_lasso_matches_sklearn(n, p):
    """Standardized inputs as DCI gives them, a few informative columns and
    a constant one: at tol 1e-10 both reach the optimum (1e-8); at sklearn's
    default 1e-4 ours stops where sklearn's does (1e-10)."""
    rng = np.random.default_rng(n + p)
    z = rng.standard_normal((n, p))
    z[:, :4] += rng.standard_normal((n, 1))
    z[:, -1] = 1.0
    y = z[:, 0] - 0.5 * z[:, 3] + 0.3 * z[:, 7] + 0.5 * rng.standard_normal(n)
    zs = (z - z.mean(0)) / (z.std(0) + 1e-12)
    ys = (y - y.mean()) / y.std()
    for tol, atol in ((1e-10, 1e-8), (1e-4, 1e-10)):
        want = Lasso(alpha=0.02, max_iter=5000, tol=tol).fit(zs, ys).coef_
        got = tev.lasso(zs, ys, alpha=0.02, max_iter=5000, tol=tol)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=f"tol {tol}")
    assert (got != 0).sum() < p
