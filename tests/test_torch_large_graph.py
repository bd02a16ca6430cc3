"""The port's node-sharded large-graph path (``parallel/large_graph.py``)
against JAX's ``shard_map`` on ``make_mesh(1, d)`` of the virtual CPU
mesh, at world sizes 1, 2 and 4 (gloo ranks in
``tests/torch_dist_workers.py``) and in float64 to 1e-12: the normalized
adjacency, the degrees, one layer (the library path and K3's plain
version) and the encoder's pooled vector, with JAX's parameters carried
across, at ``test_large_graph.py``'s shapes and the uneven n = 50; the
gradient of the library path at d = 1 against ``jax.grad``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import exact_f64, one_thread  # noqa: F401  (fixtures)
from torch_dist_workers import run_many

from snd_vae_tpu.parallel import make_mesh
from snd_vae_tpu.parallel.large_graph import (
    ShardedGCNEncoder, shard_graph, sharded_degree, sharded_gcn_normalize,
    sharded_graph_conv,
)

pytestmark = pytest.mark.usefixtures("one_thread")
# (n, F, hidden): test_large_graph.py's conv (64, 5 -> 7), its uneven n = 50
# (3 -> 4) and its encoder (128, 4 -> (8, 8))
CASES = [(64, 5, (7,)), (50, 3, (4, 4)), (128, 4, (8, 8))]
TOL = dict(rtol=1e-12, atol=1e-12)


def _cases():
    rng = np.random.default_rng(0)
    out = []
    for n, f, hidden in CASES:
        adj = np.triu((rng.random((n, n)) < 0.1).astype(np.float64), 1)
        fans = (f,) + hidden[:-1]
        out.append({"adj": adj + adj.T, "x": rng.standard_normal((n, f)),
                    "kernels": [0.3 * rng.standard_normal((a, b)) for a, b in zip(fans, hidden)]})
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = _cases()
    worlds = (1, 2, 4)
    outs = run_many([("large_graph", d, tmp_path_factory.mktemp(f"lg{d}"), cases)
                     for d in worlds])
    return cases, dict(zip(worlds, outs))


def _rows(outs, key, case):
    return np.concatenate([o[case][key].numpy() for o in outs])


def _jax(case, d):
    mesh = make_mesh(1, d)
    a_s, x_s = shard_graph(case["adj"], case["x"], mesh)
    hidden = [k.shape[1] for k in case["kernels"]]

    @jax.jit
    def ops(a_s, x_s, params):
        norm = sharded_gcn_normalize(a_s, mesh)
        return {"adj_blk": a_s, "norm": norm, "degree": sharded_degree(a_s, mesh),
                "conv": sharded_graph_conv(norm, x_s, params[0], mesh),
                "pooled": ShardedGCNEncoder(mesh, hidden).apply(params, norm, x_s)}

    return ops(a_s, x_s, [jnp.asarray(k) for k in case["kernels"]])


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_sharded_ops_match_shard_map(ranks, exact_f64, d, case):
    """Every rank's rows, stacked, equal JAX's global arrays; the kernel
    path (K3's plain version on the CPU) equals the library path; every
    rank holds the same pooled vector."""
    cases, outs = ranks
    want = {k: np.asarray(v) for k, v in _jax(cases[case], d).items()}
    n = cases[case]["adj"].shape[0]
    assert want["adj_blk"].shape[0] == n + (-n) % d
    for key in ("adj_blk", "norm", "degree", "conv"):
        np.testing.assert_allclose(_rows(outs[d], key, case), want[key], **TOL, err_msg=key)
    np.testing.assert_allclose(_rows(outs[d], "conv_kernel", case), want["conv"], **TOL)
    for o in outs[d]:
        np.testing.assert_allclose(o[case]["pooled"].numpy(), want["pooled"], **TOL)
        np.testing.assert_allclose(o[case]["pooled_kernel"].numpy(), want["pooled"], **TOL)


def test_encoder_gradient_matches_jax_grad(ranks, exact_f64):
    """d = 1: the gradient of the pooled vector's sum for each kernel
    (library path) against ``jax.grad`` of the JAX encoder."""
    cases, outs = ranks
    mesh = make_mesh(1, 1)
    for i, case in enumerate(cases):
        a_s, x_s = shard_graph(case["adj"], case["x"], mesh)
        norm = sharded_gcn_normalize(a_s, mesh)
        enc = ShardedGCNEncoder(mesh, [k.shape[1] for k in case["kernels"]])
        grads = jax.jit(jax.grad(lambda p: enc.apply(p, norm, x_s).sum()))(
            [jnp.asarray(k) for k in case["kernels"]])
        got = outs[1][0][i]["grads"]
        assert len(got) == len(grads)
        for g, want in zip(got, grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-11, atol=1e-13)


def test_uneven_mean_counts_the_padding(ranks):
    """n = 50 over 4 ranks pads to 52 rows: the pooled vector is the sum
    over the nodes divided by 52, as JAX divides by the padded size."""
    cases, outs = ranks
    case = cases[1]
    h = torch.from_numpy(case["x"])
    adj = torch.from_numpy(case["adj"]) + torch.eye(50, dtype=torch.float64)
    inv = adj.sum(-1).rsqrt()
    norm = adj * inv[:, None] * inv[None, :]
    for k in case["kernels"]:
        h = norm @ (h @ torch.from_numpy(k))
        h = torch.maximum(h, 0.2 * h)
    torch.testing.assert_close(outs[4][0][1]["pooled"], h.sum(0) / 52, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(outs[1][0][1]["pooled"], h.sum(0) / 50, rtol=1e-12, atol=1e-12)
