"""The port's fourth-order spatial conv (``spatial_graph_conv_3d``,
``SpatialGraphConv3D``, the dense oracle and the row-blocked lowering) and
the third-order conv's ``block_rows`` against the JAX package in float64.

The fourth-order conv accumulates in its inputs' dtype in both packages
(JAX ``_acc_dtype``), so no ``exact_f64`` lift is needed there.  The graphs
carry a node of degree 0, as mnist's hull graphs do for interior points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from torch_parity import one_thread  # noqa: F401  (fixture)

from snd_vae_tpu import nn as jops
from snd_vae_tpu_torch import nn as tops
from snd_vae_tpu_torch.params import state_dict_from_flax

pytestmark = pytest.mark.usefixtures("one_thread")
HIDDEN = (4, 3, 3, 2)
TOL = dict(rtol=1e-9, atol=1e-12)


def _graph(rng, B, N, F, R):
    """A symmetric 0/1 adjacency whose node 0 has no edge, node features
    and symmetric positive relations, float64."""
    adj = np.triu((rng.random((B, N, N)) < 0.5).astype(np.float64), 1)
    adj = adj + np.swapaxes(adj, 1, 2)
    adj[:, 0, :] = adj[:, :, 0] = 0.0
    x = rng.standard_normal((B, N, F))
    rel = np.abs(rng.standard_normal((B, N, N, R)))
    return adj, x, (rel + np.swapaxes(rel, 1, 2)) / 2


def _params(rng, key, adj, x, rel, fully_connected=False, hidden=HIDDEN):
    """Seeded float64 values for the JAX module's parameters (names and
    shapes from its own init)."""
    jm = jops.SpatialGraphConv3D(hidden=hidden, fully_connected=fully_connected)
    p = jm.init(key, *(jnp.asarray(a, jnp.float32) for a in (adj, x, rel)))["params"]
    return {k: 0.5 * rng.standard_normal(v.shape) for k, v in p.items()}


def _rel_dis(adj, rel, fully_connected, cat):
    return (cat([rel, adj[..., None]], -1) if fully_connected else rel), rel


@pytest.mark.parametrize("fully_connected", [False, True])
def test_conv3d_matches_jax_and_oracles_f64(rng, key, fully_connected):
    """B = 1, N = 5: the port's functional conv and module against JAX's
    spatial_graph_conv_3d and SpatialGraphConv3D, and both packages' dense
    oracles (the reference formula), at rtol 1e-9 / atol 1e-12."""
    adj, x, rel = _graph(rng, 1, 5, 2, 1)
    p = _params(rng, key, adj, x, rel, fully_connected)
    with jax.enable_x64():
        ja = tuple(map(jnp.asarray, (adj, x, rel)))
        jrel, jdis = _rel_dis(ja[0], ja[2], fully_connected, jnp.concatenate)
        want = np.asarray(jax.jit(jops.spatial_graph_conv_3d, static_argnums=5)(
            ja[0], ja[1], jrel, jdis, p, fully_connected))
        oracle = np.asarray(jax.jit(jops.spatial_graph_conv_3d_dense_oracle, static_argnums=5)(
            ja[0], ja[1], jrel, jdis, p, fully_connected))
        jm = jops.SpatialGraphConv3D(HIDDEN, fully_connected=fully_connected)
        module = np.asarray(jax.jit(jm.apply)({"params": p}, *ja))
    ta = tuple(map(torch.from_numpy, (adj, x, rel)))
    trel, tdis = _rel_dis(ta[0], ta[2], fully_connected, torch.cat)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = tops.spatial_graph_conv_3d(ta[0], ta[1], trel, tdis, tp,
                                     fully_connected=fully_connected).numpy()
    np.testing.assert_allclose(want, oracle, **TOL)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)
    np.testing.assert_allclose(tops.spatial_graph_conv_3d_dense_oracle(
        ta[0], ta[1], trel, tdis, tp, fully_connected=fully_connected).numpy(), oracle, **TOL)
    mod = tops.SpatialGraphConv3D(2, 1, HIDDEN, torch.Generator().manual_seed(0),
                                  fully_connected=fully_connected).double()
    result = mod.load_state_dict(state_dict_from_flax(flatten_dict(p, sep="/")))
    assert not result.missing_keys and not result.unexpected_keys
    np.testing.assert_allclose(mod(*ta).detach().numpy(), module, **TOL)
    np.testing.assert_allclose(module, want, **TOL)


@pytest.mark.parametrize("block_rows", [2, 3, 6])
def test_conv3d_blocked_matches_oracle_f64(rng, key, block_rows):
    """The row-blocked lowering at N = 6 against the dense oracle."""
    adj, x, rel = _graph(rng, 2, 6, 1, 1)
    p = _params(rng, key, adj, x, rel)
    ta = tuple(map(torch.from_numpy, (adj, x, rel)))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    oracle = tops.spatial_graph_conv_3d_dense_oracle(ta[0], ta[1], ta[2], ta[2], tp).numpy()
    with jax.enable_x64():
        ja = tuple(map(jnp.asarray, (adj, x, rel)))
        want = np.asarray(jax.jit(lambda a, xx, r, pp: jops.spatial_graph_conv_3d(
            a, xx, r, r, pp, block_rows=block_rows))(*ja, p))
    got = tops.spatial_graph_conv_3d(ta[0], ta[1], ta[2], ta[2], tp, block_rows=block_rows)
    np.testing.assert_allclose(got.numpy(), oracle, **TOL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("block_rows", [None, 3])
def test_conv3d_grads_match_jax_vjp_f64(rng, key, block_rows):
    """Gradients for x, rel and every parameter, unblocked and blocked
    (checkpointed blocks), against jax.vjp of JAX's conv (its own blocked
    scan for block_rows 3) and, blocked, against the port's unblocked
    gradients; adj gets its gradient too."""
    adj, x, rel = _graph(rng, 2, 6, 2, 1)
    p = _params(rng, key, adj, x, rel)
    g = rng.standard_normal((2, 6, HIDDEN[-1]))
    names = sorted(p)

    def port(block):
        ta = [torch.from_numpy(a).requires_grad_(True) for a in (adj, x, rel)]
        tp = [torch.from_numpy(p[k]).requires_grad_(True) for k in names]
        out = tops.spatial_graph_conv_3d(ta[0], ta[1], ta[2], ta[2], dict(zip(names, tp)),
                                         block_rows=block)
        return [t.numpy() for t in torch.autograd.grad(out, ta + tp, torch.from_numpy(g))]

    with jax.enable_x64():
        f = lambda a, xx, r, pp: jops.spatial_graph_conv_3d(a, xx, r, r, pp,
                                                            block_rows=block_rows)
        want_a, want_x, want_r, want_p = jax.jit(lambda *a: jax.vjp(f, *a[:4])[1](a[4]))(
            *map(jnp.asarray, (adj, x, rel)), p, jnp.asarray(g))
    want = [want_a, want_x, want_r] + [want_p[k] for k in names]
    got = port(block_rows)
    for what, got_i, want_i in zip(["adj", "x", "rel"] + names, got, want):
        np.testing.assert_allclose(got_i, np.asarray(want_i), rtol=1e-9, atol=1e-11,
                                   err_msg=what)
    if block_rows is not None:
        for what, got_i, ref_i in zip(["adj", "x", "rel"] + names, got, port(None)):
            np.testing.assert_allclose(got_i, ref_i, rtol=1e-12, atol=1e-13, err_msg=what)


def test_conv3d_block_rows_must_divide(rng):
    adj, x, rel = map(torch.from_numpy, _graph(rng, 1, 6, 1, 1))
    mod = tops.SpatialGraphConv3D(1, 1, HIDDEN, torch.Generator().manual_seed(0),
                                  block_rows=4).double()
    with pytest.raises(ValueError, match="must divide"):
        mod(adj, x, rel)


def _third_order(rng, key, N=6):
    adj, x, rel = _graph(rng, 2, N, 2, 1)
    jm = jops.SpatialGraphConv(hidden=(5, 4, 3))
    p = jm.init(key, *(jnp.asarray(a, jnp.float32) for a in (adj, x, rel)))["params"]
    return adj, x, rel, {k: rng.standard_normal(v.shape) for k, v in p.items()}


@pytest.mark.parametrize("block_rows", [2, 3])
def test_third_order_block_rows_matches_jax_f64(rng, key, block_rows):
    """spatial_graph_conv with block_rows (one motif_level3 forward, the
    backward recomputed one i-row block at a time): the output and the
    gradients for adj, x, rel and every parameter against JAX's blocked
    lowering (_blocked_nt) and its jax.vjp at rtol 1e-9, and the blocked
    backward against the unblocked one at rtol 1e-12."""
    adj, x, rel, p = _third_order(rng, key)
    g = rng.standard_normal((2, 6, 3))
    names = sorted(p)
    with jax.enable_x64():
        f = lambda a, xx, r, pp: jops.spatial_graph_conv(a, xx, r, pp, block_rows=block_rows)
        want_out, (want_a, want_x, want_r, want_p) = jax.jit(
            lambda *a: (f(*a[:4]), jax.vjp(f, *a[:4])[1](a[4])))(
            *map(jnp.asarray, (adj, x, rel)), p, jnp.asarray(g))
    want = [want_a, want_x, want_r] + [want_p[k] for k in names]

    def port(block):
        ta = [torch.from_numpy(a).requires_grad_(True) for a in (adj, x, rel)]
        tp = [torch.from_numpy(p[k]).requires_grad_(True) for k in names]
        out = tops.spatial_graph_conv(*ta, dict(zip(names, tp)), block_rows=block)
        return out, torch.autograd.grad(out, ta + tp, torch.from_numpy(g))

    out, got = port(block_rows)
    _, ref = port(None)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **TOL)
    for what, got_i, want_i, ref_i in zip(["adj", "x", "rel"] + names, got, want, ref):
        np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=1e-9, atol=1e-11,
                                   err_msg=what)
        np.testing.assert_allclose(got_i.numpy(), ref_i.numpy(), rtol=1e-12, atol=1e-13,
                                   err_msg=what)


def test_third_order_blocked_backward_is_blockwise(rng, key, monkeypatch):
    """With block_rows the backward's plain recompute (the CPU's closed
    form of level 3's gradient) never sees more than block_rows rows of i:
    every pairwise tensor it makes is at most [B,2,N,·]."""
    from torch.overrides import TorchFunctionMode

    from snd_vae_tpu_torch.nn.kernels import motif_level3 as ml

    class Shapes(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor):
                self.seen.append(tuple(out.shape))
            return out

    mode, plain = Shapes(), ml.motif_level3_backward_plain

    def recorded(*args, **kwargs):
        with mode:
            return plain(*args, **kwargs)

    monkeypatch.setattr(ml, "motif_level3_backward_plain", recorded)
    adj, x, rel, p = _third_order(rng, key)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    ta = tuple(map(torch.from_numpy, (adj, x, rel)))
    tops.spatial_graph_conv(*ta, tp, block_rows=2).sum().backward()
    pairwise = [s for s in mode.seen if len(s) == 4 and s[-2] == 6]   # [B,rows,N,·]
    assert any(s[1] == 2 for s in pairwise) and all(s[1] <= 2 for s in pairwise), mode.seen
