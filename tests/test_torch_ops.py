"""The port's NN ops against the JAX package's, in float64, with the flax
parameters carried across by ``params.state_dict_from_flax``.

JAX's ``Dense`` and ``GraphConv`` ask for ``preferred_element_type=float32``
even on float64 operands, which rounds their products to f32.  The
``exact_f64`` fixture lifts that request to float64 for float64 operands
(accumulating in at least f32 is what the code asks for), so the comparison
is free of that rounding; the JAX package itself is unchanged."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from snd_vae_tpu import nn as jops
from snd_vae_tpu_torch import nn as tops
from snd_vae_tpu_torch.params import state_dict_from_flax

GEN = torch.Generator().manual_seed(0)


@pytest.fixture
def exact_f64(monkeypatch):
    dot, einsum = jnp.dot, jnp.einsum

    def lift(kw, operands):
        if kw.get("preferred_element_type") == jnp.float32 and any(
            getattr(o, "dtype", None) == jnp.float64 for o in operands
        ):
            kw = dict(kw, preferred_element_type=jnp.float64)
        return kw

    monkeypatch.setattr(jnp, "dot", lambda a, b, **kw: dot(a, b, **lift(kw, (a, b))))
    monkeypatch.setattr(
        jnp, "einsum", lambda s, *ops, **kw: einsum(s, *ops, **lift(kw, ops))
    )
    with jax.enable_x64():
        yield


def _f64(tree):
    return jax.tree.map(lambda t: np.asarray(t, np.float64), tree)


def _carry(torch_mod, flax_params):
    """Load float64 copies of the flax params into the torch module."""
    torch_mod.double()
    torch_mod.load_state_dict(state_dict_from_flax(flatten_dict(_f64(flax_params), sep="/")))
    return torch_mod


def _jax_params(mod, key, *args):
    return mod.init(key, *map(jnp.asarray, args))["params"]


def _randomize(params, rng):
    return jax.tree.map(lambda t: rng.standard_normal(t.shape), params)


def test_lrelu(rng):
    x = rng.standard_normal(50)
    with jax.enable_x64():
        want = np.asarray(jops.lrelu(jnp.asarray(x)))
    np.testing.assert_array_equal(tops.lrelu(torch.from_numpy(x)).numpy(), want)


def test_dense(rng, key, exact_f64):
    x = rng.standard_normal((2, 3, 7))
    p = _randomize(_jax_params(jops.Dense(5), key, x.astype(np.float32)), rng)
    want = jops.Dense(5).apply({"params": p}, jnp.asarray(x))
    got = _carry(tops.Dense(7, 5, GEN), p)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("k,stride,length", [(5, 1, 10), (4, 1, 10), (3, 2, 7), (4, 2, 10)])
def test_conv1d_same(rng, key, k, stride, length):
    """Odd and even kernels; stride 2 needs the explicit SAME padding."""
    x = rng.standard_normal((2, 3, length, 4))
    jm = jops.Conv1D(6, kernel_size=k, stride=stride)
    p = _randomize(_jax_params(jm, key, x.astype(np.float32)), rng)
    with jax.enable_x64():
        want = jm.apply({"params": p}, jnp.asarray(x))
    got = _carry(tops.Conv1D(4, 6, k, GEN, stride=stride), p)(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("block", [None, (2, 5)])
def test_frozen_batch_norm(rng, key, block):
    width = 3 if block else 6
    x = rng.standard_normal((4, 5, width))
    jm = jops.FrozenBatchNorm(features=6)
    p = _randomize(_jax_params(jm, key, np.zeros((1, 6), np.float32)), rng)
    with jax.enable_x64():
        want = jm.apply({"params": p}, jnp.asarray(x), block=block)
    got = _carry(tops.FrozenBatchNorm(6), p)(torch.from_numpy(x), block=block)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_batch_stat_norm(rng, key):
    x = rng.standard_normal((6, 5, 4)) * 3 + 1
    jm = jops.BatchStatNorm(features=4)
    p = _randomize(_jax_params(jm, key, np.zeros((1, 4), np.float32)), rng)
    with jax.enable_x64():
        want = jm.apply({"params": p}, jnp.asarray(x))
    got = _carry(tops.BatchStatNorm(4), p)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


def test_block_width_mismatch_raises():
    with pytest.raises(ValueError):
        tops.FrozenBatchNorm(6)(torch.zeros(2, 4), block=(0, 3))


def test_graph_conv(rng, key, exact_f64):
    adj = (rng.random((2, 5, 5)) < 0.5).astype(np.float64)
    x = rng.standard_normal((2, 5, 3))
    p = _randomize(_jax_params(jops.GraphConv(4), key, adj.astype(np.float32),
                               x.astype(np.float32)), rng)
    want = jops.GraphConv(4).apply({"params": p}, jnp.asarray(adj), jnp.asarray(x))
    got = _carry(tops.GraphConv(3, 4, GEN), p)(torch.from_numpy(adj), torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_graph_conv_grad(rng, key, exact_f64):
    """Gradients reach GraphConv's kernel and input through K3's autograd
    wrapper and equal jax.vjp of the JAX layer, in float64."""
    adj = (rng.random((2, 5, 5)) < 0.5).astype(np.float64)
    x = rng.standard_normal((2, 5, 3))
    g = rng.standard_normal((2, 5, 4))
    p = _randomize(_jax_params(jops.GraphConv(4), key, adj.astype(np.float32),
                               x.astype(np.float32)), rng)
    _, vjp = jax.vjp(lambda p, x: jops.GraphConv(4).apply({"params": p}, jnp.asarray(adj), x),
                     p, jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(g))
    mod = _carry(tops.GraphConv(3, 4, GEN), p)
    xt = torch.from_numpy(x).requires_grad_(True)
    gk, gx = torch.autograd.grad(mod(torch.from_numpy(adj), xt), [mod.kernel, xt],
                                 torch.from_numpy(g))
    np.testing.assert_allclose(gk.numpy(), np.asarray(want_p["kernel"]), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_x), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("use_matmul", [False, True])
@pytest.mark.parametrize("n", [5, 8])
def test_e2e_lowerings(rng, key, n, use_matmul):
    """Both lowerings at an odd and an even width (SAME pad_left = (k-1)//2
    differs by parity) against the JAX conv lowering."""
    x = rng.standard_normal((2, n, n, 3))
    jm = jops.E2E(4, k_h=n, use_matmul=False)
    p = _randomize(_jax_params(jm, key, x.astype(np.float32)), rng)
    with jax.enable_x64():
        want = jm.apply({"params": p}, jnp.asarray(x))
    tm = _carry(tops.E2E(3, 4, n, GEN, use_matmul=use_matmul), p)
    assert tm.uses_matmul(torch.from_numpy(x)) == use_matmul
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               rtol=1e-10, atol=1e-12)


def test_e2e_auto_rule():
    """The JAX auto rule: matmul from matmul_threshold on, unless the
    Toeplitz tensor would exceed matmul_max_bytes."""
    x = torch.zeros(1, 6, 6, 2)
    assert tops.E2E(2, 3, 6, GEN, matmul_threshold=4).uses_matmul(x)
    assert not tops.E2E(2, 3, 6, GEN, matmul_threshold=4, matmul_max_bytes=1).uses_matmul(x)
    assert not tops.E2E(2, 3, 6, GEN, matmul_threshold=100).uses_matmul(x)
    assert not tops.E2E(80, 50, 25, GEN).uses_matmul(torch.zeros(1, 25, 25, 80))


def _random_graph(rng, B, N, F, R, weighted=False):
    adj = np.triu((rng.random((B, N, N)) < 0.4).astype(np.float64), 1)
    adj = adj + np.swapaxes(adj, 1, 2)
    if weighted:
        adj = adj * rng.random((B, N, N))
        adj = (adj + np.swapaxes(adj, 1, 2)) / 2
    x = rng.standard_normal((B, N, F))
    rel = np.abs(rng.standard_normal((B, N, N, R)))
    return adj, x, (rel + np.swapaxes(rel, 1, 2)) / 2


@pytest.mark.parametrize("F,R,weighted", [(1, 1, False), (3, 1, False), (2, 2, False),
                                          (2, 1, True)])
def test_spatial_graph_conv(rng, key, F, R, weighted):
    """The port (level 3 through the motif_level3 kernel's plain version)
    against the JAX default rank-R path and the dense oracle, rtol 1e-9."""
    adj, x, rel = _random_graph(rng, 2, 7, F, R, weighted)
    jm = jops.SpatialGraphConv(hidden=(5, 4, 3))
    p = _f64(_jax_params(jm, key, adj.astype(np.float32), x.astype(np.float32),
                         rel.astype(np.float32)))
    with jax.enable_x64():
        jargs = tuple(map(jnp.asarray, (adj, x, rel)))
        want_default = np.asarray(jops.spatial_graph_conv(*jargs, p))
        want_oracle = np.asarray(jops.spatial_graph_conv_dense_oracle(*jargs, p))
    targs = tuple(map(torch.from_numpy, (adj, x, rel)))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = tops.spatial_graph_conv(*targs, tp).numpy()
    np.testing.assert_allclose(got, want_default, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got, want_oracle, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tops.spatial_graph_conv_dense_oracle(*targs, tp).numpy(),
                               want_oracle, rtol=1e-9, atol=1e-12)
    mod = _carry(tops.SpatialGraphConv(F, R, (5, 4, 3), GEN), p)
    np.testing.assert_allclose(mod(*targs).detach().numpy(), want_default,
                               rtol=1e-9, atol=1e-12)


def test_spatial_graph_conv_blocked_not_ported(rng):
    """block_rows is ported (tests/test_torch_conv3d.py holds it against
    JAX); one that does not divide N raises ValueError, as JAX's does."""
    adj, x, rel = map(torch.from_numpy, _random_graph(rng, 1, 7, 1, 1))
    with pytest.raises(ValueError, match="must divide"):
        tops.SpatialGraphConv(1, 1, (2, 2, 2), GEN, block_rows=5).double()(adj, x, rel)
