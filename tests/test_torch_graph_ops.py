"""The port's remaining exported graph ops against the JAX package, in
float64 (rtol 1e-10) and f32 (rtol 1e-4 / atol 1e-5): ``GraphConvFull``,
``normalized_graph_conv`` (over D^-1/2 (A+I) D^-1/2), the inner-product
decoder and ``Graphite``.  No model calls them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from torch_parity import exact_f64, one_thread  # noqa: F401  (fixtures)

from snd_vae_tpu import nn as jops
from snd_vae_tpu_torch import nn as tops
from snd_vae_tpu_torch.params import state_dict_from_flax

pytestmark = pytest.mark.usefixtures("one_thread")
GEN = torch.Generator().manual_seed(0)
TOL = {np.float64: (1e-10, 1e-12), np.float32: (1e-4, 1e-5)}


@pytest.fixture(params=[np.float64, np.float32], ids=["f64", "f32"])
def np_dtype(request):
    if request.param == np.float64:
        request.getfixturevalue("exact_f64")
    return request.param


def _close(got, want, np_dtype):
    rtol, atol = TOL[np_dtype]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _carry(jm, tm, key, rng, np_dtype, *args):
    p = jm.init(key, *(jnp.asarray(a, jnp.float32) for a in args))["params"]
    p = {k: rng.standard_normal(v.shape).astype(np_dtype) for k, v in
         flatten_dict(p, sep="/").items()}
    tm = tm.to(torch.from_numpy(np.zeros(0, np_dtype)).dtype)
    tm.load_state_dict(state_dict_from_flax(p))
    return {k: jnp.asarray(v) for k, v in p.items()}, tm


def test_graph_conv_full(rng, key, np_dtype):
    adj = rng.random((2, 6, 6, 3)).astype(np_dtype)
    x = rng.standard_normal((2, 6, 4)).astype(np_dtype)
    p, tm = _carry(jops.GraphConvFull(5), tops.GraphConvFull(4, 5, GEN), key, rng, np_dtype,
                   adj, x)
    want = jops.GraphConvFull(5).apply({"params": p}, jnp.asarray(adj), jnp.asarray(x))
    got = tm(torch.from_numpy(adj), torch.from_numpy(x))
    assert got.shape == (2, 6, 15)
    _close(got, want, np_dtype)


def test_normalized_graph_conv(rng, np_dtype):
    a = (rng.random((2, 7, 7)) < 0.4).astype(np_dtype)
    a = np.maximum(a, np.swapaxes(a, 1, 2)) + np.eye(7, dtype=np_dtype)
    d = 1.0 / np.sqrt(a.sum(-1))
    a_norm = (d[:, :, None] * a * d[:, None, :]).astype(np_dtype)
    x = rng.standard_normal((2, 7, 3)).astype(np_dtype)
    w = rng.standard_normal((3, 4)).astype(np_dtype)
    want = jops.normalized_graph_conv(*map(jnp.asarray, (a_norm, x, w)))
    _close(tops.normalized_graph_conv(*map(torch.from_numpy, (a_norm, x, w))), want, np_dtype)


def test_inner_product_decoder(rng, np_dtype):
    z = rng.standard_normal((2, 6, 4)).astype(np_dtype)
    want = jops.inner_product_decoder(jnp.asarray(z))
    _close(tops.inner_product_decoder(torch.from_numpy(z)), want, np_dtype)


def test_graphite(rng, key, np_dtype):
    x = rng.standard_normal((2, 6, 4)).astype(np_dtype)
    r1 = rng.standard_normal((2, 6, 3)).astype(np_dtype)
    r2 = rng.standard_normal((2, 6, 3)).astype(np_dtype)
    p, tm = _carry(jops.Graphite(5), tops.Graphite(4, 5, GEN), key, rng, np_dtype, x, r1, r2)
    want = jops.Graphite(5).apply({"params": p}, *map(jnp.asarray, (x, r1, r2)))
    _close(tm(*map(torch.from_numpy, (x, r1, r2))), want, np_dtype)
