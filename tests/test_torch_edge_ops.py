"""The port's edge / node conv family (``nn/edge_conv.py``: E2N, N2N,
N2GAdj, DeN2G, DeN2N, DeE2N, DeE2E, N2GPool, G2NBroadcast) against the JAX
modules in float64 to 1e-12, with seeded flax parameters (non-zero biases)
carried across by ``params.state_dict_from_flax``; and the port's own
initializers' shapes and layouts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from torch_parity import exact_f64, one_thread  # noqa: F401  (fixtures)

import snd_vae_tpu.nn as jnn
import snd_vae_tpu_torch.nn as tnn
from snd_vae_tpu_torch.params import state_dict_from_flax

pytestmark = pytest.mark.usefixtures("one_thread")
B = 2

# name: (JAX module, port module from a generator, input shape)
CASES = {
    "E2N_full": (lambda: jnn.E2N(4, k_h=6), lambda g: tnn.E2N(3, 4, 6, g), (B, 6, 6, 3)),
    "E2N_window": (lambda: jnn.E2N(4, k_h=3), lambda g: tnn.E2N(3, 4, 3, g), (B, 6, 6, 3)),
    "N2N": (lambda: jnn.N2N(4, k_h=2), lambda g: tnn.N2N(3, 4, 2, g), (B, 6, 5, 3)),
    "N2GAdj": (lambda: jnn.N2GAdj(3), lambda g: tnn.N2GAdj(6, 3, g), (B, 6, 4, 1)),
    "DeN2G": (lambda: jnn.DeN2G((6, 4), k_h=6, features=3),
              lambda g: tnn.DeN2G(6, g, features=3), (B, 1, 4, 1)),
    "DeN2N": (lambda: jnn.DeN2N(4, k_h=3), lambda g: tnn.DeN2N(5, 4, 3, g), (B, 6, 3, 5)),
    "DeE2N": (lambda: jnn.DeE2N(4, k_h=6), lambda g: tnn.DeE2N(5, 4, 6, g), (B, 6, 1, 5)),
    "DeE2E": (lambda: jnn.DeE2E(4, k_h=6), lambda g: tnn.DeE2E(5, 4, 6, g), (B, 6, 6, 5)),
    "N2GPool": (lambda: jnn.N2GPool(6, hidden=4), lambda g: tnn.N2GPool(6, g, hidden=4),
                (B, 4, 5)),
    "G2NBroadcast": (lambda: jnn.G2NBroadcast(6, hidden=4),
                     lambda g: tnn.G2NBroadcast(6, g, hidden=4), (B, 6, 5)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_edge_op_matches_jax_f64(name, exact_f64):
    make_jax, make_port, shape = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    x = rng.standard_normal(shape)
    jm = make_jax()
    with jax.enable_x64(False):   # the f32 init the JAX package runs, traced only
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                jnp.asarray(x, jnp.float32)))["params"]
    flat = {k: 0.3 * rng.standard_normal(v.shape) for k, v in flatten_dict(shapes, sep="/").items()}
    params = jax.tree.map(jnp.asarray, {"params": unflatten_dict(flat, sep="/")})
    want = jm.apply(params, jnp.asarray(x))

    port = make_port(torch.Generator().manual_seed(0)).to(torch.float64)
    held = dict(port.state_dict())
    result = port.load_state_dict(state_dict_from_flax(flat))
    assert not result.missing_keys and not result.unexpected_keys
    # the port's own initializers draw what the flax layout maps to
    assert {k: v.shape for k, v in held.items()} == {
        k: v.shape for k, v in state_dict_from_flax(flat).items()}
    got = port(torch.from_numpy(x))
    if isinstance(want, tuple):            # N2GAdj returns (out, w) with w as flax holds it
        np.testing.assert_array_equal(got[1].detach().numpy(), flat["w"])
        got, want = got[0], want[0]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_edge_ops_in_bf16_keep_the_dtype():
    """bf16 in, bf16 out; the pooling pair accumulates in f32."""
    g = torch.Generator().manual_seed(0)
    for name, (_, make_port, shape) in CASES.items():
        port = make_port(g).to(torch.bfloat16)
        out = port(torch.randn(shape, generator=g).to(torch.bfloat16))
        out = out[0] if isinstance(out, tuple) else out
        assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all(), name
