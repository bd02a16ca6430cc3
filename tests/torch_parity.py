"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
the same Config in both packages, seeded flax parameters, and the
``exact_f64`` and ``one_thread`` fixtures.

``exact_f64`` enables float64 in JAX and lifts the two places where the JAX
package rounds float64 operands to f32: its Dense and GraphConv ask for
``preferred_element_type=float32`` (lifted to float64 for float64
operands), and ``elbo_loss`` casts its inputs to f32 (float64 leaves are
kept).  The JAX package itself is unchanged."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import snd_vae_tpu.losses as jax_losses
from snd_vae_tpu import config as jcfg
from snd_vae_tpu_torch import config as tcfg

SMALL = dict(
    num_nodes=8, sampling_num=3,
    encoder=dict(s_channels=(4, 4), s_kernel_sizes=(3, 3), s_strides=(1, 2),
                 s_hidden_size=4, s_latent_size=4, g_conv_hidden=(4, 4),
                 g_hidden_size=4, g_latent_size=4,
                 sg_conv_hidden=((4, 4, 4), (4, 4, 4)), sg_hidden_size=4,
                 sg_latent_size=4),
    decoder=dict(node_h_size=4, s_d_channels=(4, 4), s_d_kernel_sizes=(3, 3),
                 s_d_strides=(1, 1), n_d_channels=(4, 4), n_d_kernel_sizes=(4, 3),
                 n_d_strides=(1, 1), e_d_hidden=(4, 4), edge_from_coords=True),
)


def configs(case, **overrides):
    """The same Config in both packages (their fields are identical):
    "synthetic2" (the preset at full width) or "small"."""
    if case == "synthetic2":
        return jcfg.synthetic2_preset(**overrides), tcfg.synthetic2_preset(**overrides)
    out = []
    for mod in (jcfg, tcfg):
        kw = dict(SMALL, encoder=mod.EncoderConfig(**SMALL["encoder"]),
                  decoder=mod.DecoderConfig(**SMALL["decoder"]))
        out.append(mod.synthetic2_preset(**kw, **overrides))
    # every field equal but the dataset path, whose port default lies in its checkout
    same = [dict(dataclasses.asdict(c), dataset_path=None) for c in out]
    assert same[0] == same[1]
    return tuple(out)


@pytest.fixture
def exact_f64(monkeypatch):
    dot, einsum, cast = jnp.dot, jnp.einsum, jax_losses.cast_float_leaves

    def lift(kw, operands):
        if kw.get("preferred_element_type") == jnp.float32 and any(
            getattr(o, "dtype", None) == jnp.float64 for o in operands
        ):
            kw = dict(kw, preferred_element_type=jnp.float64)
        return kw

    def keep_f64(tree, dtype):
        is64 = lambda t: getattr(t, "dtype", None) == jnp.float64
        return jax.tree.map(lambda t: t if is64(t) else cast(t, dtype), tree)

    monkeypatch.setattr(jnp, "dot", lambda a, b, **kw: dot(a, b, **lift(kw, (a, b))))
    monkeypatch.setattr(
        jnp, "einsum", lambda s, *ops, **kw: einsum(s, *ops, **lift(kw, ops))
    )
    monkeypatch.setattr(jax_losses, "cast_float_leaves", keep_f64)
    with jax.enable_x64():
        yield


@pytest.fixture
def one_thread():
    """torch on one thread for the test: the suite runs several workers on
    the same cores, where each worker's pool of one thread per core
    oversubscribes them (a CPU training test ran ~30x slower that way than
    alone), and these tests' tensors are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_params(shapes, rng):
    """Seeded values for every leaf of the flax tree: kernels ~0.1·N(0,1),
    BN gamma ~1+0.1·N(0,1), biases and beta ~0.1·N(0,1) (non-zero, unlike
    the initializers, so that every bias path is checked)."""
    flat = {}
    for path, leaf in flatten_dict(shapes, sep="/").items():
        v = 0.1 * rng.standard_normal(leaf.shape)
        flat[path] = v + 1.0 if path.endswith("gamma") else v
    return flat
