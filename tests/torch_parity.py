"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
the same Config in both packages, seeded flax parameters, the same model in
both packages (``setup_models``), and the ``exact_f64`` and ``one_thread``
fixtures, and ``jax_native``.

``exact_f64`` enables float64 in JAX and lifts the places where the JAX
package rounds float64 operands to f32: its Dense and GraphConv ask for
``preferred_element_type=float32`` (lifted to float64 for float64
operands), ``elbo_loss`` casts its inputs to f32 (float64 leaves are
kept), and ``nn/geometric.py`` computes its positional embedding in
float32 (its ``jnp.float32`` reads as float64).  The JAX package itself is
unchanged."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import snd_vae_tpu.losses as jax_losses
import snd_vae_tpu.nn.geometric as jax_geometric
from snd_vae_tpu import config as jcfg
from snd_vae_tpu.data.graphbatch import from_numpy as jax_batch
from snd_vae_tpu.models import build_model as jax_build_model
from snd_vae_tpu_torch import config as tcfg
from snd_vae_tpu_torch.data.loaders import load_dataset
from snd_vae_tpu_torch.models import build_model
from snd_vae_tpu_torch.params import state_dict_from_flax, torch_name, torch_perm

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


def configs(case, dataset="synthetic2", decoder=None, encoder=None, **overrides):
    """The same Config in both packages (their fields are identical):
    "synthetic2" (the preset of ``dataset`` at full width) or "small" (the
    SMALL widths over that preset; scene keeps its 10 nodes and K-way edge
    head).  ``decoder`` / ``encoder`` override DecoderConfig /
    EncoderConfig fields, ``overrides`` Config fields (SMALL's too)."""
    out = []
    for mod in (jcfg, tcfg):
        base = mod.preset(dataset)
        if case == "synthetic2":
            kw = {}
            dec = dict(decoder or {})
            if encoder:
                kw["encoder"] = dataclasses.replace(base.encoder, **encoder)
        else:
            kw = dict(SMALL, encoder=mod.EncoderConfig(**dict(SMALL["encoder"], **(encoder or {}))))
            dec = dict(SMALL["decoder"], **(decoder or {}))
            if dataset == "scene":
                kw["num_nodes"] = base.num_nodes
                dec["num_edge_feature"] = base.decoder.num_edge_feature
        if dec:
            kw["decoder"] = dataclasses.replace(base.decoder, **dec)
        out.append(base.with_(**dict(kw, **overrides)))
    # every field equal but the dataset path, whose port default lies in its checkout
    same = [dict(dataclasses.asdict(c), dataset_path=None) for c in out]
    assert same[0] == same[1]
    return tuple(out)


class _JnpF32AsF64:
    """``jax.numpy`` with ``float32`` standing for ``float64``."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


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
    monkeypatch.setattr(jax_geometric, "jnp", _JnpF32AsF64())
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


@pytest.fixture(scope="session")
def jax_native(tmp_path_factory):
    """The JAX package's native library, built privately for this test
    process: its module builds ``native/libsndkern.so`` in place on first
    use, which parallel test processes would race.  A failed build fails
    the test instead of letting JAX fall back to its numpy sampler."""
    import snd_vae_tpu.utils.native as jnative

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB_PATH",
                   str(tmp_path_factory.mktemp("jax_native") / "libsndkern.so"))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_load_failed", False)
        assert jnative.build(), "the JAX package's native library did not build"
        assert jnative.available()
        yield jnative


def random_params(shapes, rng):
    """Seeded values for every leaf of the flax tree: kernels ~0.1·N(0,1),
    BN gamma ~1+0.1·N(0,1), biases and beta ~0.1·N(0,1) (non-zero, unlike
    the initializers, so that every bias path is checked)."""
    flat = {}
    for path, leaf in flatten_dict(shapes, sep="/").items():
        v = 0.1 * rng.standard_normal(leaf.shape)
        flat[path] = v + 1.0 if path.endswith("gamma") else v
    return flat


def init_like(shapes, rng):
    """Seeded weights at the initializers' scale: kernels ~0.05·N(0,1), BN
    gamma 1, biases and beta 0.  For f32 comparisons at full width, where
    random_params' larger weights grow the activations to ~10² and the f32
    rounding of the sums with them."""
    flat = {}
    for path, leaf in flatten_dict(shapes, sep="/").items():
        leaf_name = path.rsplit("/", 1)[-1]
        if leaf_name == "gamma":
            flat[path] = np.ones(leaf.shape)
        elif leaf_name in ("bias", "beta") or leaf_name.startswith("bias"):
            flat[path] = np.zeros(leaf.shape)
        else:
            flat[path] = 0.05 * rng.standard_normal(leaf.shape)
    return flat


def torch_dtype(np_dtype):
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


def setup_models(case, np_dtype, dataset="synthetic2", num_graphs=2, split="test",
                 init=random_params, decoder=None, encoder=None, **overrides):
    """The configs of ``configs(case, dataset, decoder, encoder, **overrides)``, the
    port loader's ``split`` as numpy arrays in ``np_dtype``, the JAX model
    with flax params from ``init(shapes, rng)`` (shapes from its own f32
    init, traced only) and the port model carrying the same params.
    Returns (jax cfg, torch cfg, jax model, params tree, port model, arrays)."""
    jc, tc = configs(case, dataset, decoder, encoder, **overrides)
    data = load_dataset(tc, split, num_graphs=num_graphs, device="cpu")
    arrays = {k: v.numpy().astype(np_dtype) for k, v in vars(data).items() if v is not None}
    jm = jax_build_model(jc)
    small = {k: v[:2] for k, v in arrays.items()}
    with jax.enable_x64(False):
        shapes = jax.eval_shape(lambda k: jm.init(k, jax_batch(**small), key=k),
                                jax.random.PRNGKey(0))["params"]
    flat = {k: v.astype(np_dtype) for k, v in init(shapes, np.random.default_rng(1)).items()}
    tm = build_model(tc, device="cpu").to(torch_dtype(np_dtype))
    result = tm.load_state_dict(state_dict_from_flax(flat))
    assert not result.missing_keys and not result.unexpected_keys, result
    params = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    return jc, tc, jm, params, tm, arrays


def flax_params_from_state_dict(state_dict, shapes):
    """The inverse of ``snd_vae_tpu_torch.params.state_dict_from_flax``:
    the port's tensors as the flat ``"module/leaf"`` tree of the flax
    ``shapes``, each leaf taken from its port name and put back in the
    flax layout (numpy arrays of their own: a view of a parameter would
    follow its updates, and JAX's arrays made from it on the CPU too)."""
    flat = {}
    for path, leaf in flatten_dict(shapes, sep="/").items():
        value = state_dict[torch_name(path)].detach().cpu().numpy()
        flat[path] = np.array(np.transpose(value, np.argsort(torch_perm(
            path.rsplit("/", 1)[-1], value.ndim))))
        assert flat[path].shape == tuple(leaf.shape), path
    return flat
