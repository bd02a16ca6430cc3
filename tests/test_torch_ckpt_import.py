"""Weights from outside the port: the TF reference's variables
(``snd_vae_tpu_torch.compat.tf_import``) and a JAX package checkpoint
(``tools/flax_checkpoint_to_npz.py`` and ``params.load_flax_npz``).

  * The port's numpy copies of ``map_reference_variables`` and
    ``map_reference_variables_joint`` return JAX's trees bit for bit, for
    the disentangled and joint synthetic2 configs, on a seeded variable dict
    with the names JAX's maps read, the shapes of the parameters they
    produce and non-trivial BN moving statistics (the BN fold at work);
    ``state_dict_from_tf_variables`` loads into the port's model with no key
    missing or left over.
  * A flax tree from ``init_state``, saved by the JAX package's
    ``Checkpointer``, goes through the converter and ``load_flax_npz``, and
    the port's forward on it equals JAX's in float64.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from torch_parity import configs
from torch_parity import exact_f64, one_thread  # noqa: F401  (fixtures)

from snd_vae_tpu.checkpoint import Checkpointer as JaxCheckpointer
from snd_vae_tpu.compat.tf_import import map_reference_variables as jax_map
from snd_vae_tpu.compat.tf_import import map_reference_variables_joint as jax_map_joint
from snd_vae_tpu.data.graphbatch import from_numpy as jax_batch
from snd_vae_tpu.train import init_state
from snd_vae_tpu_torch.compat import tf_import
from snd_vae_tpu_torch.data.graphbatch import from_numpy as torch_batch
from snd_vae_tpu_torch.data.loaders import load_dataset
from snd_vae_tpu_torch.models import build_model
from snd_vae_tpu_torch.params import load_flax_npz

pytestmark = pytest.mark.usefixtures("one_thread")
ROOT = Path(__file__).resolve().parents[1]


class _Marked(dict):
    """A variable dict that hands every name it is asked for a marker: the
    name's index as a one-element array (moving means 0, variances 1, so a
    folded BN keeps its markers), and records the names in order."""

    def __init__(self):
        super().__init__()
        self.names = []

    def _value(self, key):
        if key not in self.names:
            self.names.append(key)
        if key.endswith("/moving_mean:0"):
            return np.zeros(1, np.float32)
        if key.endswith("/moving_variance:0"):
            return np.ones(1, np.float32)
        return np.full(1, float(self.names.index(key)), np.float32)

    def __getitem__(self, key):
        return self._value(key)

    def get(self, key, default=None):
        return self._value(key)


def _flax_shapes(jc):
    data = load_dataset(configs("synthetic2")[1], "test", num_graphs=2, device="cpu")
    arrays = {k: v.numpy() for k, v in vars(data).items() if v is not None}
    from snd_vae_tpu.models import build_model as jax_build_model

    jm = jax_build_model(jc)
    shapes = jax.eval_shape(lambda k: jm.init(k, jax_batch(**arrays), key=k),
                            jax.random.PRNGKey(0))["params"]
    return {k: tuple(v.shape) for k, v in flatten_dict(shapes, sep="/").items()}


def _seeded_variables(jc, mapper):
    """The variables ``mapper`` reads for ``jc``, each with the shape of the
    parameter it becomes, seeded; BN moving means and variances drawn
    non-trivially (variances positive)."""
    marked = _Marked()
    tree = flatten_dict(mapper(marked, jc), sep="/")
    shapes = _flax_shapes(jc)
    assert set(tree) == set(shapes)
    shape_of = {}
    for path, value in tree.items():
        shape_of[marked.names[int(value[0])]] = shapes[path]
    rng = np.random.default_rng(7)
    out = {}
    for name in marked.names:
        scope = name.rsplit("/", 1)[0]
        shape = shape_of.get(name, shape_of.get(f"{scope}/gamma:0"))
        if name.endswith("/moving_variance:0"):
            out[name] = rng.uniform(0.2, 3.0, shape).astype(np.float32)
        else:
            out[name] = rng.standard_normal(shape).astype(np.float32)
    return out


@pytest.mark.parametrize("model_type", ["disentangled", "base"])
def test_tf_variable_maps_equal_jax_bit_for_bit(model_type):
    jc, tc = configs("synthetic2", model_type=model_type)
    jax_fn = jax_map_joint if model_type == "base" else jax_map
    port_fn = (tf_import.map_reference_variables_joint if model_type == "base"
               else tf_import.map_reference_variables)
    tf_vars = _seeded_variables(jc, jax_fn)
    assert any(k.endswith("moving_variance:0") for k in tf_vars)
    want = flatten_dict(jax_fn(tf_vars, jc), sep="/")
    got = flatten_dict(port_fn(tf_vars, tc), sep="/")
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    # the BN fold changed something: a folded gamma is not the raw one
    assert not np.array_equal(got["sg_bns_0/gamma"], tf_vars["encoder/g_bn_sg0/gamma:0"])
    model = build_model(tc, device="cpu")
    result = model.load_state_dict(tf_import.state_dict_from_tf_variables(tf_vars, tc))
    assert not result.missing_keys and not result.unexpected_keys


def _converter():
    spec = importlib.util.spec_from_file_location(
        "flax_checkpoint_to_npz", ROOT / "tools" / "flax_checkpoint_to_npz.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flax_checkpoint_converts_and_loads_with_jax_forward(tmp_path, exact_f64):
    """The small config's ``init_state`` tree, saved by the JAX package's
    Checkpointer as epoch 3, converted to ``.npz`` by the tool and loaded by
    ``load_flax_npz``: the port's posterior-mean forward on the test split
    equals JAX's in float64 (the decoded logits, coordinates and node
    features at rtol 1e-8)."""
    jc, tc = configs("small")
    data = load_dataset(tc, "test", num_graphs=2, device="cpu")
    arrays = {k: v.numpy() for k, v in vars(data).items() if v is not None}
    with jax.enable_x64(False):   # the f32 init the JAX package runs
        _, state = init_state(jc, jax_batch(**arrays, dtype=np.float32))
    ck = JaxCheckpointer(str(tmp_path / "ckpt"))
    ck.save(3, state)
    ck.close()
    out = tmp_path / "params.npz"
    assert _converter().convert(jc, str(tmp_path / "ckpt"), str(out)) == 3
    sd = load_flax_npz(str(out))
    model = build_model(tc, device="cpu").to(torch.float64)
    result = model.load_state_dict(sd)
    assert not result.missing_keys and not result.unexpected_keys

    arrays = {k: v.astype(np.float64) for k, v in arrays.items()}
    from snd_vae_tpu.models import build_model as jax_build_model

    jm = jax_build_model(jc)
    flat = flatten_dict(jax.device_get(state.params), sep="/")
    with jax.enable_x64():
        p = unflatten_dict({k: jnp.asarray(np.asarray(v, np.float64)) for k, v in flat.items()},
                           sep="/")
        jd = jax.jit(lambda p, b: jm.apply({"params": p}, b, deterministic_z=True,
                                           key=jax.random.PRNGKey(0)).decoded)(
            p, jax_batch(**arrays, dtype=np.float64))
        want = {f: np.asarray(getattr(jd, f)) for f in ("adj_prob", "coords", "node_feat")}
    with torch.no_grad():
        td = model(torch_batch(**arrays, dtype=torch.float64), deterministic_z=True).decoded
    for f, w in want.items():
        np.testing.assert_allclose(getattr(td, f).numpy(), w, rtol=1e-8, atol=1e-12,
                                   err_msg=f)
