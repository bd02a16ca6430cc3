"""Both model families on the 3-D datasets (protein, mnist), where the
sg-branch runs the fourth-order motif conv, against the JAX package with
the flax parameters carried across by ``params.state_dict_from_flax``.

A tiny config (sg-conv widths (3,3,3,3) twice, the SMALL widths of
``torch_parity``; num_nodes 6 for protein, 8 for mnist, whose hulls then
leave two interior points without edges) in float64 at rtol 1e-8 under
``exact_f64`` (Dense and GraphConv ask for f32 accumulation in JAX): the
posteriors, the three heads on shared latents and the served path.  And
the disentangled model at the protein preset's widths (N = 50, sg-conv
widths (10,…) and (20,…)) over B = 2 graphs × S = 2 trees, one f32
forward at rtol 1e-4."""

import numpy as np
import pytest
import torch
from test_torch_joint import _check as check_joint
from test_torch_model import _check as check_disentangled
from torch_parity import exact_f64, one_thread  # noqa: F401  (fixtures)
from torch_parity import init_like, random_params, setup_models

from snd_vae_tpu_torch.models import DisentangledSNDVAE
from snd_vae_tpu_torch.nn import SpatialGraphConv3D

pytestmark = pytest.mark.usefixtures("one_thread")
SG_3D = dict(encoder=dict(sg_conv_hidden=((3, 3, 3, 3), (3, 3, 3, 3))))
TINY = {"protein": dict(SG_3D, num_nodes=6), "mnist": dict(SG_3D, num_nodes=8)}


def _latents(jc, np_dtype, seed=2):
    rng, enc = np.random.default_rng(seed), jc.encoder
    lat = {"z_sg": rng.standard_normal((2, jc.sampling_num, enc.sg_latent_size)),
           "z_s": rng.standard_normal((2, enc.s_latent_size)),
           "z_g": rng.standard_normal((2, enc.g_latent_size))}
    return {k: v.astype(np_dtype) for k, v in lat.items()}


def _check_3d_disentangled(case, dataset, np_dtype, rtol, atol, init, **over):
    jc, _, jm, p, tm, arrays = setup_models(case, np_dtype, dataset, init=init, **over)
    assert isinstance(tm, DisentangledSNDVAE)
    assert all(isinstance(c, SpatialGraphConv3D) for c in tm.sg_convs)
    check_disentangled(jm, p, tm, arrays, _latents(jc, np_dtype), rtol, atol, np_dtype)


@pytest.mark.parametrize("dataset", ["protein", "mnist"])
def test_disentangled_3d_matches_jax_f64(dataset, exact_f64):
    with torch.no_grad():
        _check_3d_disentangled("small", dataset, np.float64, 1e-8, 1e-10,
                               init=random_params, **TINY[dataset])


@pytest.mark.parametrize("dataset", ["protein", "mnist"])
def test_joint_3d_matches_jax_f64(dataset, exact_f64):
    with torch.no_grad():
        check_joint("small", dataset, np.float64, **TINY[dataset])


def test_mnist_hull_graph_has_isolated_nodes():
    """The tiny mnist batch the parity tests run: hull graphs, so points
    inside have no edge and no tree edge, and no factors."""
    arrays = setup_models("small", np.float32, "mnist", **TINY["mnist"])[-1]
    assert (arrays["adj"].sum(-1) == 0).sum() == 2
    assert (arrays["adj_samples"].sum(-1) == 0).sum() == 2 * 3
    assert "factors" not in arrays


def test_disentangled_protein_preset_widths_f32():
    """The protein preset's widths at its N = 50, on B = 2 graphs with
    S = 2 trees, f32 at rtol 1e-4 / atol 1e-5, the weights at the
    initializers' scale."""
    with torch.no_grad():
        _check_3d_disentangled("synthetic2", "protein", np.float32, 1e-4, 1e-5, init=init_like,
                               sampling_num=2)
