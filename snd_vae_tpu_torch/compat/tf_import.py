"""The TF reference's variables as the port's weights — the port's own
numpy copy of ``snd_vae_tpu/compat/tf_import.py:37-181``.

``map_reference_variables`` / ``map_reference_variables_joint`` take the
reference's variables as ``{"scope/name:0": array}`` (the scopes of the
reference's model.py:98-222 and model_joint.py:72-182) and return the flax
parameter tree of the JAX package, as nested dicts of numpy arrays, bit for
bit what the JAX functions return.  ``state_dict_from_tf_variables`` composes
the map of ``cfg``'s family with ``params.state_dict_from_flax``.

Keras BatchNormalization variables (gamma, beta, moving_mean,
moving_variance) fold into the frozen BN's (gamma, beta): the reference runs
BN in inference mode, y = gamma·(x - mean)/sqrt(var + eps) + beta, and the
frozen layer computes y = gamma'·x/sqrt(1 + eps) + beta', so

    gamma' = gamma·sqrt(1 + eps)/sqrt(var + eps)
    beta'  = beta - gamma·mean/sqrt(var + eps).

The variables come from wherever TensorFlow is installed, e.g. an ``.npz``
written there from ``tf.train.load_checkpoint``: the port imports no
TensorFlow, so the JAX package's checkpoint reader (``:183-193``) has no
counterpart here.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..config import Config
from ..params import state_dict_from_flax

BN_EPS = 1e-3


def _bn(params_out: Dict, our_name: str, tf_vars: Mapping[str, np.ndarray], scope: str):
    gamma = tf_vars.get(f"{scope}/gamma:0")
    beta = tf_vars.get(f"{scope}/beta:0")
    if gamma is None or beta is None:
        raise KeyError(f"missing BN variables for scope {scope}")
    mean = tf_vars.get(f"{scope}/moving_mean:0")
    var = tf_vars.get(f"{scope}/moving_variance:0")
    if mean is not None and var is not None:
        scale = np.sqrt(1.0 + BN_EPS) / np.sqrt(var + BN_EPS)
        params_out[our_name] = {
            "gamma": np.asarray(gamma * scale, np.float32),
            "beta": np.asarray(beta - gamma * mean / np.sqrt(var + BN_EPS), np.float32),
        }
    else:
        params_out[our_name] = {"gamma": np.asarray(gamma, np.float32),
                                "beta": np.asarray(beta, np.float32)}


def _lin(params_out: Dict, our_name: str, tf_vars: Mapping[str, np.ndarray], scope: str):
    params_out[our_name] = {"kernel": np.asarray(tf_vars[f"{scope}/Matrix:0"], np.float32),
                            "bias": np.asarray(tf_vars[f"{scope}/bias:0"], np.float32)}


def _conv1d(params_out: Dict, our_name: str, tf_vars: Mapping[str, np.ndarray], scope: str):
    params_out[our_name] = {"kernel": np.asarray(tf_vars[f"{scope}/kernel:0"], np.float32),
                            "bias": np.asarray(tf_vars[f"{scope}/bias:0"], np.float32)}


def _motif_convs(p: Dict, tf_vars: Mapping[str, np.ndarray], cfg: Config) -> None:
    """The sg-branch's motif convs and their BNs (Matrix0-3 on the 3-D
    datasets, else Matrix1-3)."""
    n_mats = 4 if cfg.uses_3d_conv else 3
    first = 0 if cfg.uses_3d_conv else 1
    for i in range(len(cfg.encoder.sg_conv_hidden)):
        scope = f"encoder/g_sg{i}_conv"
        mats = {}
        for j in range(first, first + n_mats):
            mats[f"Matrix{j}"] = np.asarray(tf_vars[f"{scope}/Matrix{j}:0"], np.float32)
            mats[f"bias{j}"] = np.asarray(tf_vars[f"{scope}/bias{j}:0"], np.float32)
        p[f"sg_convs_{i}"] = mats
        _bn(p, f"sg_bns_{i}", tf_vars, f"encoder/g_bn_sg{i}")


def _e2e(p: Dict, tf_vars: Mapping[str, np.ndarray], cfg: Config) -> None:
    for i in range(len(cfg.decoder.e_d_hidden)):
        p[f"e_deconvs_{i}"] = {
            "w1": np.asarray(tf_vars[f"decoder/e{i}_deconv/w1:0"], np.float32),
            "biases1": np.asarray(tf_vars[f"decoder/e{i}_deconv/biases1:0"], np.float32),
        }
        _bn(p, f"d_bn_e_{i}", tf_vars, f"decoder/d_bn_e{i}")


def map_reference_variables(tf_vars: Mapping[str, np.ndarray], cfg: Config) -> Dict:
    """{tf_variable_name: array} -> the flax params of the disentangled
    model (JAX ``tf_import.py:71-137``)."""
    enc, dec = cfg.encoder, cfg.decoder
    p: Dict = {}
    # encoder: topology branch (model.py:104-115)
    for i in range(len(enc.g_conv_hidden)):
        p[f"g_convs_{i}"] = {
            "kernel": np.asarray(tf_vars[f"encoder/g_g{i}_conv/w:0"], np.float32)}
        _bn(p, f"g_bns_{i}", tf_vars, f"encoder/g_bn_g{i}")
    _bn(p, "encoder_g_bn", tf_vars, "encoder/encoder_g")
    _lin(p, "g_lin1", tf_vars, "encoder/g_g1_lin")
    _lin(p, "g_lin_mean", tf_vars, "encoder/g_g2_lin")
    _lin(p, "g_lin_std", tf_vars, "encoder/g_g3_lin")
    # encoder: spatial branch (model.py:119-129)
    for i in range(len(enc.s_channels)):
        _conv1d(p, f"s_convs_{i}", tf_vars, f"encoder/g_s{i + 1}_conv")
        _bn(p, f"s_bns_{i}", tf_vars, f"encoder/g_bn_s{i}")
    _bn(p, "encoder_s_bn", tf_vars, "encoder/encoder_s")
    _lin(p, "s_lin1", tf_vars, "encoder/g_s1_lin")
    _lin(p, "s_lin_mean", tf_vars, "encoder/g_s2_lin")
    _lin(p, "s_lin_std", tf_vars, "encoder/g_s3_lin")
    # encoder: joint branch (model.py:133-151)
    _motif_convs(p, tf_vars, cfg)
    _bn(p, "encoder_sg_bn", tf_vars, "encoder/encoder_sg")
    _lin(p, "sg_lin1", tf_vars, "encoder/g_sg1_lin")
    _lin(p, "sg_lin_mean", tf_vars, "encoder/g_sg2_lin")
    _lin(p, "sg_lin_std", tf_vars, "encoder/g_sg3_lin")
    # decoder (model.py:172-222)
    _lin(p, "d_sg_lin1", tf_vars, "decoder/d_sg_lin1")
    _lin(p, "d_s_lin1", tf_vars, "decoder/d_s_lin1")
    _lin(p, "d_g_lin1", tf_vars, "decoder/d_g_lin1")
    for i in range(len(dec.n_d_channels)):
        _conv1d(p, f"n_deconvs_{i}", tf_vars, f"decoder/n{i}_deconv")
        _bn(p, f"d_bn_n_{i}", tf_vars, f"decoder/d_bn_n{i}")
    _bn(p, "decoder_node_bn", tf_vars, "decoder/decoder_node")
    _lin(p, "d_n_lin2", tf_vars, "decoder/d_n_lin2")
    _e2e(p, tf_vars, cfg)
    _bn(p, "decoder_adj_bn", tf_vars, "decoder/decoder_adj")
    _lin(p, "d_e_lin2", tf_vars, "decoder/d_e_lin2")
    for i in range(len(dec.s_d_channels)):
        _conv1d(p, f"s_deconvs_{i}", tf_vars, f"decoder/s{i + 1}_deconv")
        _bn(p, f"d_bn_s_{i}", tf_vars, f"decoder/d_bn_s{i}")
    _lin(p, "d_s_lin2", tf_vars, "decoder/d_s_lin2")
    return p


def map_reference_variables_joint(tf_vars: Mapping[str, np.ndarray], cfg: Config) -> Dict:
    """{tf_variable_name: array} -> the flax params of the joint ("base")
    model (JAX ``tf_import.py:140-180``): one sg branch with no encoder BN
    after it, three heads off joint_h."""
    dec = cfg.decoder
    p: Dict = {}
    _motif_convs(p, tf_vars, cfg)
    _lin(p, "sg_lin1", tf_vars, "encoder/g_sg1_lin")
    _lin(p, "sg_lin_mean", tf_vars, "encoder/g_sg2_lin")
    _lin(p, "sg_lin_std", tf_vars, "encoder/g_sg3_lin")
    _lin(p, "d_sg_lin1", tf_vars, "decoder/d_sg_lin1")
    for i in range(len(dec.s_d_channels)):
        _conv1d(p, f"s_deconvs_{i}", tf_vars, f"decoder/s{i + 1}_deconv")
        _bn(p, f"d_bn_s_{i}", tf_vars, f"decoder/d_bn_s{i}")
    _lin(p, "d_s_lin2", tf_vars, "decoder/d_s_lin2")
    for i in range(len(dec.n_d_channels)):
        _conv1d(p, f"n_deconvs_{i}", tf_vars, f"decoder/n{i}_deconv")
        _bn(p, f"d_bn_n_{i}", tf_vars, f"decoder/d_bn_n{i}")
    _lin(p, "d_n_lin2", tf_vars, "decoder/d_n_lin2")
    _e2e(p, tf_vars, cfg)
    _lin(p, "d_e_lin2", tf_vars, "decoder/d_e_lin2")
    return p


def state_dict_from_tf_variables(tf_vars: Mapping[str, np.ndarray],
                                 cfg: Config) -> Dict[str, torch.Tensor]:
    """The reference's variables as a ``state_dict`` of ``cfg``'s model:
    the joint map for ``model_type`` "base", else the disentangled one,
    then ``params.state_dict_from_flax``."""
    tree = (map_reference_variables_joint if cfg.model_type == "base"
            else map_reference_variables)(tf_vars, cfg)
    return state_dict_from_flax({f"{module}/{leaf}": value
                                 for module, leaves in tree.items()
                                 for leaf, value in leaves.items()})
