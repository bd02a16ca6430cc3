"""The weights bridge: a flax parameter tree of the JAX package as a torch
``state_dict`` of the port.

``state_dict_from_flax`` takes the tree flattened to ``"module/leaf"`` paths
(``flax.traverse_util.flatten_dict(params, sep="/")``, as numpy arrays) and
returns tensors that ``load_state_dict`` takes with no missing or unexpected
keys:

  * list entries ``name_<i>`` become ``name.<i>`` (``g_convs_0/kernel`` ->
    ``g_convs.0.kernel``, ``d_bn_e_0/gamma`` -> ``d_bn_e.0.gamma``);
  * a Conv1D ``kernel`` [k, in, out] becomes torch's [out, in, k];
  * a 4-D ``w`` or ``w1`` [H, W, I, O] becomes [O, I, H, W]: E2E's [1, k_h,
    C, O] the row conv's [O, C, 1, k_h] (the column conv uses its transpose
    [O, C, k_h, 1] inside the module), the VALID convs' (E2N, N2N, N2GAdj)
    ``F.conv2d`` weights, the transposed convs' (DeN2G, DeN2N, DeE2N,
    DeE2E: tf.nn.conv2d_transpose's [h, w, out, in]) ``F.conv_transpose2d``
    weights [in, out, h, w];
  * everything else keeps its layout: Dense and GraphConv ``kernel`` [in,
    out], the motif ``Matrix*``, biases, BN ``gamma``/``beta``, geoGCN's
    ``GeoGraphConv.w`` [in, out] and posGCN's ``StructGraphConv``
    ``edge_embedding_matrix`` [39, 128], ``bias1`` [128] and ``w`` [in, out].

``load_flax_npz`` reads such a flattened tree from an ``.npz`` file, as
``tools/flax_checkpoint_to_npz.py`` writes it from a JAX package checkpoint.

The joint model's tree (``sg_convs_<i>``, ``sg_bns_<i>``, ``sg_lin1``,
``sg_lin_mean``/``_std``, ``d_sg_lin1``, ``s_deconvs_<i>``, ``d_bn_s_<i>``,
``d_s_lin2``, ``n_deconvs_<i>``, ``d_bn_n_<i>``, ``d_n_lin2``,
``e_deconvs_<i>``, ``d_bn_e_<i>``, ``d_e_lin2``) maps by the same rules.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

_LIST_ENTRY = re.compile(r"(.+)_(\d+)")


def torch_name(flax_path: str) -> str:
    parts = flax_path.split("/")
    out = []
    for p in parts[:-1]:
        m = _LIST_ENTRY.fullmatch(p)
        out.append(f"{m.group(1)}.{m.group(2)}" if m else p)
    return ".".join(out + [parts[-1]])


def torch_perm(leaf: str, ndim: int) -> Tuple[int, ...]:
    """The flax axis that each axis of the port's tensor holds, for a leaf
    named ``leaf`` (the last part of its flax path or port name)."""
    if leaf == "kernel" and ndim == 3:       # Conv1D [k, in, out]
        return (2, 1, 0)
    if leaf in ("w", "w1") and ndim == 4:    # conv kernels [H, W, I, O]
        return (3, 2, 0, 1)
    return tuple(range(ndim))


def torch_layout(flax_path: str, value: np.ndarray) -> np.ndarray:
    return np.transpose(value, torch_perm(flax_path.rsplit("/", 1)[-1], value.ndim))


def state_dict_from_flax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {
        torch_name(path): torch.from_numpy(
            np.ascontiguousarray(torch_layout(path, np.asarray(value))))
        for path, value in flat.items()
    }


def load_flax_npz(path: str) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a JAX package parameter tree saved as an
    ``.npz`` of its ``"module/leaf"`` paths (``tools/
    flax_checkpoint_to_npz.py``)."""
    with np.load(path, allow_pickle=False) as flat:
        return state_dict_from_flax({k: flat[k] for k in flat.files})


def sharded_gcn_state_dict(kernels: Sequence[np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX's ``ShardedGCNEncoder`` parameters (a list of [F, H] kernels) as
    the state_dict of the port's ``parallel.large_graph.ShardedGCNEncoder``."""
    return {f"kernels.{i}": torch.from_numpy(np.ascontiguousarray(np.asarray(k)))
            for i, k in enumerate(kernels)}
