"""Latent-traversal grids — the port of ``snd_vae_tpu/models/traversal.py``
(reference model.py:232-358, model_joint.py:192-206).

The grids are built in numpy, as in JAX: anchor latents taken from the
posterior-mean dumps that ``test_reconstruct`` writes
(``qualitative_evaluation/<dataset>/<model_type>_z_*.npy``), each repeated
``visualize_length`` (V) times, with one dimension swept over a fixed
range.  Anchor rows are [length, 2·length) of the dump, wrapping around
modulo its size.  Each function returns the port's ``Latents`` (float32) on
the device asked for (CUDA unless named), ready for ``model.decode``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..device import DeviceLike, resolve_device
from .outputs import Latents

# the reference's sweep ranges (model.py:245-256, 281-290)
TRAVERSE_RANGES = {
    "s": (-100.0, 20.0, 4.0),
    "g": (-60.0, 60.0, 4.0),
    "sg": (-30.0, 30.0, 2.0),
}
GENERATION_RANGES = {
    "s": (-20.0, 20.0, 2.0),
    "g": (-1.0, 1.0, 0.1),
    "sg": (-10.0, 10.0, 1.0),
}


def load_saved_latents(
    cfg: Config, directory: str = "./qualitative_evaluation", vae_type: str = "disentangled"
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The z_s, z_g, z_sg dumps under ``directory/<dataset>``, as [rows, L]."""
    d = os.path.join(directory, cfg.dataset)
    enc = cfg.encoder
    z_s = np.load(os.path.join(d, f"{vae_type}_z_s.npy")).reshape(-1, enc.s_latent_size)
    z_g = np.load(os.path.join(d, f"{vae_type}_z_g.npy")).reshape(-1, enc.g_latent_size)
    z_sg = np.load(os.path.join(d, f"{vae_type}_z_sg.npy")).reshape(-1, enc.sg_latent_size)
    return z_s, z_g, z_sg


def _latents(device: DeviceLike, z_sg, z_s=None, z_g=None) -> Latents:
    dev = resolve_device(device)
    on = lambda z: None if z is None else torch.as_tensor(
        np.asarray(z, dtype=np.float32), device=dev)
    return Latents(z_sg=on(z_sg[:, None, :]), z_s=on(z_s), z_g=on(z_g))


def _base_grid(cfg: Config, z_s, z_g, z_sg):
    """Each anchor latent repeated V times (model.py:235-242)."""
    V = cfg.visualize_length
    enc = cfg.encoder
    length = enc.g_latent_size + enc.s_latent_size + enc.sg_latent_size

    def pick(z, L):
        z = np.asarray(z).reshape(-1, L)
        idx = (np.arange(length) + length) % max(len(z), 1)
        return z[idx][:, None, :]

    z_s = np.tile(pick(z_s, enc.s_latent_size), [1, V, 1]).reshape(-1, enc.s_latent_size)
    z_g = np.tile(pick(z_g, enc.g_latent_size), [1, V, 1]).reshape(-1, enc.g_latent_size)
    z_sg = np.tile(pick(z_sg, enc.sg_latent_size), [1, V, 1]).reshape(-1, enc.sg_latent_size)
    return z_s, z_g, z_sg


def _sweep(lo, hi, step, V):
    return np.arange(lo, hi, step)[:V]


def traverse(cfg: Config, z_s, z_g, z_sg, group_type: str, fix_dim: int,
             device: DeviceLike = None) -> Latents:
    """One dimension of one group swept, V rows (model.py:232-265)."""
    V = cfg.visualize_length
    enc = cfg.encoder
    z_s, z_g, z_sg = _base_grid(cfg, z_s, z_g, z_sg)
    rang = _sweep(*TRAVERSE_RANGES[group_type], V)

    if group_type == "s":
        base, z = 0, z_s
    elif group_type == "g":
        base, z = enc.s_latent_size * V, z_g
    else:
        base, z = (enc.s_latent_size + enc.g_latent_size) * V, z_sg
    sl = slice(fix_dim * V + base, fix_dim * V + V + base)
    z[sl, fix_dim] = rang
    return _latents(device, z_sg[sl], z_s[sl], z_g[sl])


def traverse_generation(cfg: Config, z_s, z_g, z_sg,
                        dims: Optional[Tuple[int, int, int]] = None,
                        device: DeviceLike = None) -> Latents:
    """The three-group sweep of test_disentangle (model.py:267-324): rows of
    the s sweep, the g sweep and the sg sweep, 3·V in all; ``dims``
    (default ``cfg.traverse_dims``) clamped to the latent sizes."""
    V = cfg.visualize_length
    enc = cfg.encoder
    a, b, c = dims or cfg.traverse_dims
    a = min(a, enc.s_latent_size - 1)
    b = min(b, enc.g_latent_size - 1)
    c = min(c, enc.sg_latent_size - 1)
    z_s, z_g, z_sg = _base_grid(cfg, z_s, z_g, z_sg)

    z_s[a * V: a * V + V, a] = _sweep(*GENERATION_RANGES["s"], V)
    base_g = enc.s_latent_size * V
    z_g[b * V + base_g: b * V + V + base_g, b] = _sweep(*GENERATION_RANGES["g"], V)
    base_sg = (enc.s_latent_size + enc.g_latent_size) * V
    z_sg[c * V + base_sg: c * V + V + base_sg, c] = _sweep(*GENERATION_RANGES["sg"], V)

    sl_a = slice(a * V, a * V + V)
    sl_b = slice(b * V + base_g, b * V + V + base_g)
    sl_c = slice(c * V + base_sg, c * V + V + base_sg)
    z_s1 = np.concatenate([z_s[sl_a], z_s[sl_c], z_s[sl_c]])
    z_g1 = np.concatenate([z_g[sl_c], z_g[sl_b], z_g[sl_c]])
    z_sg1 = np.concatenate([z_sg[sl_a], z_sg[sl_b], z_sg[sl_c]])
    return _latents(device, z_sg1, z_s1, z_g1)


def traverse_joint(cfg: Config, z_sg, fix_dim: int, device: DeviceLike = None) -> Latents:
    """The joint model's single-latent grid (model_joint.py:192-206): every
    anchor V times, dimension ``fix_dim`` of its block swept over
    arange(-2, 2, 4/V)."""
    V = cfg.visualize_length
    L = cfg.encoder.sg_latent_size
    z = np.asarray(z_sg).reshape(-1, L)
    idx = (np.arange(L) + L) % max(len(z), 1)
    z = np.tile(z[idx][:, None, :], [1, V, 1]).reshape(-1, L)
    fix_dim = min(fix_dim, L - 1)
    z[fix_dim * V: fix_dim * V + V, fix_dim] = np.arange(-2.0, 2.0, 4.0 / V)[:V]
    return _latents(device, z)


def traverse_latent(cfg: Config, z_s, z_g, z_sg, device: DeviceLike = None) -> Latents:
    """Every dimension of every group swept over arange(-10, 10, 2)
    (model.py:326-358)."""
    V = cfg.visualize_length
    enc = cfg.encoder
    z_s, z_g, z_sg = _base_grid(cfg, z_s, z_g, z_sg)
    rang = _sweep(-10.0, 10.0, 2.0, V)
    for dim in range(enc.s_latent_size):
        z_s[dim * V: dim * V + V, dim] = rang
    base = enc.s_latent_size * V
    for dim in range(enc.g_latent_size):
        z_g[dim * V + base: dim * V + V + base, dim] = rang
    base = (enc.s_latent_size + enc.g_latent_size) * V
    for dim in range(enc.sg_latent_size):
        z_sg[dim * V + base: dim * V + V + base, dim] = rang
    return _latents(device, z_sg, z_s, z_g)
