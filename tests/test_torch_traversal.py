"""The port's ``models/traversal.py`` against ``snd_vae_tpu.models.traversal``:
every grid equal, element for element, on the same saved latents, including
dumps shorter than the anchor rows (wrap-around) and dimensions beyond the
latent sizes (clamped); the grids come back as float32 tensors on the device
asked for."""

import dataclasses

import numpy as np
import pytest
import torch

import snd_vae_tpu.models.traversal as jtrav
import snd_vae_tpu_torch.models.traversal as ttrav
from snd_vae_tpu import config as jcfg
from snd_vae_tpu_torch import config as tcfg


def _cfgs(**enc):
    out = []
    for mod in (jcfg, tcfg):
        c = mod.synthetic2_preset(visualize_length=4)
        out.append(c.with_(encoder=dataclasses.replace(c.encoder, **enc)))
    return out


def _latents(rows, cfg, seed=0):
    rng, e = np.random.default_rng(seed), cfg.encoder
    return tuple(rng.standard_normal((rows, L)).astype(np.float32)
                 for L in (e.s_latent_size, e.g_latent_size, e.sg_latent_size))


def _equal(got, want):
    for name in ("z_sg", "z_s", "z_g"):
        w, g = getattr(want, name), getattr(got, name)
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == torch.float32 and g.device.type == "cpu", name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


GRIDS = {
    "single_s0": lambda m, c, z: m.traverse(c, *z, "s", 0),
    "single_g5": lambda m, c, z: m.traverse(c, *z, "g", 5),
    "single_sg3": lambda m, c, z: m.traverse(c, *z, "sg", 3),
    # the reference's dims (77, 48, 171), clamped to the latent sizes
    "generation_default": lambda m, c, z: m.traverse_generation(c, *z),
    "generation_123": lambda m, c, z: m.traverse_generation(c, *z, dims=(1, 2, 3)),
    "latent": lambda m, c, z: m.traverse_latent(c, *z),
    "joint_2": lambda m, c, z: m.traverse_joint(c, z[2], 2),
    "joint_50": lambda m, c, z: m.traverse_joint(c, z[2], 50),
}


# 40 rows hold the anchors [length, 2·length) of the small sizes; 7 rows wrap
@pytest.mark.parametrize("rows", [40, 7])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_traversal_matches_jax(grid, rows):
    jc, tc = _cfgs(s_latent_size=5, g_latent_size=6, sg_latent_size=7)
    z = _latents(rows, tc)

    class OnCpu:   # the port's functions with device="cpu"
        def __getattr__(self, name):
            return lambda *a, **kw: getattr(ttrav, name)(*a, device="cpu", **kw)

    _equal(GRIDS[grid](OnCpu(), tc, z), GRIDS[grid](jtrav, jc, z))


def test_load_saved_latents_matches_jax(tmp_path):
    jc, tc = _cfgs()
    d = tmp_path / "synthetic2"
    d.mkdir()
    for name, z in zip(("z_s", "z_g", "z_sg"), _latents(12, tc)):
        np.save(d / f"disentangled_{name}.npy", z.reshape(3, 4, -1))
    for got, want in zip(ttrav.load_saved_latents(tc, str(tmp_path)),
                         jtrav.load_saved_latents(jc, str(tmp_path))):
        np.testing.assert_array_equal(got, want)
