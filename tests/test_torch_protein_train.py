"""Training both model families on the 3-D datasets (protein, mnist) and
with the blocked motif lowerings (``motif_block_rows``) against the JAX
package: one float64 step's loss and every gradient against
``jax.value_and_grad`` of ``snd_vae_tpu.losses.elbo_loss`` (rtol 1e-8; the
JAX step compiled without XLA's ``algsimp``, as ``tests/test_torch_train.py``
explains), with ε shared; the blocked step against the unblocked one; and
the CLI's train, test_reconstruct and sample for ``--dataset protein`` and
``--dataset mnist`` on the CPU, at a small config."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from torch_parity import exact_f64, one_thread  # noqa: F401  (fixtures)
from torch_parity import configs, random_params, setup_models

from snd_vae_tpu.data.graphbatch import from_numpy as jax_batch
from snd_vae_tpu.losses import elbo_loss as jax_elbo_loss
from snd_vae_tpu.models import DisentangledSNDVAE as JaxModel
from snd_vae_tpu.models import JointSNDVAE as JaxJoint
from snd_vae_tpu.models.outputs import Latents as JaxLatents
from snd_vae_tpu.models.outputs import ModelOutput as JaxModelOutput
from snd_vae_tpu_torch import cli
from snd_vae_tpu_torch import config as tcfg
from snd_vae_tpu_torch import train as ttrain
from snd_vae_tpu_torch.checkpoint import Checkpointer
from snd_vae_tpu_torch.data.graphbatch import from_numpy as torch_batch
from snd_vae_tpu_torch.models import Latents
from snd_vae_tpu_torch.params import torch_layout, torch_name

pytestmark = pytest.mark.usefixtures("one_thread")
SG_3D = dict(encoder=dict(sg_conv_hidden=((3, 3, 3, 3), (3, 3, 3, 3))))
NODES = {"protein": 6, "mnist": 8, "synthetic2": 8}


def _jax_loss_and_grads(jc, jm, p, jb, eps):
    """The JAX ELBO of one batch with latents μ + ε·exp(logσ), and its
    gradients, compiled without algsimp."""
    fam = JaxJoint if jc.model_type == "base" else JaxModel

    def loss_fn(p):
        stats = jm.apply({"params": p}, jb, method=fam.encode)
        z = {k: getattr(stats, "mean_" + k[2:]) + e.reshape(getattr(stats, "mean_" + k[2:]).shape)
             * jnp.exp(getattr(stats, "logstd_" + k[2:])) for k, e in eps.items()}
        lat = JaxLatents(**z)
        out = JaxModelOutput(stats=stats, latents=lat,
                             decoded=jm.apply({"params": p}, lat, method=fam.decode))
        return jax_elbo_loss(jc, out, jb.adj, jb.features, jb.coords, jnp.asarray(0.0))[0]

    step = jax.jit(jax.value_and_grad(loss_fn)).lower(p).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})
    return step(p)


def _port_step(tc, tm, arrays, eps):
    state = ttrain.TrainState(cfg=tc, model=tm.train(),
                              optimizer=ttrain.make_optimizer(tc, tm.parameters()),
                              generator=torch.Generator().manual_seed(0))
    aux = ttrain.train_step(state, torch_batch(**arrays, dtype=torch.float64),
                            torch.tensor(0.0, dtype=torch.float64),
                            eps=Latents(**{k: torch.from_numpy(v) for k, v in eps.items()}))
    return aux["loss"].item(), {k: p.grad for k, p in tm.named_parameters()}


def _eps(jc, model_type, B):
    rng, enc = np.random.default_rng(7), jc.encoder
    eps = {"z_sg": rng.standard_normal((B, 1 if model_type == "base" else jc.sampling_num,
                                        enc.sg_latent_size))}
    if model_type != "base":
        eps.update(z_s=rng.standard_normal((B, enc.s_latent_size)),
                   z_g=rng.standard_normal((B, enc.g_latent_size)))
    return eps


@pytest.mark.parametrize("dataset,model_type,block_rows", [
    ("protein", "disentangled", None), ("mnist", "disentangled", None),
    ("protein", "base", None), ("mnist", "base", None),
    ("protein", "disentangled", 3), ("synthetic2", "disentangled", 4),
])
def test_one_step_matches_jax_f64(exact_f64, dataset, model_type, block_rows):
    """The small config, one float64 step: the loss and every gradient
    against JAX's at rtol 1e-8; with motif_block_rows, JAX's blocked
    lowering on its side, and the port's blocked gradients equal to its
    unblocked ones at rtol 1e-12."""
    over = dict(SG_3D) if dataset != "synthetic2" else {}
    jc, tc, jm, p, tm, arrays = setup_models(
        "small", np.float64, dataset, split="train", init=random_params, model_type=model_type,
        num_nodes=NODES[dataset], motif_block_rows=block_rows, **over)
    eps = _eps(jc, model_type, len(arrays["adj"]))     # one batch of the 2 graphs loaded
    j_total, grads = _jax_loss_and_grads(jc, jm, p, jax_batch(**arrays, dtype=np.float64),
                                         {k: jnp.asarray(v) for k, v in eps.items()})
    loss, got = _port_step(tc, tm, arrays, eps)
    np.testing.assert_allclose(loss, float(j_total), rtol=1e-8)
    flat_g = flatten_dict(grads, sep="/")
    assert len(flat_g) == len(got)
    for path, g in flat_g.items():
        g = torch_layout(path, np.asarray(g))
        np.testing.assert_allclose(got[torch_name(path)].numpy(), g, rtol=1e-8,
                                   atol=1e-10 * np.abs(g).max(), err_msg=path)
    if block_rows is not None:
        _, _, _, _, tm0, _ = setup_models(
            "small", np.float64, dataset, split="train", init=random_params,
            model_type=model_type, num_nodes=NODES[dataset], **over)
        loss0, ref = _port_step(tc.with_(motif_block_rows=None), tm0, arrays, eps)
        np.testing.assert_allclose(loss, loss0, rtol=1e-12)
        for name, g in got.items():
            np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=1e-12,
                                       atol=1e-14 * ref[name].abs().max().item(), err_msg=name)


def _small_preset(dataset, batch_size=10):
    """The small 3-D config of these tests as the CLI's preset."""
    _, tc = configs("small", dataset, num_nodes=NODES[dataset], **SG_3D)
    return lambda **kw: tc.with_(train=dataclasses.replace(tc.train, batch_size=batch_size),
                                 **kw)


@pytest.mark.parametrize("dataset", ["protein", "mnist"])
def test_cli_trains_then_serves_3d(tmp_path, capsys, monkeypatch, dataset):
    """--dataset protein|mnist at the small config (200 fallback graphs, 20
    steps): train one epoch, then test_reconstruct from its checkpoint (no
    WARNING) and sample; both write the decoded arrays."""
    monkeypatch.setitem(tcfg.PRESETS, dataset, _small_preset(dataset))
    common = ["--dataset", dataset, "--device", "cpu", "--workdir", str(tmp_path),
              "--dataset-path", str(tmp_path / "data")]
    out = cli.main(["--type", "train", "--epochs", "1", *common])
    assert np.isfinite(out["loss"])
    assert Checkpointer(str(tmp_path / "checkpoints" / f"{dataset}_disentangled")) \
        .latest_step() == 0
    capsys.readouterr()
    rec = cli.main(["--type", "test_reconstruct", *common])
    assert "WARNING" not in capsys.readouterr().err
    N = NODES[dataset]
    assert rec["adj_shape"] == [200, N, N]
    coords = np.load(tmp_path / rec["dir"] / "coords.npy")
    assert coords.shape == (200, N, 3) and np.isfinite(coords).all()
    drawn = cli.main(["--type", "sample", "--num-generate", "3", *common])
    assert np.load(tmp_path / drawn["dir"] / "adj.npy").shape == (3, N, N)
