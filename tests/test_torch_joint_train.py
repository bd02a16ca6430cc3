"""Training the joint ("base") model in the port against the JAX package:
one float64 step's loss, gradients and tf1-adam update against
``jax.grad`` of ``snd_vae_tpu.losses.elbo_loss`` (rtol 1e-8; the JAX step
compiled without XLA's ``algsimp``, as ``tests/test_torch_train.py``
explains), a short f32 lockstep of the port's steps at full synthetic2
width against the JAX trajectory with shared ε, dropout in the train step,
scene's Trainer and the CLI's ``--model-type base`` and ``--dataset
scene``, trained then served on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict
from torch_parity import exact_f64, one_thread  # noqa: F401  (fixtures)
from torch_parity import init_like, random_params, setup_models

from snd_vae_tpu import train as jtrain
from snd_vae_tpu.data.graphbatch import from_numpy as jax_batch
from snd_vae_tpu.losses import elbo_loss as jax_elbo_loss
from snd_vae_tpu.models import JointSNDVAE as JaxJoint
from snd_vae_tpu.models.outputs import Latents as JaxLatents
from snd_vae_tpu.models.outputs import ModelOutput as JaxModelOutput
from snd_vae_tpu_torch import cli
from snd_vae_tpu_torch import train as ttrain
from snd_vae_tpu_torch.checkpoint import Checkpointer
from snd_vae_tpu_torch.data.graphbatch import from_numpy as torch_batch
from snd_vae_tpu_torch.data.loaders import load_dataset
from snd_vae_tpu_torch.models import Latents
from snd_vae_tpu_torch.params import torch_layout, torch_name

pytestmark = pytest.mark.usefixtures("one_thread")
JOINT_AUX = ["adj_loss", "node_loss", "spatial_loss", "sg_kl", "loss", "mse_loss", "adj_acc"]


def _with_train(cfg, **kw):
    return cfg.with_(train=dataclasses.replace(cfg.train, **kw))


def _jax_step(jc, jm, opt):
    """One JAX step of the joint model with explicit ε for z_sg."""
    def loss_fn(p, batch, eps, global_iter):
        stats = jm.apply({"params": p}, batch, method=JaxJoint.encode)
        lat = JaxLatents(z_sg=stats.mean_sg + eps.reshape(stats.mean_sg.shape)
                         * jnp.exp(stats.logstd_sg))
        dec = jm.apply({"params": p}, lat, method=JaxJoint.decode)
        out = JaxModelOutput(stats=stats, latents=lat, decoded=dec)
        return jax_elbo_loss(jc, out, batch.adj, batch.features, batch.coords, global_iter)[0]

    def step(p, opt_state, batch, eps, global_iter):
        total, grads = jax.value_and_grad(loss_fn)(p, batch, eps, global_iter)
        updates, opt_state = opt.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, total, grads

    return step


def _setup(case, np_dtype, init, num_graphs, dataset="synthetic2", **over):
    jc, tc, jm, p, tm, arrays = setup_models(case, np_dtype, dataset, num_graphs=num_graphs,
                                             split="train", init=init, model_type="base",
                                             **over)
    jc, tc = (_with_train(c, optimizer="tf1-adam") for c in (jc, tc))
    state = ttrain.TrainState(cfg=tc, model=tm.train(),
                              optimizer=ttrain.make_optimizer(tc, tm.parameters()),
                              generator=torch.Generator().manual_seed(0))
    return jc, jm, p, arrays, state


@pytest.mark.parametrize("dataset", ["synthetic2", "scene"])
def test_one_step_matches_jax_f64(exact_f64, dataset):
    """The small config, one float64 step: loss, every gradient and every
    updated parameter against the JAX step (tf1-adam)."""
    jc, jm, p, arrays, state = _setup("small", np.float64, random_params, 10, dataset)
    B = jc.train.batch_size
    eps = np.random.default_rng(7).standard_normal((B, 1, jc.encoder.sg_latent_size))
    jb = jax_batch(**{k: v[:B] for k, v in arrays.items()}, dtype=np.float64)
    opt = jtrain.tf1_adam(jc.train.learning_rate)
    args = (p, opt.init(p), jb, jnp.asarray(eps), jnp.asarray(0.0))
    step = jax.jit(_jax_step(jc, jm, opt)).lower(*args).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})
    j_new, _, j_total, grads = step(*args)

    aux = ttrain.train_step(state, torch_batch(**{k: v[:B] for k, v in arrays.items()},
                                               dtype=torch.float64),
                            torch.tensor(0.0, dtype=torch.float64),
                            eps=Latents(z_sg=torch.from_numpy(eps)))
    assert sorted(aux) == sorted(JOINT_AUX)
    np.testing.assert_allclose(aux["loss"].item(), float(j_total), rtol=1e-8)
    named = dict(state.model.named_parameters())
    flat_g, flat_p = flatten_dict(grads, sep="/"), flatten_dict(j_new, sep="/")
    assert len(flat_g) == len(named)
    for path, g in flat_g.items():
        prm = named[torch_name(path)]
        g = torch_layout(path, np.asarray(g))
        # scene's node head is outside its loss: no gradient, where JAX has zeros
        got = prm.grad if prm.grad is not None else torch.zeros_like(prm)
        assert prm.grad is not None or (dataset == "scene" and not g.any()), path
        np.testing.assert_allclose(got.numpy(), g, rtol=1e-8,
                                   atol=1e-10 * np.abs(g).max(), err_msg=path)
        np.testing.assert_allclose(prm.detach().numpy(),
                                   torch_layout(path, np.asarray(flat_p[path])),
                                   rtol=1e-8, atol=1e-12, err_msg=path)


def test_lockstep_synthetic2_f32():
    """Full synthetic2 width in f32: 20 graphs (2 batches), 3 epochs,
    tf1-adam, the same weights and ε stream as the JAX trajectory; every
    step's cost within 1e-4 relative."""
    epochs, nb = 3, 2
    jc, jm, p, arrays, state = _setup("synthetic2", np.float32, init_like, 20)
    B, L = jc.train.batch_size, jc.encoder.sg_latent_size
    noise = np.random.default_rng(7).standard_normal((epochs * nb, B, 1, L)).astype(np.float32)
    opt = jtrain.tf1_adam(jc.train.learning_rate)
    step = jax.jit(_jax_step(jc, jm, opt))
    opt_state = opt.init(p)
    want, got = np.zeros((epochs, nb)), np.zeros((epochs, nb))
    for epoch in range(epochs):
        for i in range(nb):
            sl = {k: v[i * B:(i + 1) * B] for k, v in arrays.items()}
            n = noise[epoch * nb + i]
            p, opt_state, total, _ = step(p, opt_state, jax_batch(**sl), jnp.asarray(n),
                                          jnp.asarray(float(epoch)))
            want[epoch, i] = float(total)
            aux = ttrain.train_step(state, torch_batch(**sl), torch.tensor(float(epoch)),
                                    eps=Latents(z_sg=torch.from_numpy(n)))
            got[epoch, i] = aux["loss"].item()
    gap = np.abs(got - want) / np.abs(want)
    assert gap.max() < 1e-4, (got, want)
    assert abs(want[-1].mean() - want[0].mean()) > 1e-3     # the trajectory moves


def test_dropout_step_is_reproducible():
    """dropout_keep_prob 0.8: the step draws its masks from the state's
    generator; the same seed gives the same loss and update, and keep 1
    gives another loss."""
    def run(keep, seed):
        _, _, _, arrays, state = _setup("small", np.float32, random_params, 10)
        state.cfg = _with_train(state.cfg, dropout_keep_prob=keep)
        state.generator.manual_seed(seed)
        aux = ttrain.train_step(state, torch_batch(**arrays).slice_batch(0, 10),
                                torch.tensor(0.0))
        return aux["loss"].item(), [q.detach().clone() for q in state.model.parameters()]

    (l1, p1), (l2, p2) = run(0.8, 3), run(0.8, 3)
    assert l1 == l2 and all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert run(1.0, 3)[0] != l1 and run(0.8, 4)[0] != l1


def test_scene_trainer_loss_falls(tmp_path):
    """The scene preset at small widths on the fallback data: 40 graphs,
    B = 2, 4 epochs; finite losses, the K-way edge CE falling."""
    _, tc = setup_models("small", np.float32, "scene", model_type="base")[:2]
    tc = _with_train(tc, learning_rate=3e-3, checkpoint_every=100)
    data = load_dataset(tc, "train", num_graphs=40, device="cpu")
    tr = ttrain.Trainer(tc, data, device="cpu", workdir=str(tmp_path))
    assert tr.data.adj_samples is None
    losses = [np.mean(tr.run_epoch(e)["loss"]) for e in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


@pytest.mark.parametrize("argv", [["--model-type", "base"], ["--dataset", "scene"]])
def test_cli_trains_then_serves(tmp_path, capsys, argv):
    """--type train --epochs 1 writes a checkpoint under <dataset>_base;
    test_reconstruct restores it (no WARNING) and writes the joint model's
    reconstruction and its z_sg only; sample draws from the prior."""
    common = ["--device", "cpu", "--workdir", str(tmp_path),
              "--dataset-path", str(tmp_path / "data"), *argv]
    out = cli.main(["--type", "train", "--epochs", "1", *common])
    assert list(out) == JOINT_AUX + ["device"] and np.isfinite(out["loss"])
    dataset = "scene" if "scene" in argv else "synthetic2"
    assert Checkpointer(str(tmp_path / "checkpoints" / f"{dataset}_base")).latest_step() == 0
    capsys.readouterr()
    rec = cli.main(["--type", "test_reconstruct", *common])
    assert "WARNING" not in capsys.readouterr().err
    N = 10 if dataset == "scene" else 25
    assert rec["adj_shape"] == [200, N, N]
    qual = tmp_path / "qualitative_evaluation" / dataset
    assert sorted(f.name for f in qual.iterdir()) == ["base_z_sg.npy"]
    drawn = cli.main(["--type", "sample", "--num-generate", "3", *common])
    adj = np.load(tmp_path / drawn["dir"] / "adj.npy")
    assert adj.shape == (3, N, N) and adj.max() < (5 if dataset == "scene" else 2)
