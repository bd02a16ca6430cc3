"""The port's data-parallel step and Trainer (``train.train_step`` under a
``data`` mesh, ``Trainer(mesh=...)``, the CLI's ``--dp --distributed``)
at world sizes 2 and 4 over gloo (ranks in ``tests/torch_dist_workers.py``).

  * The data-parallel step equals the single-process step on the same
    global batch in float64 to 1e-10 (the loss and every aux value, every
    gradient, every updated parameter) for the default ELBO, DIP-VAE,
    β-TCVAE, the weighted BCE, corrected mode's ``BatchStatNorm`` and the
    joint model with dropout at keep 0.8; the ε stream and the dropout
    masks are drawn from the shared generator.  The hierarchical total
    correlation, which no ``elbo_loss`` branch calls in either package, is
    held at the function level with its gradients.
  * One case against JAX's data-parallel step on the 4x1 virtual mesh
    (``tests/test_parallel.py``'s setup) in float64, with the ε given.
  * 2 epochs of the Trainer at world 2: the same losses on both ranks, the
    checkpoints written once, and a resume that continues bit for bit.
  * The CLI under ``torchrun`` with two gloo processes.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from torch_parity import configs, random_params, setup_models
from torch_parity import exact_f64, one_thread  # noqa: F401  (fixtures)
from torch_dist_workers import one_step, run_many

from snd_vae_tpu import train as jtrain
from snd_vae_tpu.compat.lockstep import _make_jax_lockstep_step, make_noise_stream
from snd_vae_tpu.data.graphbatch import from_numpy as jax_batch
from snd_vae_tpu.parallel import make_mesh, shard_graphbatch, shard_params
from snd_vae_tpu_torch.data.loaders import load_dataset
from snd_vae_tpu_torch.losses import hierarchical_total_correlation
from snd_vae_tpu_torch.params import state_dict_from_flax, torch_layout, torch_name
from snd_vae_tpu_torch.train import Trainer

pytestmark = pytest.mark.usefixtures("one_thread")
ROOT = Path(__file__).resolve().parents[1]
B = 8
TOL = 1e-10


def _with_train(cfg, **kw):
    return cfg.with_(train=dataclasses.replace(cfg.train, **kw))


def _cases():
    """The torch config of each case, at the small widths with B = 8."""
    tc = _with_train(configs("small")[1], batch_size=B)
    return {
        "default": tc,
        "dip": tc.with_(model_type="NED-VAE-IP"),
        "tcvae": tc.with_(model_type="beta-TCVAE"),
        "weighted_bce": tc.with_(loss=dataclasses.replace(tc.loss, use_weighted_bce=True)),
        "corrected": tc.with_(parity=False),
        "joint_dropout": _with_train(tc.with_(model_type="base"), dropout_keep_prob=0.8),
    }


def _arrays(cfg):
    data = load_dataset(cfg, "train", num_graphs=B, device="cpu")
    return {k: v.numpy().astype(np.float64) for k, v in vars(data).items() if v is not None}


def _jax_case():
    """The small config with tf1-adam, flax params, the global batch and ε
    (the JAX lockstep stream)."""
    with jax.enable_x64():   # the params as float64 arrays
        jc, tc, jm, params, _, _ = setup_models("small", np.float64, init=random_params)
    jc, tc = (_with_train(c, batch_size=B, optimizer="tf1-adam") for c in (jc, tc))
    enc = jc.encoder
    eps = make_noise_stream(7, 1, {"s": (B, enc.s_latent_size),
                                   "sg": (B * jc.sampling_num, enc.sg_latent_size),
                                   "g": (B, enc.g_latent_size)})[0]
    flat = {k: np.array(v) for k, v in flatten_dict(params, sep="/").items()}
    return jc, jm, flat, {"cfg": tc, "arrays": _arrays(tc), "eps": eps,
                          "state_dict": state_dict_from_flax(flat)}


def _trainer_cfg():
    """The small config at B = 4 in corrected mode's data handling: the
    batches reshuffled every epoch and the trees drawn anew."""
    return _with_train(configs("small")[1], batch_size=4, checkpoint_every=1, reshuffle=True,
                       resample_trees_every=1)


def _htc_inputs():
    """z, μ and logσ of three latent groups (widths 2, 3, 2), B samples."""
    rng = np.random.default_rng(5)
    return [rng.standard_normal((B, d)) * s for d in (2, 3, 2) for s in (1.0, 1.0, 0.3)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """World 2 and world 4 at once: every case; world 2 also the Trainer
    and the hierarchical TC, world 4 also the JAX case."""
    cases = {name: {"cfg": c, "arrays": _arrays(c)} for name, c in _cases().items()}
    jc, jm, flat, jax_inputs = _jax_case()
    trainer_cfg = _trainer_cfg()
    outs = run_many([
        ("dp_step", 2, tmp_path_factory.mktemp("dp2"),
         {"cases": cases, "htc": _htc_inputs(), "trainer": trainer_cfg}),
        ("dp_step", 4, tmp_path_factory.mktemp("dp4"),
         {"cases": dict(cases, jax=jax_inputs)}),
    ])
    return cases, (jc, jm, flat, jax_inputs), dict(zip((2, 4), outs))


def _assert_step_equal(got, want, lr, tol=TOL):
    """Aux values at rtol ``tol``; gradients at rtol ``tol`` with an atol of
    ``tol`` times the largest gradient of the step: where a gradient is
    zero (a bias before corrected mode's batch norm) float64 leaves a
    residue of ~1e-21 in either run.  The updated parameters at rtol
    ``tol`` with an atol of lr/eps times that gradient atol: Adam's first
    step moves a parameter by lr·g/(|g| + eps), whose slope in g reaches
    lr/eps where |g| is below eps."""
    assert got["aux"].keys() == want["aux"].keys()
    for k, v in want["aux"].items():
        np.testing.assert_allclose(got["aux"][k], v, rtol=tol, atol=1e-14, err_msg=k)
    assert got["grads"].keys() == want["grads"].keys()
    scale = max(g.abs().max().item() for g in want["grads"].values())
    for n, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][n].numpy(), g.numpy(), rtol=tol,
                                   atol=tol * scale, err_msg=n)
        np.testing.assert_allclose(got["params"][n].numpy(), want["params"][n].numpy(),
                                   rtol=tol, atol=lr / 1e-8 * tol * scale, err_msg=n)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("case", list(_cases()))
def test_dp_step_equals_single_process_step(world, case, d):
    cases, _, outs = world
    cfg = cases[case]["cfg"]
    want = one_step(cfg, cases[case]["arrays"])
    for o in outs[d]:
        _assert_step_equal(o[case], want, cfg.train.learning_rate)


def test_hierarchical_tc_equals_single_process(world):
    """Each rank's value is the global batch's; its gradients for its own
    rows, divided by the world (every rank computes the same global value),
    are the single-process gradients' rows."""
    _, _, outs = world
    full = [torch.from_numpy(a).requires_grad_(True) for a in _htc_inputs()]
    value = hierarchical_total_correlation(*full)
    grads = torch.autograd.grad(value, full)
    for r, o in enumerate(outs[2]):
        np.testing.assert_allclose(o["htc"]["value"], value.item(), rtol=TOL)
        for got, want in zip(o["htc"]["grads"], grads):
            np.testing.assert_allclose(got.numpy() / 2, want.chunk(2)[r].numpy(), rtol=TOL,
                                       atol=1e-14)


def test_dp_step_matches_jax_4x1_mesh(world, exact_f64):
    """World 4 against JAX's data-parallel step on the 4x1 mesh (batch
    sharded over 'data', parameters replicated), float64, ε given; the JAX
    step compiled without XLA's algsimp (ROADMAP §3)."""
    _, (jc, jm, flat, inputs), outs = world
    mesh = make_mesh(4, 1)
    jb = shard_graphbatch(jax_batch(**inputs["arrays"], dtype=np.float64), mesh)
    params = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    params = shard_params(params, mesh, min_size=1 << 30)
    jeps = [jnp.asarray(inputs["eps"][k], jnp.float64) for k in ("s", "sg", "g")]
    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    args = (params, capture.init(params), jb, *jeps, jnp.asarray(0.0))
    step = _make_jax_lockstep_step(jc, jm, capture).lower(*args).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})
    _, grads, j_total = step(*args)
    tf1 = jtrain.tf1_adam(jc.train.learning_rate)
    j_new = jax.jit(lambda g, p: optax.apply_updates(p, tf1.update(g, tf1.init(p))[0]))(
        grads, params)
    flat_g, flat_p = flatten_dict(grads, sep="/"), flatten_dict(j_new, sep="/")
    for o in outs[4]:
        got = o["jax"]
        np.testing.assert_allclose(got["aux"]["loss"], float(j_total), rtol=1e-8)
        assert len(flat_g) == len(got["grads"])
        for path, g in flat_g.items():
            g = torch_layout(path, np.asarray(g))
            name = torch_name(path)
            np.testing.assert_allclose(got["grads"][name].numpy(), g, rtol=1e-8,
                                       atol=1e-10 * np.abs(g).max(), err_msg=path)
            np.testing.assert_allclose(got["params"][name].numpy(),
                                       torch_layout(path, np.asarray(flat_p[path])),
                                       rtol=1e-8, atol=1e-12, err_msg=path)


def test_trainer_at_world_2_writes_once_and_resumes_bit_exactly(world, tmp_path):
    """2 epochs of 2 steps, reshuffled and with trees drawn anew each
    epoch: the same losses on both ranks and, within f32's summation order
    (rtol 1e-5), a single-process Trainer's; rank 0 alone logs; the
    checkpoints written once; a resume continues bit for bit on each
    rank."""
    _, _, outs = world
    t0, t1 = (o["trainer"] for o in outs[2])
    assert t0["means"] == t1["means"] and np.isfinite(t0["means"]["loss"])
    cfg = _trainer_cfg()
    data = load_dataset(cfg, "train", num_graphs=2 * cfg.train.batch_size, device="cpu")
    single = Trainer(cfg, data, device="cpu", workdir=str(tmp_path)).run(2, verbose=False)
    for k, v in single.items():
        np.testing.assert_allclose(t0["means"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    assert t0["writes_logs"] and not t1["writes_logs"]
    assert t0["checkpoints"] == t1["checkpoints"] == ["ckpt_0.pt", "ckpt_1.pt"]
    for t in (t0, t1):
        a, b = t["straight"], t["resumed"]
        assert a["step"] == b["step"] == 4
        for n, p in a["params"].items():
            assert torch.equal(p, b["params"][n]), n
        assert torch.equal(a["generator"], b["generator"])
        sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
        for i in sa:
            for k, v in sa[i].items():
                assert (torch.equal(v, sb[i][k]) if isinstance(v, torch.Tensor)
                        else v == sb[i][k]), (i, k)
    for n, p in t0["straight"]["params"].items():
        assert torch.equal(p, t1["straight"]["params"][n]), n


def _write_dataset(root, graphs=20):
    """A small synthetic2 dataset in the reference's on-disk layout."""
    from snd_vae_tpu_torch.data.synthetic import generate_synthetic, save_synthetic_npy

    for split, seed in (("train", 1), ("test", 2)):
        save_synthetic_npy(generate_synthetic(graphs, 25, seed=seed),
                           str(root / "spatial_network_correlated2" / "25" / split))


def test_cli_trains_data_parallel_under_torchrun(tmp_path):
    """``torchrun --nproc_per_node 2 -m snd_vae_tpu_torch.cli --type train
    --dp 2 --distributed --device cpu --profile``: both processes join,
    print the same finite loss, one checkpoint is written, and each
    process writes its own trace of the (one) epoch."""
    _write_dataset(tmp_path / "data")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "--log-dir", str(tmp_path / "logs"), "--redirects", "3",
           "-m", "snd_vae_tpu_torch.cli", "--type", "train", "--epochs", "1",
           "--dp", "2", "--distributed", "--device", "cpu", "--profile",
           "--workdir", str(tmp_path), "--dataset-path", str(tmp_path / "data")]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    # torchrun writes each rank's output to <log-dir>/<run>/attempt_0/<rank>/stdout.log
    logs = {int(f.parent.name): f.read_text().splitlines()
            for f in (tmp_path / "logs").rglob("stdout.log")}
    assert proc.returncode == 0, proc.stderr[-3000:] + str(logs)
    assert sorted(logs) == [0, 1]
    for rank, lines in logs.items():
        assert lines[0] == f"distributed: process {rank}/2"
    results = [json.loads(lines[-1]) for lines in logs.values()]
    assert results[0]["loss"] == results[1]["loss"] and np.isfinite(results[0]["loss"])
    ckpt = tmp_path / "checkpoints" / "synthetic2_disentangled"
    assert sorted(os.listdir(ckpt)) == ["ckpt_0.pt"]
    assert sorted(os.listdir(tmp_path / "profile")) == ["trace_rank0.json", "trace_rank1.json"]
    for rank in (0, 1):
        trace = json.loads((tmp_path / "profile" / f"trace_rank{rank}.json").read_text())
        assert sum(e.get("name") == "train_epoch" for e in trace["traceEvents"]) == 1
