"""The mesh's model axis in the port (``parallel.hints``, ``parallel.
tensor_parallel``, the node-sharded convs, E2E and adjacency head, the
Trainer and ``--tp``) in gloo ranks (``tests/torch_dist_workers.py``), at
small widths in float64 on an uneven N = 10 (over 4 ranks: 3, 3, 3, 1; over
2: 5, 5).

  * Each sharded op on the 2x2 and the 1x4 mesh: the third- and
    fourth-order motif convs (also with ``block_rows``, whose blocks run
    short inside a rank's rows), E2E's conv, Toeplitz and separable
    lowerings and the adjacency head, equal to the unsharded port at 1e-10
    (outputs, and the gradients summed over the ranks) and to JAX at 1e-8.
  * The ``shard_nodes`` reports show the ``sgc.*``, ``sgc3d.*``, ``e2e.*``
    and ``dec.*`` sites holding a part of the node axis, as
    ``tests/test_node_sharding.py`` asserts for JAX.
  * One train step at meshes (1, 4) and (2, 2), the small parameters
    sharded too (min_size 64), equal to the single-process step at 1e-10 for
    the disentangled and joint models, with and without remat, the separable
    head, ``block_rows``, the weighted BCE and corrected mode's
    ``BatchStatNorm``; and equal to JAX's step under ``make_mesh(1, 4)`` /
    ``(2, 2)`` on the 8 virtual devices at 1e-8.
  * At m = 4 the parameter and Adam bytes per rank at synthetic2's widths
    fall below half of one process's (JAX ``tests/test_mesh_memory.py``).
  * The Trainer on the 1x2 mesh at synthetic2's widths writes each
    checkpoint once, whole, which one process resumes bit for bit, and
    resumes one process's checkpoint; the CLI's ``--tp 2 --distributed``
    under ``torchrun``.
  * The K1 window (``fused_motif_level3`` with ``row0``) on the CPU equals
    the rows of the full launch, and its gradients the rows' gradients; the
    E2E auto rule takes the conv lowering under an ambient mesh, as JAX's.
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
import torch.distributed as dist
from flax.traverse_util import flatten_dict, unflatten_dict
from torch_parity import configs, random_params, setup_models
from torch_parity import exact_f64, one_thread  # noqa: F401  (fixtures)
from torch_dist_workers import one_step, run_many, state_bytes, tp_op

from snd_vae_tpu import nn as jops
from snd_vae_tpu import train as jtrain
from snd_vae_tpu.compat.lockstep import _make_jax_lockstep_step, make_noise_stream
from snd_vae_tpu.data.graphbatch import from_numpy as jax_batch
from snd_vae_tpu.parallel import make_mesh as jax_make_mesh
from snd_vae_tpu.parallel import shard_graphbatch as jax_shard_graphbatch
from snd_vae_tpu_torch.checkpoint import Checkpointer, checkpoint_dir, checkpoint_payload
from snd_vae_tpu_torch.data.loaders import load_dataset
from snd_vae_tpu_torch.nn import E2E
from snd_vae_tpu_torch.nn.kernels.motif_level3 import fused_motif_level3, motif_level3
from snd_vae_tpu_torch.parallel import initialize_distributed, make_mesh, use_mesh
from snd_vae_tpu_torch.params import state_dict_from_flax, torch_layout, torch_name
from snd_vae_tpu_torch.train import Trainer

pytestmark = pytest.mark.usefixtures("one_thread")
ROOT = Path(__file__).resolve().parents[1]
N, B, TOL = 10, 4, 1e-10
MESHES = ("1x4", "2x2")


def _with_train(cfg, **kw):
    return cfg.with_(train=dataclasses.replace(cfg.train, **kw))


def _graph(rng, b=2, n=N, f=3, r=1):
    adj = np.triu((rng.random((b, n, n)) < 0.4).astype(np.float64), 1)
    adj = adj + np.swapaxes(adj, 1, 2)
    rel = np.abs(rng.standard_normal((b, n, n, r)))
    return adj, rng.standard_normal((b, n, f)), (rel + np.swapaxes(rel, 1, 2)) / 2


def _ops():
    rng = np.random.default_rng(0)
    adj, x, rel = _graph(rng)
    g = lambda *s: rng.standard_normal(s)
    head_cfg = configs("small", num_nodes=N)[1]
    ops = {
        "sgc3": dict(kind="sgc3", F=3, R=1, hidden=(4, 5, 6), inputs=(adj, x, rel), g=g(2, N, 6)),
        "sgc3_blocked": dict(kind="sgc3", F=3, R=1, hidden=(4, 5, 6), block_rows=2,
                             inputs=(adj, x, rel), g=g(2, N, 6)),
        "sgc4": dict(kind="sgc4", F=3, R=1, hidden=(3, 3, 3, 2), inputs=(adj, x, rel),
                     g=g(2, N, 2)),
        "sgc4_blocked": dict(kind="sgc4", F=3, R=1, hidden=(3, 3, 3, 2), block_rows=5,
                             inputs=(adj, x, rel), g=g(2, N, 2)),
        "e2e_conv": dict(kind="e2e", C=3, O=4, k_h=N, inputs=(g(2, N, N, 3),), g=g(2, N, N, 4)),
        "e2e_conv_k5": dict(kind="e2e", C=3, O=4, k_h=5, inputs=(g(2, N, N, 3),),
                            g=g(2, N, N, 4)),
        "e2e_matmul": dict(kind="e2e", C=3, O=4, k_h=N, use_matmul=True,
                           inputs=(g(2, N, N, 3),), g=g(2, N, N, 4)),
        "e2e_sep": dict(kind="e2e_sep", C=5, O=4, k_h=N,
                        inputs=(g(2, N, 2), g(2, N, 2), g(2, N, N, 1)), g=g(2, N, N, 4)),
        "adj_head": dict(kind="adj_head", cfg=head_cfg.with_(parity=False),
                         inputs=(g(2, N, 8), g(2, N, 2)), g=g(2, N, N, 2)),
        "adj_head_factored": dict(
            kind="adj_head", cfg=configs("small", num_nodes=N,
                                         decoder=dict(adj_head_factored=True))[1],
            inputs=(g(2, N, 8), g(2, N, 2)), g=g(2, N, N, 2)),
    }
    return ops


def _step_cases():
    tc = _with_train(configs("small", num_nodes=N)[1], batch_size=B)
    cases = {
        "default": tc,
        "remat": tc.with_(remat=True),
        "factored": tc.with_(decoder=dataclasses.replace(tc.decoder, adj_head_factored=True)),
        "block_rows": tc.with_(motif_block_rows=2),
        "weighted_bce": tc.with_(loss=dataclasses.replace(tc.loss, use_weighted_bce=True)),
        "corrected": tc.with_(parity=False),
        "joint": _with_train(tc.with_(model_type="base"), dropout_keep_prob=0.8),
        "joint_remat": tc.with_(model_type="base", remat=True),
    }
    return {k: {"cfg": c, "arrays": _arrays(c)} for k, c in cases.items()}


def _arrays(cfg):
    data = load_dataset(cfg, "train", num_graphs=B, device="cpu")
    return {k: v.numpy().astype(np.float64) for k, v in vars(data).items() if v is not None}


def _jax_case():
    """The small config at N = 10 with tf1-adam, seeded flax params, the
    global batch and ε (the JAX lockstep stream)."""
    with jax.enable_x64():
        jc, tc, jm, params, _, _ = setup_models("small", np.float64, init=random_params,
                                                num_nodes=N)
    jc, tc = (_with_train(c, batch_size=B, optimizer="tf1-adam") for c in (jc, tc))
    enc = jc.encoder
    eps = make_noise_stream(7, 1, {"s": (B, enc.s_latent_size),
                                   "sg": (B * jc.sampling_num, enc.sg_latent_size),
                                   "g": (B, enc.g_latent_size)})[0]
    flat = {k: np.array(v) for k, v in flatten_dict(params, sep="/").items()}
    return jc, jm, flat, {"cfg": tc, "arrays": _arrays(tc), "eps": eps,
                          "state_dict": state_dict_from_flax(flat)}


def _trainer_cfg():
    """synthetic2's widths (its big parameters shard at the default
    min_size) at B = 2, f32."""
    cfg = _with_train(configs("synthetic2")[1], batch_size=2, checkpoint_every=1)
    return cfg.with_(mesh=dataclasses.replace(cfg.mesh, model=2))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The op cases and the step cases at world 4 and the Trainer at world 2,
    started at once; one process's checkpoint written first for the
    Trainer to resume."""
    ops, cases = _ops(), _step_cases()
    jc, jm, flat, jax_inputs = _jax_case()
    single_wd = tmp_path_factory.mktemp("tp_single")
    tcfg = _trainer_cfg()
    data = load_dataset(tcfg, "train", num_graphs=4, device="cpu")
    one = tcfg.with_(mesh=dataclasses.replace(tcfg.mesh, model=1))
    Trainer(one, data, device="cpu", workdir=str(single_wd)).run(1, verbose=False)
    trainer_dir = tmp_path_factory.mktemp("tp_trainer")
    outs = run_many([
        ("tp_ops", 4, tmp_path_factory.mktemp("tp_ops"), {"ops": ops}),
        ("tp_step", 4, tmp_path_factory.mktemp("tp_step"),
         {"cases": dict(cases, jax=jax_inputs), "min_size": 64,
          "bytes_cfg": configs("synthetic2")[1]}),
        ("tp_trainer", 2, trainer_dir,
         {"cfg": tcfg, "graphs": 4, "single_workdir": str(single_wd)}),
    ], timeout=600)
    return {"ops": ops, "cases": cases, "jax": (jc, jm, flat, jax_inputs),
            "single_wd": single_wd, "trainer_cfg": one, "data": data,
            "op_outs": outs[0], "step_outs": outs[1], "trainer_outs": outs[2],
            "trainer_dir": trainer_dir}


# --------------------------------------------------------------------------
# Ops
# --------------------------------------------------------------------------

def _summed_grads(outs, mesh, name):
    """The ranks' gradients summed over the model axis: each data row of
    the mesh ran the same op, so the sum over every rank is divided by the
    data axis's size."""
    grads = [o[mesh][name]["grads"] for o in outs]
    d = int(mesh.split("x")[0])
    return {k: sum(g[k] for g in grads) / d for k in grads[0]}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("op", list(_ops()))
def test_sharded_op_equals_unsharded(world, op, mesh):
    """Every rank gathers the same whole output, equal to one process's;
    the ranks' gradients (of each one's Σ out·g over its rows) sum to one
    process's."""
    case = world["ops"][op]
    want = tp_op(case)
    for o in world["op_outs"]:
        np.testing.assert_allclose(o[mesh][op]["out"].numpy(), want["out"].numpy(),
                                   rtol=TOL, atol=1e-13)
    got = _summed_grads(world["op_outs"], mesh, op)
    for k, w in want["grads"].items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=TOL,
                                   atol=TOL * float(w.abs().max()) + 1e-14, err_msg=k)


def _jax_op(case, params):
    """JAX's output of an op case with the port's parameters."""
    kind = case["kind"]
    ins = [jnp.asarray(a) for a in case["inputs"]]
    p = {k: jnp.asarray(v.detach().numpy()) for k, v in params.items()}
    if kind == "sgc3":
        return jops.spatial_graph_conv(*ins, p, block_rows=case.get("block_rows"))
    if kind == "sgc4":
        adj, x, rel = ins
        return jops.spatial_graph_conv_3d(adj, x, rel, rel, p,
                                          block_rows=case.get("block_rows"))
    mod = jops.E2E(features=case["O"], k_h=case["k_h"], use_matmul=case.get("use_matmul"))
    v = {"params": {"w1": jnp.transpose(p["w1"], (2, 3, 1, 0)), "biases1": p["biases1"]}}
    if kind == "e2e":
        return mod.apply(v, ins[0])
    return mod.apply(v, factors=tuple(ins))


@pytest.mark.parametrize("op", ["sgc3", "sgc3_blocked", "sgc4", "sgc4_blocked", "e2e_conv",
                                "e2e_conv_k5", "e2e_matmul", "e2e_sep"])
def test_sharded_op_matches_jax(world, op):
    """The 1x4 mesh's gathered output against the JAX function (the same
    parameters) in float64 at 1e-8."""
    from torch_dist_workers import tp_op_module

    case = world["ops"][op]
    _, params = tp_op_module(case)
    with jax.enable_x64():
        want = np.asarray(_jax_op(case, params))
    for o in world["op_outs"]:
        np.testing.assert_allclose(o["1x4"][op]["out"].numpy(), want, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("mesh", MESHES)
def test_shard_nodes_reports_partitioned_sites(world, mesh):
    """Each ``shard_nodes`` site reports this rank's rows, fewer than the
    node axis, under both meshes: the motif convs' (``sgc.*``,
    ``sgc3d.*``), E2E's (``e2e.*``) and the decoder's (``dec.*``), in the ops
    and in a train step of the disentangled model."""
    m = int(mesh.split("x")[1])
    for o in world["op_outs"]:
        seen = dict(o[mesh]["seen"])
        for tag, reports in world_step_seen(world, mesh).items():
            seen.setdefault(tag, []).extend(reports)
        parted = {t for t, reps in seen.items() if all(b - a < n for a, b, n in reps)}
        for family in ("sgc.", "sgc3d.", "e2e.", "dec."):
            assert any(t.startswith(family) for t in parted), (family, sorted(seen))
        for t in ("sgc.rf", "sgc.m2_sum", "sgc3d.phi_r", "sgc3d.m2_sum", "e2e.in", "e2e.out",
                  "e2e.sepP", "e2e.sepD", "e2e.sep", "dec.pair", "dec.logits"):
            assert t in parted, (t, sorted(seen))
        for a, b, n in seen["sgc.rf"]:
            assert b - a == -(-n // m) or b == n


def world_step_seen(world, mesh):
    return world["step_outs"][0][(mesh, "default")]["seen"]


# --------------------------------------------------------------------------
# The train step
# --------------------------------------------------------------------------

def _assert_step_equal(got, want, lr, tol=TOL):
    """As ``tests/test_torch_dp_train.py``: aux values at rtol ``tol``;
    gradients at rtol ``tol`` with an atol of ``tol`` times the largest
    gradient; the updated parameters with an atol of lr/eps times that."""
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


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", list(_step_cases()))
def test_tp_step_equals_single_process_step(world, case, mesh):
    c = world["cases"][case]
    want = one_step(c["cfg"], c["arrays"])
    for o in world["step_outs"]:
        got = o[(mesh, case)]
        assert got["sharded"], "no parameter was sharded"
        _assert_step_equal(got, want, c["cfg"].train.learning_rate)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_tp_step_matches_jax_mesh_step(world, exact_f64, shape):
    """Against JAX's step under ``make_mesh(*shape)`` (the hints on, the
    batch sharded over 'data'), float64, ε given; the JAX step compiled
    without XLA's algsimp (ROADMAP §3)."""
    jc, jm, flat, inputs = world["jax"]
    mesh = jax_make_mesh(*shape)
    jb = jax_shard_graphbatch(jax_batch(**inputs["arrays"], dtype=np.float64), mesh)
    params = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    jeps = [jnp.asarray(inputs["eps"][k], jnp.float64) for k in ("s", "sg", "g")]
    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    args = (params, capture.init(params), jb, *jeps, jnp.asarray(0.0))
    with jax.set_mesh(mesh):
        step = _make_jax_lockstep_step(jc, jm, capture).lower(*args).compile(
            compiler_options={"xla_disable_hlo_passes": "algsimp"})
        _, grads, j_total = step(*args)
    tf1 = jtrain.tf1_adam(jc.train.learning_rate)
    j_new = jax.jit(lambda g, p: optax.apply_updates(p, tf1.update(g, tf1.init(p))[0]))(
        grads, params)
    flat_g, flat_p = flatten_dict(grads, sep="/"), flatten_dict(j_new, sep="/")
    name = "x".join(map(str, shape))
    for o in world["step_outs"]:
        got = o[(name, "jax")]
        np.testing.assert_allclose(got["aux"]["loss"], float(j_total), rtol=1e-8)
        assert len(flat_g) == len(got["grads"])
        for path, g in flat_g.items():
            g = torch_layout(path, np.asarray(g))
            np.testing.assert_allclose(got["grads"][torch_name(path)].numpy(), g, rtol=1e-8,
                                       atol=1e-10 * np.abs(g).max(), err_msg=path)
            np.testing.assert_allclose(got["params"][torch_name(path)].numpy(),
                                       torch_layout(path, np.asarray(flat_p[path])),
                                       rtol=1e-8, atol=1e-12, err_msg=path)


def test_per_rank_parameter_and_adam_bytes_below_half(world):
    """At m = 4 the synthetic2 model's parameters and Adam moments on each
    rank take less than half of one process's bytes (JAX
    ``tests/test_mesh_memory.py:54-56`` asserts the same of its arguments)."""
    single = state_bytes(configs("synthetic2")[1])
    for o in world["step_outs"]:
        assert o["bytes"] < single / 2, (o["bytes"], single)


# --------------------------------------------------------------------------
# The Trainer and the CLI
# --------------------------------------------------------------------------

def _assert_payload_equal(a, b):
    for n, p in a["model"].items():
        assert torch.equal(p, b["model"][n]), n
    assert torch.equal(a["generator"], b["generator"]) and a["step"] == b["step"]
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k, v in sa[i].items():
            assert (torch.equal(v, sb[i][k]) if isinstance(v, torch.Tensor)
                    else v == sb[i][k]), (i, k)


def test_trainer_1x2_writes_whole_checkpoints_and_resumes_in_one_process(world, tmp_path):
    """At synthetic2's widths on the 1x2 mesh (the 8 big parameters
    sharded): both ranks end with the same losses, each checkpoint is
    written once and holds whole tensors, equal bit for bit to the state the
    ranks gather, and one process resumes it bit for bit and trains on to
    the ranks' losses (rtol 1e-5: f32's summation order).  The other way
    round, the ranks resumed one process's checkpoint and trained on to its
    losses."""
    t0, t1 = world["trainer_outs"]
    cfg, data = world["trainer_cfg"], world["data"]
    assert len(t0["sharded"]) == 8
    assert t0["means"] == t1["means"] and np.isfinite(t0["means"]["loss"])
    assert t0["checkpoints"] == t1["checkpoints"] == ["ckpt_0.pt", "ckpt_1.pt"]
    _assert_payload_equal(t0["straight"], t1["straight"])
    # the 1x2 run of 1 epoch under workdir b, resumed in one process
    b_dir = world["trainer_dir"] / "b"
    saved = Checkpointer(checkpoint_dir(cfg, str(b_dir))).load()
    one = Trainer(cfg, data, device="cpu", workdir=str(b_dir))
    assert one.maybe_restore() == 1
    _assert_payload_equal(checkpoint_payload(one.state), saved)
    for n, p in saved["model"].items():
        assert p.shape == dict(one.state.model.named_parameters())[n].shape, n
    means = one.run(2, verbose=False)
    for k, v in t0["means"].items():
        np.testing.assert_allclose(means[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    # one process's checkpoint of epoch 0, resumed on the 1x2 mesh to epoch 1
    single = Trainer(cfg, data, device="cpu", workdir=str(tmp_path)).run(2, verbose=False)
    for k, v in single.items():
        np.testing.assert_allclose(t0["resumed_means"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)


def _write_dataset(root, graphs=20):
    from snd_vae_tpu_torch.data.synthetic import generate_synthetic, save_synthetic_npy

    for split, seed in (("train", 1), ("test", 2)):
        save_synthetic_npy(generate_synthetic(graphs, 25, seed=seed),
                           str(root / "spatial_network_correlated2" / "25" / split))


def test_cli_trains_tensor_parallel_under_torchrun(tmp_path):
    """``torchrun --nproc_per_node 2 -m snd_vae_tpu_torch.cli --type train
    --tp 2 --distributed --device cpu``: both processes join, print the same
    finite loss, and one whole checkpoint is written."""
    _write_dataset(tmp_path / "data")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "--log-dir", str(tmp_path / "logs"), "--redirects", "3",
           "-m", "snd_vae_tpu_torch.cli", "--type", "train", "--epochs", "1",
           "--tp", "2", "--distributed", "--device", "cpu", "--workdir", str(tmp_path),
           "--dataset-path", str(tmp_path / "data")]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
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
    saved = torch.load(ckpt / "ckpt_0.pt", weights_only=True)["model"]
    assert saved["sg_lin1.kernel"].shape == (1250, 100)


# --------------------------------------------------------------------------
# One process: the K1 window and the E2E auto rule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [(0, 3), (3, 3), (9, 1), (0, 10), (4, 6)])
def test_motif_level3_window_equals_rows_of_the_full_launch(rows):
    """``fused_motif_level3`` on the window's rows of φ(rel) and a_i equals
    those rows of the full launch (the plain version on the CPU: the same
    operations on fewer rows, to the last bits of BLAS's blocking), and ``motif_level3``'s window gradients (with a block of 2 inside
    the window) equal the full level 3's gradients of those rows' output."""
    start, n = rows
    rng = np.random.default_rng(3)
    adj, x, rel = _graph(rng, b=2, n=N, f=1, r=2)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    h = 5
    full_in = [t(adj), t(np.maximum(rel, 0.2 * rel)), t(rng.standard_normal((2, N, h))),
               t(rng.standard_normal((2, N, h))), t(adj.sum(-1)),
               t(rng.standard_normal((2, h))), t(rng.standard_normal((2, h))),
               t(rng.standard_normal(h))]
    full = fused_motif_level3(*full_in)
    win = [full_in[0], full_in[1][:, start:start + n].contiguous(),
           full_in[2][:, start:start + n].contiguous(), *full_in[3:]]
    np.testing.assert_allclose(fused_motif_level3(*win, start).numpy(),
                               full[:, start:start + n].numpy(), rtol=1e-13, atol=1e-13)
    g = t(rng.standard_normal((2, n, h)))
    leaves = [a.clone().requires_grad_(True) for a in full_in]
    want = torch.autograd.grad(
        (motif_level3(*leaves)[:, start:start + n] * g).sum(), leaves)
    leaves2 = [a.clone().requires_grad_(True) for a in full_in]
    wl = [leaves2[0], leaves2[1][:, start:start + n].contiguous(),
          leaves2[2][:, start:start + n].contiguous(), *leaves2[3:]]
    got = torch.autograd.grad(
        (motif_level3(*wl, block_rows=2, row0=start) * g).sum(), leaves2)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-13)
    with pytest.raises(ValueError, match="not rows of"):
        fused_motif_level3(*win, N - n + 1)


def test_e2e_auto_rule_takes_the_conv_lowering_under_a_mesh_as_jax_does(tmp_path):
    """At N = 128 (above the 96 of the matmul threshold) the auto rule takes
    the Toeplitz lowering without a mesh and the conv lowering under an
    ambient mesh that names a 'model' axis, in both packages (JAX: the
    traced program holds a conv, or only dot products)."""
    x = np.random.default_rng(0).standard_normal((1, 128, 128, 2)).astype(np.float32)
    mod = jops.E2E(features=3, k_h=128)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    conv_in_jaxpr = lambda: "conv_general_dilated" in str(
        jax.make_jaxpr(lambda t: mod.apply(v, t))(jnp.asarray(x)))
    jax_plain = conv_in_jaxpr()
    with jax.set_mesh(jax_make_mesh(1, 1)):
        jax_mesh = conv_in_jaxpr()
    assert (jax_plain, jax_mesh) == (False, True)

    port = E2E(2, 3, 128, torch.Generator().manual_seed(0))
    xt = torch.from_numpy(x)
    initialize_distributed(f"file://{tmp_path}/rdv", 1, 0, "cpu")
    try:
        assert port.uses_matmul(xt)
        with use_mesh(make_mesh(1, 1, "cpu")):
            assert not port.uses_matmul(xt)
    finally:
        dist.destroy_process_group()
