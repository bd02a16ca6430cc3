"""The port's training slice (``snd_vae_tpu_torch.train``, ``.checkpoint``,
the CLI's ``--type train``) against the JAX package on the same seeded
numpy inputs: the optimizers at rtol 1e-12, one step's loss and gradients
in float64 at rtol 1e-8, a 3-epoch f32 lockstep at full synthetic2 width
within the 2e-3 relative cost gap, a bf16 step against JAX's compute cast;
and the trainer's epoch loop, logs, checkpoints and bit-exact resume."""

import dataclasses
import functools
import json
import signal
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from torch_parity import configs, init_like, random_params
from torch_parity import exact_f64, jax_native, one_thread  # noqa: F401  (fixtures)

import snd_vae_tpu.data.spanning_tree as jax_spanning_tree
from snd_vae_tpu import train as jtrain
from snd_vae_tpu.compat.lockstep import (
    _make_jax_lockstep_step, make_noise_stream, run_jax_trajectory,
)
from snd_vae_tpu.data.graphbatch import from_numpy as jax_batch
from snd_vae_tpu.losses import elbo_loss as jax_elbo_loss
from snd_vae_tpu.models import DisentangledSNDVAE as JaxModel
from snd_vae_tpu.models import build_model as jax_build_model
from snd_vae_tpu.models.outputs import Latents as JaxLatents
from snd_vae_tpu.models.outputs import ModelOutput as JaxModelOutput
from snd_vae_tpu.utils.logging import LossesLogger as JaxLossesLogger
from snd_vae_tpu_torch import cli, serve
from snd_vae_tpu_torch import config as tcfg
from snd_vae_tpu_torch import train as ttrain
from snd_vae_tpu_torch.checkpoint import Checkpointer
from snd_vae_tpu_torch.data.graphbatch import from_numpy as torch_batch
from snd_vae_tpu_torch.data.loaders import load_dataset
from snd_vae_tpu_torch.data.synthetic import generate_synthetic
from snd_vae_tpu_torch.models import Latents, build_model
from snd_vae_tpu_torch.nn.kernels import adj_matmul as am
from snd_vae_tpu_torch.nn.kernels import motif_level3 as ml
from snd_vae_tpu_torch.params import state_dict_from_flax, torch_layout, torch_name
from snd_vae_tpu_torch.serve import reconstruct
from snd_vae_tpu_torch.utils.logging import LossesLogger

pytestmark = pytest.mark.usefixtures("one_thread")
AUX_KEYS = ["adj_loss", "node_loss", "spatial_loss", "sg_kl", "spatial_kl", "graph_kl",
            "loss", "mse_loss", "adj_acc"]


def _with_train(cfg, **kw):
    return cfg.with_(train=dataclasses.replace(cfg.train, **kw))


# --------------------------------------------------------------------------
# Optimizers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adam", "tf1-adam"])
def test_optimizer_matches_jax(name, rng):
    """Five updates of seeded float64 gradients, some near eps (where the
    two Adam formulations differ), against optax.adam / tf1_adam."""
    lr, shapes = 1e-2, [(3, 4), (5,), (2, 2, 3)]
    p0 = [rng.standard_normal(s) for s in shapes]
    grads = [[rng.standard_normal(s) * 10.0 ** rng.integers(-9, 1, s) for s in shapes]
             for _ in range(5)]
    with jax.enable_x64():
        opt = (jtrain.tf1_adam(lr) if name == "tf1-adam"
               else optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8))
        params = [jnp.asarray(p) for p in p0]
        state = opt.init(params)
        for g in grads:
            upd, state = opt.update([jnp.asarray(x) for x in g], state, params)
            params = optax.apply_updates(params, upd)
    tp = [torch.tensor(p, requires_grad=True) for p in p0]
    cfg = _with_train(tcfg.synthetic2_preset(), optimizer=name, learning_rate=lr)
    topt = ttrain.make_optimizer(cfg, tp)
    assert isinstance(topt, ttrain.TF1Adam if name == "tf1-adam" else ttrain.Adam)
    for g in grads:
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        topt.step()
    for got, want in zip(tp, params):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-12, atol=0)


def test_unknown_optimizer_raises():
    cfg = _with_train(tcfg.synthetic2_preset(), optimizer="sgd")
    with pytest.raises(ValueError, match="sgd"):
        ttrain.make_optimizer(cfg, [torch.zeros(2, requires_grad=True)])


# --------------------------------------------------------------------------
# The step against the JAX package
# --------------------------------------------------------------------------

def _setup(case, num_graphs, np_dtype, init, optimizer="tf1-adam", compute_dtype="float32"):
    """The train split of ``case`` as numpy arrays, the same flax params for
    the JAX model and the port model (``state_dict_from_flax``), and the
    port's TrainState, all in ``np_dtype``."""
    jc, tc = configs(case)
    jc = _with_train(jc, optimizer=optimizer).with_(compute_dtype=compute_dtype)
    tc = _with_train(tc, optimizer=optimizer).with_(compute_dtype=compute_dtype)
    data = load_dataset(tc, "train", num_graphs=num_graphs, device="cpu")
    arrays = {k: v.numpy().astype(np_dtype) for k, v in vars(data).items() if v is not None}
    jm = jax_build_model(jc.with_(compute_dtype="float32"))
    small = {k: v[:2] for k, v in arrays.items()}
    with jax.enable_x64(False):   # the f32 init the JAX package runs, traced only
        shapes = jax.eval_shape(lambda k: jm.init(k, jax_batch(**small), key=k),
                                jax.random.PRNGKey(0))["params"]
    flat = {k: v.astype(np_dtype) for k, v in init(shapes, np.random.default_rng(1)).items()}
    model = build_model(tc.with_(compute_dtype="float32"), device="cpu")
    model = model.to(torch.from_numpy(np.zeros(0, np_dtype)).dtype)
    result = model.load_state_dict(state_dict_from_flax(flat))
    assert not result.missing_keys and not result.unexpected_keys
    state = ttrain.TrainState(cfg=tc, model=model,
                              optimizer=ttrain.make_optimizer(tc, model.parameters()),
                              generator=torch.Generator().manual_seed(0))
    params = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    return jc, jm, params, arrays, state


def _noise(jc, steps, seed=7):
    B, S, enc = jc.train.batch_size, jc.sampling_num, jc.encoder
    return make_noise_stream(seed, steps, {"s": (B, enc.s_latent_size),
                                           "sg": (B * S, enc.sg_latent_size),
                                           "g": (B, enc.g_latent_size)})


def _eps(noise, dtype=torch.float32):
    t = lambda k: torch.from_numpy(noise[k]).to(dtype)
    return Latents(z_sg=t("sg"), z_s=t("s"), z_g=t("g"))


def _batch(arrays, lo, hi, dtype):
    return torch_batch(**{k: v[lo:hi] for k, v in arrays.items()}, dtype=dtype)


def test_one_step_matches_jax_f64(exact_f64):
    """The small config, one step in float64: the loss, every gradient and
    every updated parameter against the JAX lockstep step (tf1-adam).

    The JAX step is compiled without XLA's algebraic simplifier
    (``algsimp``): with it, XLA for the CPU computes this config's sg-branch
    gradient wrongly (sg_convs_1's bias1 3-33% off the op-by-op gradient,
    which equals central finite differences of the JAX loss); at full
    synthetic2 width the two agree."""
    jc, jm, params, arrays, state = _setup("small", 10, np.float64, random_params)
    B = jc.train.batch_size
    eps = _noise(jc, 1)[0]
    jb = jax_batch(**{k: v[:B] for k, v in arrays.items()}, dtype=np.float64)
    jeps = [jnp.asarray(eps[k], jnp.float64) for k in ("s", "sg", "g")]
    # an "optimizer" whose state is the gradient tree: the step returns it
    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    args = (params, capture.init(params), jb, *jeps, jnp.asarray(0.0))
    step = _make_jax_lockstep_step(jc, jm, capture).lower(*args).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})
    _, grads, j_total = step(*args)
    tf1 = jtrain.tf1_adam(jc.train.learning_rate)
    j_new = jax.jit(lambda g, p: optax.apply_updates(     # the lockstep step's update
        p, tf1.update(g, tf1.init(p))[0]))(grads, params)

    aux = ttrain.train_step(state, _batch(arrays, 0, B, torch.float64),
                            torch.tensor(0.0, dtype=torch.float64),
                            eps=_eps(eps, torch.float64))
    np.testing.assert_allclose(aux["loss"].item(), float(j_total), rtol=1e-8)
    named = dict(state.model.named_parameters())
    flat_g, flat_p = flatten_dict(grads, sep="/"), flatten_dict(j_new, sep="/")
    assert len(flat_g) == len(named)
    for path, g in flat_g.items():
        p = named[torch_name(path)]
        g = torch_layout(path, np.asarray(g))
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-8,
                                   atol=1e-10 * np.abs(g).max(), err_msg=path)
        np.testing.assert_allclose(p.detach().numpy(),
                                   torch_layout(path, np.asarray(flat_p[path])),
                                   rtol=1e-8, atol=1e-12, err_msg=path)
    assert state.step == 1


def test_lockstep_synthetic2_f32():
    """Full synthetic2 width in f32: 20 graphs (2 batches), 3 epochs,
    tf1-adam, the same weights and noise stream as the JAX trajectory;
    every step's cost within 2e-3 relative."""
    epochs = 3
    jc, _, params, arrays, state = _setup("synthetic2", 20, np.float32, init_like)
    B, nb = jc.train.batch_size, 2
    noise = _noise(jc, epochs * nb)
    want = run_jax_trajectory(jc, params, jax_batch(**arrays), epochs, noise)
    got = np.zeros_like(want)
    for epoch in range(epochs):
        for i in range(nb):
            aux = ttrain.train_step(state, _batch(arrays, i * B, (i + 1) * B, torch.float32),
                                    torch.tensor(float(epoch)),
                                    eps=_eps(noise[epoch * nb + i]))
            got[epoch, i] = aux["loss"].item()
    gap = np.abs(got - want) / np.abs(want)
    assert gap.max() < 2e-3, (got, want)
    assert abs(want[-1].mean() - want[0].mean()) > 1e-3   # the trajectory moves


def test_bf16_step(monkeypatch):
    """compute_dtype bfloat16: the kernel wrappers receive bf16, the masters
    and their gradients stay f32 (the Matrix1 slices' too), the loss is f32
    and within 2e-2 relative of JAX's ``_compute_cast`` loss on the same
    params and noise."""
    jc, jm, params, arrays, state = _setup("small", 10, np.float32, random_params,
                                           compute_dtype="bfloat16")
    seen = []
    for mod, name in ((ml, "fused_motif_level3"), (am, "blocked_adj_matmul")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name: (
            seen.append((_n, {t.dtype for t in a if isinstance(t, torch.Tensor)})), _fn(*a))[1])
    B = jc.train.batch_size
    eps = _noise(jc, 1)[0]
    aux = ttrain.train_step(state, _batch(arrays, 0, B, torch.float32), torch.tensor(0.0),
                            eps=_eps(eps))
    assert sorted(n for n, _ in seen) == ["blocked_adj_matmul"] * 2 + ["fused_motif_level3"] * 2
    assert all(d == {torch.bfloat16} for _, d in seen), seen
    assert aux["loss"].dtype == torch.float32
    for n, p in state.model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
        assert torch.isfinite(p.grad).all(), n
    F, R = jc.num_features, jc.rel_dim
    for conv in state.model.sg_convs:   # rows of M1d and M1f, passed as copies
        g = conv.Matrix1.grad
        assert g[3 * F:3 * F + R].abs().sum() > 0 and g[3 * F + 2 * R:].abs().sum() > 0

    jm_bf = jax_build_model(jc)
    jb = jax_batch(**{k: v[:B] for k, v in arrays.items()})

    @jax.jit
    def jax_loss(params, batch):
        p_c, b_c = jtrain._compute_cast(jc, params, batch)
        stats = jm_bf.apply({"params": p_c}, b_c, method=JaxModel.encode)
        z = lambda m, s, e: m + jnp.asarray(e, m.dtype).reshape(m.shape) * jnp.exp(s)
        lat = JaxLatents(z_sg=z(stats.mean_sg, stats.logstd_sg, eps["sg"]),
                         z_s=z(stats.mean_s, stats.logstd_s, eps["s"]),
                         z_g=z(stats.mean_g, stats.logstd_g, eps["g"]))
        dec = jm_bf.apply({"params": p_c}, lat, method=JaxModel.decode)
        return jax_elbo_loss(jc, JaxModelOutput(stats=stats, latents=lat, decoded=dec),
                             batch.adj, batch.features, batch.coords, 0.0)[0]

    want = float(jax_loss(params, jb))
    assert abs(aux["loss"].item() - want) < 2e-2 * abs(want)


# --------------------------------------------------------------------------
# The trainer
# --------------------------------------------------------------------------

def _small_trainer(tmp_path, num_graphs=20, **train):
    _, tc = configs("small")
    tc = _with_train(tc, checkpoint_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "logs"),
                     **train)
    data = load_dataset(tc, "train", num_graphs=num_graphs, device="cpu")
    return ttrain.Trainer(tc, data, device="cpu", workdir=str(tmp_path))


def test_trainer_overfits_and_logs_like_jax(tmp_path):
    """20 graphs, 2 steps an epoch, 15 epochs at lr 3e-3: the loss falls;
    the log files are the JAX trainer's, line for line in format."""
    tr = _small_trainer(tmp_path, learning_rate=3e-3, checkpoint_every=100)
    last = tr.run(15, verbose=False)
    assert list(last) == AUX_KEYS
    txt = tmp_path / "logs" / "train_loss_synthetic2_disentangled.txt"
    rows = [ln.split(",") for ln in txt.read_text().splitlines()]
    assert rows[0] == ["epoch", "loss", "value"] and len(rows) == 1 + 15 * len(AUX_KEYS)
    loss = [float(v) for e, k, v in rows[1:] if k == "loss"]
    assert np.isfinite(loss).all() and loss[-1] < loss[0], loss
    jsonl = [json.loads(ln) for ln in txt.with_suffix(".jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in jsonl] == list(range(15))
    assert all(list(r) == ["epoch", "time"] + AUX_KEYS for r in jsonl)
    # the same storer through both loggers gives the same text log
    storer = {k: [0.25, 0.5] for k in AUX_KEYS}
    for cls, name in ((LossesLogger, "port.txt"), (JaxLossesLogger, "jax.txt")):
        cls(str(tmp_path / name)).log(3, storer)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    assert sorted(Checkpointer(str(tmp_path / "ckpt" / "synthetic2_disentangled")).steps()) == [0]


@pytest.mark.parametrize("optimizer", ["adam", "tf1-adam"])
def test_resume_is_bit_exact(tmp_path, optimizer):
    """2 epochs straight equal 1 epoch, a restore into a new trainer and 1
    more epoch: every parameter, optimizer state and the ε stream."""
    straight = _small_trainer(tmp_path / "a", checkpoint_every=1, optimizer=optimizer)
    straight.run(2, verbose=False)
    _small_trainer(tmp_path / "b", checkpoint_every=1, optimizer=optimizer).run(1, verbose=False)
    resumed = _small_trainer(tmp_path / "b", checkpoint_every=1, optimizer=optimizer)
    assert resumed.maybe_restore() == 1
    resumed = _small_trainer(tmp_path / "b", checkpoint_every=1, optimizer=optimizer)
    resumed.run(2, verbose=False)
    a, b = straight.state, resumed.state
    assert a.step == b.step == 4
    for (n, p), (_, q) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(p, q), n
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys() and len(sa) == len(list(a.model.parameters()))
    for i in sa:
        for k, v in sa[i].items():
            assert (torch.equal(v, sb[i][k]) if isinstance(v, torch.Tensor)
                    else v == sb[i][k]), (i, k)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_sigterm_checkpoints_and_stops(tmp_path, monkeypatch):
    """SIGTERM during epoch 1 of 5: the trainer finishes that epoch, saves
    its checkpoint and returns; the previous handler is back afterwards."""
    tr = _small_trainer(tmp_path, checkpoint_every=100)
    run_epoch = tr.run_epoch

    def interrupted(epoch):
        if epoch == 1:
            signal.raise_signal(signal.SIGTERM)
        return run_epoch(epoch)

    monkeypatch.setattr(tr, "run_epoch", interrupted)
    before = signal.getsignal(signal.SIGTERM)
    tr.run(5, verbose=False)
    assert tr.checkpointer.steps() == [0, 1] and tr.state.step == 4
    assert signal.getsignal(signal.SIGTERM) is before


def test_resampled_trees_equal_jax(tmp_path, jax_native):
    """resample_trees_every = 2: at epoch 3 the trainer holds the boundary-2
    draw, the JAX trainer's bit for bit, each with its default sampler (the
    native library; JAX's built privately for the test)."""
    _assert_resampled_trees_equal_jax(tmp_path)


def test_resampled_trees_equal_jax_numpy_route(tmp_path, jax_native, monkeypatch):
    """The same with ``use_native=False`` on both sides (numpy Kruskal)."""
    monkeypatch.setattr(ttrain, "sample_spanning_trees", functools.partial(
        ttrain.sample_spanning_trees, use_native=False))
    monkeypatch.setattr(jax_spanning_tree, "sample_spanning_trees", functools.partial(
        jax_spanning_tree.sample_spanning_trees, use_native=False))
    _assert_resampled_trees_equal_jax(tmp_path)


def _assert_resampled_trees_equal_jax(tmp_path):
    tr = _small_trainer(tmp_path, resample_trees_every=2)
    before = tr.data.adj_samples.clone()
    tr._maybe_resample_trees(3)
    jc, _ = configs("small")
    jc = _with_train(jc, resample_trees_every=2)
    arrays = {k: v.numpy() for k, v in vars(load_dataset(tr.cfg, "train", num_graphs=20,
                                                          device="cpu")).items()
              if v is not None}
    ns = types.SimpleNamespace(cfg=jc, data=jax_batch(**arrays), _tree_boundary=0, mesh=None)
    jtrain.Trainer._maybe_resample_trees(ns, 3)
    assert ns._tree_boundary == tr._tree_boundary == 2
    np.testing.assert_array_equal(tr.data.adj_samples.numpy(), np.asarray(ns.data.adj_samples))
    assert not torch.equal(before, tr.data.adj_samples)
    assert torch.equal(tr.batched.adj_samples[1], tr.data.adj_samples[10:20])


def test_reshuffle_permutes_and_is_off_in_parity_mode(tmp_path):
    tr = _small_trainer(tmp_path)
    assert ttrain._maybe_reshuffle(tr.state, tr.batched) is tr.batched
    tr = _small_trainer(tmp_path, reshuffle=True)
    out = ttrain._maybe_reshuffle(tr.state, tr.batched)
    flat = lambda t: t.reshape((20,) + t.shape[2:])
    # each graph of the result is one graph of the input, every field moved with it
    key = lambda b: flat(b.coords).reshape(20, -1)
    perm = [int(torch.nonzero((key(tr.batched) == row).all(1))[0]) for row in key(out)]
    assert sorted(perm) == list(range(20)) and perm != list(range(20))
    for name in ("adj", "features", "rel", "adj_samples"):
        assert torch.equal(flat(getattr(out, name)), flat(getattr(tr.batched, name))[perm])


@pytest.mark.parametrize("over", [dict(mesh=dict(model=2))])
def test_unported_trainer_options_raise(tmp_path, over):
    """The mesh's model axis, which raised before it was ported: in one
    process the Trainer asks for the process group it needs, and over two
    gloo processes (``tests/torch_dist_workers.py``) a config with
    ``mesh.model = 2`` trains 2 epochs to the losses of one process (rtol
    1e-5: f32's summation order), both ranks alike, and both model ranks
    score the held-out split each epoch, whose scores rank 0 logs equal
    to one process's (tests/test_torch_tp.py holds the rest)."""
    from torch_dist_workers import run_many

    _, tc = configs("small")
    tc = tc.with_(train=dataclasses.replace(tc.train, batch_size=5, eval_every=1),
                  mesh=tcfg.MeshConfig(**over["mesh"]))
    data = load_dataset(tc, "train", num_graphs=10, device="cpu")
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        ttrain.Trainer(tc, data, device="cpu", workdir=str(tmp_path))
    (outs,) = run_many([("tp_trainer", 2, tmp_path / "tp",
                         {"cfg": tc, "graphs": 10, "eval_graphs": 5})])
    assert outs[0]["means"] == outs[1]["means"]
    assert outs[0]["evaluates"] and outs[1]["evaluates"]
    one = tc.with_(mesh=tcfg.MeshConfig())
    held = load_dataset(tc, "test", num_graphs=5, device="cpu")
    single = ttrain.Trainer(one, data, device="cpu", workdir=str(tmp_path / "one"),
                            eval_batch=held).run(2, verbose=False)
    for k, v in single.items():
        np.testing.assert_allclose(outs[0]["means"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    val = lambda wd: [line.split(",") for line in (
        tmp_path / wd / tc.train.log_dir /
        f"val_loss_{tc.dataset}_{tc.model_type}.txt").read_text().splitlines()[1:]]
    got, want = val("tp/a"), val("one")
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        # the scores of weights that differ in f32's last bits: the edge AUC /
        # AP of a barely trained model move by ~1e-4 where two scores tie
        assert g[:2] == w[:2]
        np.testing.assert_allclose(float(g[2]), float(w[2]), rtol=1e-3, atol=1e-6,
                                   err_msg=g[1])


def test_trainer_with_eval_every_scores_the_heldout_split(tmp_path):
    """eval_every, which raised before it was ported: 20 held-out graphs
    scored at epochs 5 and 10 of a 12-epoch run (the JAX cadence, epoch 0
    skipped), the val log and the best checkpoint written; without an
    eval_batch nothing is scored (tests/test_torch_eval_train.py holds the
    rest)."""
    _, tc = configs("small")
    tc = _with_train(tc, eval_every=5, learning_rate=3e-3)
    data = load_dataset(tc, "train", num_graphs=20, device="cpu")
    held = load_dataset(tc, "test", num_graphs=20, device="cpu")
    tr = ttrain.Trainer(tc, data, device="cpu", workdir=str(tmp_path), eval_batch=held)
    tr.run(12, verbose=False)
    rows = (tmp_path / "logs" / "val_loss_synthetic2_disentangled.txt").read_text().splitlines()
    assert sorted({r.split(",")[0] for r in rows[1:]}) == ["10", "5"]
    assert {r.split(",")[1] for r in rows[1:]} >= {"val_edge_auc", "val_edge_f1",
                                                   "val_spatial_mse"}
    best = json.loads((tmp_path / "checkpoints" / "synthetic2_disentangled_best"
                       / "best.json").read_text())
    assert best["epoch"] in (5, 10) and best["metric"] == "edge_auc"
    tr = ttrain.Trainer(tc, data, device="cpu", workdir=str(tmp_path / "none"))
    assert tr.best_checkpointer is None
    tr.run(6, verbose=False)
    assert not (tmp_path / "none" / "logs" / "val_loss_synthetic2_disentangled.txt").exists()


def test_entry_points_run_in_full_f32(tmp_path, monkeypatch):
    """The CLI, the Trainer and the serving functions turn TF32 off for the
    card's f32 matmuls and convolutions."""
    _, tc = configs("small")
    model = build_model(tc, device="cpu")
    batch = load_dataset(tc, "test", num_graphs=2, device="cpu")
    for run in (lambda: cli.main(["--type", "sample", "--device", "cpu", "--num-generate",
                                  "2", "--workdir", str(tmp_path)]),
                lambda: _small_trainer(tmp_path),
                lambda: serve.reconstruct(model, batch),
                lambda: serve.sample(model, 2, torch.Generator().manual_seed(0))):
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
        run()
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32


def _write_dataset(root, graphs=20):
    """A small synthetic2 dataset in the reference's on-disk layout, which
    the loader reads in place of the generated 200-graph splits."""
    for split, seed in (("train", 1), ("test", 2)):
        d = root / "spatial_network_correlated2" / "25" / split
        d.mkdir(parents=True)
        data = generate_synthetic(graphs, 25, seed=seed)
        for name in ("adj", "node", "geometry", "rel", "prop"):
            np.save(d / f"2D_{name}.npy", data[name])


def test_cli_trains_then_serves_the_checkpoint(tmp_path, capsys):
    """--type train --epochs 1 on the CPU writes a checkpoint; then
    --type test_reconstruct restores it (no WARNING) and writes that
    model's reconstruction."""
    _write_dataset(tmp_path / "data")
    common = ["--device", "cpu", "--workdir", str(tmp_path),
              "--dataset-path", str(tmp_path / "data")]
    out = cli.main(["--type", "train", "--epochs", "1", *common])
    assert list(out) == AUX_KEYS + ["device"] and np.isfinite(out["loss"])
    ck = Checkpointer(str(tmp_path / "checkpoints" / "synthetic2_disentangled"))
    assert ck.latest_step() == 0
    capsys.readouterr()
    rec = cli.main(["--type", "test_reconstruct", *common])
    assert "WARNING" not in capsys.readouterr().err
    assert rec["num_reconstructed"] == 20
    cfg = tcfg.synthetic2_preset(dataset_path=str(tmp_path / "data"))
    model = build_model(cfg, device="cpu")
    seed_weights = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(ck.load()["model"])
    assert any(not torch.equal(v, seed_weights[k]) for k, v in model.state_dict().items())
    want = reconstruct(model, load_dataset(cfg, "test", device="cpu").slice_batch(0, 10))
    got = {n: np.load(tmp_path / rec["dir"] / f"{n}.npy") for n in ("adj", "coords")}
    np.testing.assert_array_equal(got["adj"][:10], want.decoded.adj.float().numpy())
    np.testing.assert_array_equal(got["coords"][:10], want.decoded.coords.numpy())
