"""Held-out evaluation in the port's Trainer and the evaluation CLI types:

  * ``Trainer.evaluate_heldout`` on the same weights (carried over by
    ``params.py``) against the JAX Trainer's, in float64;
  * ``eval_every``: the val log, the best checkpoint (one file) and
    ``best.json``, a resumed run comparing against the best of the runs
    before it, a missing ``best_metric`` skipped, one host sync;
  * the CLI with ``--device cpu`` at a small config: train with
    ``--eval-every``, then test_reconstruct, test_generation,
    test_disentangle (three modes, and the joint model) and sweep, each
    printing the JAX CLI's keys and writing the JAX CLI's figures
    (``figures/reconstruct_<ds>.png``, ``latent_<ds>.png``,
    ``traverse_<ds>.png``, whose path test_disentangle returns), and
    ``--profile``'s trace of the second epoch."""

import dataclasses
import json
import struct
import types

import numpy as np
import pytest
import torch
from torch_parity import exact_f64, one_thread  # noqa: F401  (fixtures)
from torch_parity import configs, random_params, setup_models

import snd_vae_tpu.evaluate as jev
from snd_vae_tpu import train as jtrain
from snd_vae_tpu.data.graphbatch import from_numpy as jax_batch
from snd_vae_tpu_torch import cli
from snd_vae_tpu_torch import config as tcfg
from snd_vae_tpu_torch import train as ttrain
from snd_vae_tpu_torch.checkpoint import Checkpointer
from snd_vae_tpu_torch.data.graphbatch import from_numpy as torch_batch
from snd_vae_tpu_torch.data.loaders import load_dataset
from snd_vae_tpu_torch.models import traversal as ttrav

pytestmark = pytest.mark.usefixtures("one_thread")


def _small(**train):
    _, tc = configs("small")
    return tc.with_(train=dataclasses.replace(tc.train, **train))


def _trainer(tmp_path, eval_graphs=20, **train):
    cfg = _small(**train)
    return ttrain.Trainer(cfg, load_dataset(cfg, "train", num_graphs=20, device="cpu"),
                          device="cpu", workdir=str(tmp_path),
                          eval_batch=load_dataset(cfg, "test", num_graphs=eval_graphs,
                                                  device="cpu"))


@pytest.mark.parametrize("dataset,model_type", [("synthetic2", "disentangled"),
                                                ("synthetic2", "base"), ("scene", "base")])
def test_evaluate_heldout_matches_jax_f64(exact_f64, tmp_path, dataset, model_type):
    """20 held-out graphs in two slices of 10, float64: every metric of the
    port's Trainer against the JAX Trainer's ``evaluate_heldout`` at rtol
    1e-10 (scene: node and relation accuracy)."""
    jc, tc, jm, params, tm, arrays = setup_models(
        "small", np.float64, dataset, num_graphs=20, init=random_params, model_type=model_type)
    ns = types.SimpleNamespace(cfg=jc, model=jm, state=types.SimpleNamespace(params=params),
                               eval_batch=jax_batch(**arrays, dtype=np.float64), _eval_step=None)
    want = jtrain.Trainer.evaluate_heldout(ns)
    tr = ttrain.Trainer(tc, load_dataset(tc, "train", num_graphs=10, device="cpu"),
                        device="cpu", workdir=str(tmp_path),
                        eval_batch=torch_batch(**arrays, dtype=torch.float64))
    tr.state.model = tm
    got = tr.evaluate_heldout()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-10, atol=1e-12, err_msg=k)
    assert ("node_acc" in got) == (dataset == "scene")


def test_eval_every_keeps_the_best_checkpoint_across_resume(tmp_path, monkeypatch):
    """Scores fed to the Trainer in turn: epochs 1-2 of the first run score
    0.6, 0.9 (best: epoch 2); the resumed run's 0.7, 0.8 keep it, its 0.95 at
    epoch 5 replaces it.  One checkpoint file in the best directory; the
    val log holds every evaluation."""
    scores = iter([0.6, 0.9, 0.7, 0.8, 0.95])
    monkeypatch.setattr(ttrain.Trainer, "evaluate_heldout",
                        lambda self: {"edge_auc": next(scores), "spatial_mse": 0.1})
    best = tmp_path / "checkpoints" / "synthetic2_disentangled_best"
    tr = _trainer(tmp_path, eval_every=1, checkpoint_every=1)
    tr.run(3, verbose=False)
    assert json.loads((best / "best.json").read_text()) == {
        "epoch": 2, "metric": "edge_auc", "value": 0.9, "raw": 0.9}
    assert Checkpointer(str(best)).steps() == [2]
    tr = _trainer(tmp_path, eval_every=1, checkpoint_every=1)
    assert tr.maybe_restore() == 3 and tr._best_value == 0.9
    tr.run(5, verbose=False)
    assert Checkpointer(str(best)).steps() == [2]
    tr.run(6, verbose=False)
    assert json.loads((best / "best.json").read_text())["epoch"] == 5
    assert Checkpointer(str(best)).steps() == [5]
    rows = (tmp_path / "logs" / "val_loss_synthetic2_disentangled.txt").read_text().splitlines()
    assert rows[0] == "epoch,loss,value" and "5,val_edge_auc,0.95" in rows
    # the best checkpoint holds the weights of its epoch
    assert torch.equal(Checkpointer(str(best)).load()["model"]["d_e_lin2.kernel"],
                       tr.state.model.d_e_lin2.kernel)


def test_eval_every_scores_on_the_cadence_and_minimizes(tmp_path):
    """eval_every=2 evaluates at epochs 2 and 4 (not 0), and a leading '-'
    minimizes: best.json holds -spatial_mse."""
    tr = _trainer(tmp_path, eval_every=2, best_metric="-spatial_mse")
    seen = []
    score = tr.evaluate_heldout
    tr.evaluate_heldout = lambda: seen.append(1) or score()
    tr.run(5, verbose=False)
    assert len(seen) == 2
    best = json.loads((tmp_path / "checkpoints" / "synthetic2_disentangled_best"
                       / "best.json").read_text())
    assert best["metric"] == "spatial_mse" and best["value"] == -best["raw"] < 0


def test_missing_best_metric_is_skipped(tmp_path, capsys):
    tr = _trainer(tmp_path, eval_every=1, best_metric="edge_nothing")
    tr.run(2, verbose=True)
    assert "skipping best tracking" in capsys.readouterr().out
    best = tmp_path / "checkpoints" / "synthetic2_disentangled_best"
    assert not (best / "best.json").exists() and Checkpointer(str(best)).steps() == []
    assert (tmp_path / "logs" / "val_loss_synthetic2_disentangled.txt").exists()


def test_evaluate_heldout_fetches_once(tmp_path, monkeypatch):
    """Two slices of the held-out batch, one device-to-host transfer."""
    tr = _trainer(tmp_path, eval_every=1)
    calls = []
    to_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **k: calls.append(1) or to_cpu(t))
    metrics = tr.evaluate_heldout()
    assert len(calls) == 1 and 0.0 <= metrics["edge_auc"] <= 1.0


# --------------------------------------------------------------------------
# The CLI's evaluation types
# --------------------------------------------------------------------------

def _jax_keys(kind, factors=True):
    """The keys the JAX CLI prints for ``kind``, from its own evaluate."""
    rng = np.random.default_rng(0)
    adj = (rng.random((4, 6, 6)) < 0.4).astype(float)
    x, c = rng.random((4, 6, 1)), rng.random((4, 6, 2))
    if kind == "generation":
        return set(jev.generation_evaluation(adj, x, c, adj, x, c))
    keys = set(jev.reconstruct_evaluation(adj, x, c, adj, x, c, adj_scores=rng.random(adj.shape)))
    if factors:
        z = rng.standard_normal((40, 4))
        keys |= set(jev.disentangle_evaluation(z, z, z, rng.standard_normal((40, 3))))
    return keys


@pytest.fixture
def small_cli(tmp_path, monkeypatch):
    """The synthetic2 preset at the small widths (20 graphs a split, batch 10)."""
    _, tc = configs("small")
    monkeypatch.setitem(tcfg.PRESETS, "synthetic2", lambda **kw: tc.with_(
        train=dataclasses.replace(tc.train, batch_size=10), **kw))
    data = tmp_path / "data" / "spatial_network_correlated2" / "25"   # the preset's path
    from snd_vae_tpu_torch.data.synthetic import generate_synthetic

    for split, seed in (("train", 1), ("test", 2)):
        (data / split).mkdir(parents=True)
        arrays = generate_synthetic(20, 8, seed=seed)
        for name in ("adj", "node", "geometry", "rel", "prop"):
            np.save(data / split / f"2D_{name}.npy", arrays[name])
    return tc, ["--device", "cpu", "--workdir", str(tmp_path),
                "--dataset-path", str(tmp_path / "data")]


def test_cli_train_with_eval_then_every_evaluation_type(tmp_path, small_cli, capsys):
    tc, common = small_cli
    out = cli.main(["--type", "train", "--epochs", "3", "--eval-every", "1", *common])
    assert np.isfinite(out["loss"])
    written = json.loads((tmp_path / "logs" / "config_synthetic2_disentangled.json")
                         .read_text())
    assert written["train"]["eval_every"] == 1 and written["num_nodes"] == 8
    assert (tmp_path / "checkpoints" / "synthetic2_disentangled_best" / "best.json").exists()
    capsys.readouterr()

    rec = cli.main(["--type", "test_reconstruct", *common])
    assert "WARNING" not in capsys.readouterr().err
    assert _jax_keys("reconstruct") <= set(rec) and rec["num_reconstructed"] == 20
    assert all(np.isfinite(rec[k]) for k in _jax_keys("reconstruct"))
    gen = cli.main(["--type", "test_generation", *common])
    assert set(gen) == _jax_keys("generation") and all(np.isfinite(list(gen.values())))

    V, enc = tc.visualize_length, tc.encoder
    rows = {"generation": 3, "single": 1,
            "latent": enc.s_latent_size + enc.g_latent_size + enc.sg_latent_size}
    model = cli.restore_for_serving(tc.with_(dataset_path=str(tmp_path / "data")),
                                    str(tmp_path), "cpu")
    figures = tmp_path / "figures"
    assert _png_size(figures / "reconstruct_synthetic2.png") == (1650, 690)
    assert _png_size(figures / "latent_synthetic2.png") == (1440, 450)   # 3 factors
    grid_dir = tmp_path / "traverse" / "synthetic2_disentangled"
    for mode, n in rows.items():
        path = cli.main(["--type", "test_disentangle", "--traverse-mode", mode,
                         "--traverse-group", "g", "--traverse-dim", "1", *common])
        assert capsys.readouterr().out.strip().endswith(path)
        assert path == str(figures / "traverse_synthetic2.png")
        assert _png_size(path) == (int(2.0 * V * 150), int(2.0 * n * 150))
        grid = {k: np.load(grid_dir / f"{k}.npy") for k in ("adj", "node_feat", "coords")}
        assert grid["adj"].shape == (n * V, 8, 8)
        assert grid["coords"].shape == (n * V, 8, 2) and np.isfinite(grid["coords"]).all()
        assert json.loads((grid_dir / "grid.json").read_text())["rows"] == n
    # the last grid (latent) is the decode of the traversal of the saved latents
    z = ttrav.load_saved_latents(tc, str(tmp_path / "qualitative_evaluation"))
    with torch.inference_mode():
        want = model.decode(ttrav.traverse_latent(tc, *z, device="cpu"))
    np.testing.assert_allclose(grid["coords"], want.coords.numpy() * 600, rtol=1e-6)


def test_cli_joint_model_disentangle_and_sweep(tmp_path, small_cli):
    """The joint model sweeps one dimension of its z_sg (V rows); sweep
    trains, then prints the JAX sweep's two dicts."""
    tc, common = small_cli
    out = cli.main(["--type", "sweep", "--epochs", "1", "--model-type", "base", *common])
    assert list(out) == ["generation", "reconstruct"]
    assert set(out["generation"]["base"]) == _jax_keys("generation")
    assert set(out["reconstruct"]["base"]) == _jax_keys("reconstruct", factors=False)
    path = cli.main(["--type", "test_disentangle", "--model-type", "base", "--traverse-dim",
                     "2", *common])
    adj = np.load(tmp_path / "traverse" / "synthetic2_base" / "adj.npy")
    assert adj.shape == (tc.visualize_length, 8, 8)
    assert path == str(tmp_path / "figures" / "traverse_synthetic2.png")
    assert _png_size(path) == (int(2.0 * tc.visualize_length * 150), 300)
    # the joint model has no z_s: test_reconstruct draws no latent figure
    assert not (tmp_path / "figures" / "latent_synthetic2.png").exists()
    assert (tmp_path / "figures" / "reconstruct_synthetic2.png").exists()


@pytest.mark.parametrize("epochs,traced", [(3, 1), (1, 0)])
def test_cli_profile_traces_the_second_epoch(tmp_path, small_cli, monkeypatch, epochs, traced):
    """``--profile``: a Chrome trace of epoch 1 alone (epoch 0 when one
    epoch is asked for) at ``<workdir>/profile/trace_rank0.json``, holding
    one ``train_epoch`` range over that epoch's 2 steps."""
    _, common = small_cli
    under_profiler = []
    run_epoch = ttrain.Trainer.run_epoch

    def recording(self, epoch):
        if torch.autograd.profiler._is_profiler_enabled:
            under_profiler.append(epoch)
        return run_epoch(self, epoch)

    monkeypatch.setattr(ttrain.Trainer, "run_epoch", recording)
    out = cli.main(["--type", "train", "--epochs", str(epochs), "--profile", *common])
    assert np.isfinite(out["loss"]) and under_profiler == [traced]
    trace = json.loads((tmp_path / "profile" / "trace_rank0.json").read_text())
    names = [e.get("name") for e in trace["traceEvents"]]
    assert names.count("train_epoch") == 1 and names.count("train_step.forward") == 2
    assert sorted(p.name for p in (tmp_path / "profile").iterdir()) == [
        "trace_rank0.json", "trace_rank0.launches.json"]
    assert json.loads((tmp_path / "profile" / "trace_rank0.launches.json").read_text()) == {
        "host_launches": 0, "launches_without_device_record": 0}


@pytest.mark.parametrize("model_type", ["disentangled", "base"])
def test_profiled_run_equals_an_untraced_one(tmp_path, model_type):
    """Tracing moves no training: 3 epochs with ``profile_dir`` (epoch 1
    traced, after the profiler's discarded warm-up) give every epoch's
    losses, every parameter, the Adam moments and the generator of ε and
    dropout (the joint model at keep 0.8) bit for bit as 3 epochs without;
    ``_profiled_epoch`` returns the trace's kernel launches and those
    without a device record, (0, 0) on the CPU, and ``run`` writes them
    beside the trace."""
    cfg = _small(dropout_keep_prob=0.8).with_(model_type=model_type)
    data = load_dataset(cfg, "train", num_graphs=20, device="cpu")
    runs = {}
    for name, profile_dir in (("traced", str(tmp_path / "traced" / "profile")),
                              ("untraced", None)):
        tr = ttrain.Trainer(cfg, data, device="cpu", workdir=str(tmp_path / name))
        tr.run(3, verbose=False, profile_dir=profile_dir)
        with open(tr.logger.jsonl_path) as f:     # each epoch's means, its clock aside
            runs[name] = ([dict(json.loads(line), time=None) for line in f], tr.state)
    (logs, state), (want_logs, want) = runs["traced"], runs["untraced"]
    assert logs == want_logs and len(logs) == 3
    for (n, p), q in zip(state.model.named_parameters(), want.model.parameters()):
        assert torch.equal(p, q), n
    for a, b in zip(state.optimizer.state.values(), want.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in ("exp_avg", "exp_avg_sq"))
    assert torch.equal(state.generator.get_state(), want.generator.get_state())
    written = json.loads((tmp_path / "traced" / "profile" / "trace_rank0.launches.json")
                         .read_text())
    assert written == {"host_launches": 0, "launches_without_device_record": 0}
    tr = ttrain.Trainer(cfg, data, device="cpu", workdir=str(tmp_path / "direct"))
    storer, prof, counts = tr._profiled_epoch(0)
    assert counts == ttrain.launches_without_record(prof) == (0, 0)
    assert len(storer["loss"]) == 2


def _png_size(path):
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR"
    return struct.unpack(">II", head[16:24])


@pytest.mark.parametrize("dataset", list(tcfg.PRESETS))
def test_apply_quality_overrides_matches_jax(dataset):
    from snd_vae_tpu import config as jcfg

    got = dataclasses.asdict(tcfg.apply_quality_overrides(tcfg.preset(dataset)))
    want = dataclasses.asdict(jcfg.apply_quality_overrides(jcfg.preset(dataset)))
    assert dict(got, dataset_path=None) == dict(want, dataset_path=None)


def test_cli_flags_follow_jax_precedence():
    """--quality first, then --beta; --remat-policy implies --remat."""
    parse = lambda *a: cli.build_cfg(cli.build_parser().parse_args(list(a)))
    q = parse("--quality")
    assert (q.loss.beta, q.loss.use_weighted_bce, q.decoder.edge_from_coords,
            q.compute_dtype) == (0.1, True, True, "bfloat16")
    assert parse("--quality", "--beta", "2.5").loss.beta == 2.5
    assert parse("--quality", "--dataset", "protein").normalize_coords
    assert parse("--quality", "--dataset", "scene").loss.beta == 1.0
    r = parse("--remat-policy", "dots-no-batch", "--motif-block-rows", "5")
    assert (r.remat, r.remat_policy, r.motif_block_rows) == (True, "dots-no-batch", 5)
    f = parse("--eval-every", "3", "--best-metric=-spatial_mse", "--sg-latent-size", "7",
              "--resample-trees-every", "2", "--scene-node-loss", "--pairing-skew",
              "--coord-activation", "linear")
    assert (f.train.eval_every, f.train.best_metric, f.encoder.sg_latent_size,
            f.train.resample_trees_every, f.loss.scene_node_loss, f.reproduce_pairing_skew,
            f.decoder.coord_activation) == (3, "-spatial_mse", 7, 2, True, True, "linear")
