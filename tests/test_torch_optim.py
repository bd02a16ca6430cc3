"""The port's optimizers (``snd_vae_tpu_torch.train.Adam`` / ``TF1Adam``)
with their step counts on the device: float32 against ``optax.adam`` and
JAX's ``tf1_adam`` (``snd_vae_tpu/train.py:49-95``), the counts' sharing
and splitting, a parameter without a gradient skipped, and checkpoints in
the formats before the counts moved to the device (a host ``int``,
``torch.optim.Adam``'s CPU tensor), which still resume bit for bit.  The
float64 case at rtol 1e-12 is ``tests/test_torch_train.py``'s
``test_optimizer_matches_jax``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import configs
from torch_parity import one_thread  # noqa: F401  (fixture)

from snd_vae_tpu import train as jtrain
from snd_vae_tpu_torch import config as tcfg
from snd_vae_tpu_torch import train as ttrain
from snd_vae_tpu_torch.data.loaders import load_dataset

pytestmark = pytest.mark.usefixtures("one_thread")
SHAPES = [(3, 4), (5,), (2, 2, 3)]


def _optimizer(name, params, lr=1e-2):
    cfg = tcfg.synthetic2_preset()
    cfg = cfg.with_(train=dataclasses.replace(cfg.train, optimizer=name, learning_rate=lr))
    return ttrain.make_optimizer(cfg, params)


def _grads(rng, steps):
    return [[(rng.standard_normal(s) * 10.0 ** rng.integers(-9, 1, s)).astype(np.float32)
             for s in SHAPES] for _ in range(steps)]


@pytest.mark.parametrize("name", ["adam", "tf1-adam"])
def test_optimizer_matches_jax_f32(name, rng):
    """Six float32 updates, some gradients near eps, against optax.adam /
    tf1_adam in float32 (rtol 1e-6); the counts are one float32 0-dim
    tensor on the parameters' device, at 6."""
    lr = 1e-2
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = _grads(rng, 6)
    opt = jtrain.tf1_adam(lr) if name == "tf1-adam" else optax.adam(lr, 0.9, 0.999, 1e-8)
    params = [jnp.asarray(p) for p in p0]
    state = opt.init(params)
    for g in grads:
        upd, state = opt.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, upd)
    tp = [torch.tensor(p, requires_grad=True) for p in p0]
    topt = _optimizer(name, tp, lr)
    for g in grads:
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        topt.step()
    for got, want in zip(tp, params):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=0)
    counts = {id(topt.state[p]["step"]) for p in tp}
    count = topt.state[tp[0]]["step"]
    assert len(counts) == 1 and count.dtype == torch.float32 and count.dim() == 0
    assert count.device == tp[0].device and float(count) == 6.0


@pytest.mark.parametrize("name", ["adam", "tf1-adam"])
def test_parameter_without_gradient_is_skipped(name, rng):
    """Two parameters updated together share a count; a step where one has
    no gradient leaves it, its moments and its count as they were, and
    splits the count; afterwards each follows its own count, as an
    optimizer over that parameter alone would."""
    x0, y0 = (rng.standard_normal((4, 3)) for _ in range(2))
    gx, gy = ([torch.from_numpy(rng.standard_normal((4, 3))) for _ in range(4)]
              for _ in range(2))
    x, y = (torch.tensor(v, requires_grad=True) for v in (x0, y0))
    opt = _optimizer(name, [x, y])
    alone = torch.tensor(y0, requires_grad=True)
    opt_alone = _optimizer(name, [alone])
    for k, has_y in enumerate((True, True, False, True)):
        x.grad, y.grad = gx[k], gy[k] if has_y else None
        before = (y.detach().clone(), {n: v.clone() for n, v in opt.state[y].items()})
        opt.step()
        if has_y:
            alone.grad = gy[k]
            opt_alone.step()
        else:
            assert torch.equal(y, before[0])
            assert all(torch.equal(opt.state[y][n], v) for n, v in before[1].items())
        shared = opt.state[x]["step"] is opt.state[y]["step"]
        assert shared == (k < 2)
    assert float(opt.state[x]["step"]) == 4.0 and float(opt.state[y]["step"]) == 3.0
    assert torch.equal(y, alone)


def test_torch_adam_state_loads(rng):
    """``torch.optim.Adam``'s state_dict, the "adam" format before this
    one, loads: its CPU step counts become one float32 tensor on the
    parameters' device, its moments are kept."""
    ps = [torch.tensor(rng.standard_normal(s), dtype=torch.float32, requires_grad=True)
          for s in SHAPES]
    old = torch.optim.Adam(ps, 1e-2)
    for g in _grads(rng, 3):
        for p, x in zip(ps, g):
            p.grad = torch.from_numpy(x)
        old.step()
    saved = old.state_dict()
    new = _optimizer("adam", ps)
    new.load_state_dict(saved)
    counts = {id(new.state[p]["step"]) for p in ps}
    assert len(counts) == 1 and float(new.state[ps[0]]["step"]) == 3.0
    for p in ps:
        assert new.state[p]["step"].dtype == torch.float32
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(new.state[p][k], old.state[p][k])


def _old_format(optimizer: dict, name: str) -> dict:
    """A saved optimizer state as the port wrote it before its counts
    moved to the device: "tf1-adam" a host int, "adam" torch.optim.Adam's
    state_dict (a CPU float32 count and its param group's keys)."""
    groups = [dict(g) for g in optimizer["param_groups"]]
    if name == "adam":
        keys = torch.optim.Adam([torch.zeros(1, requires_grad=True)]).state_dict()
        groups = [dict(keys["param_groups"][0], **g) for g in groups]
    state = {i: dict(s, step=int(s["step"]) if name == "tf1-adam"
                     else torch.tensor(float(s["step"])))
             for i, s in optimizer["state"].items()}
    return {"state": state, "param_groups": groups}


@pytest.mark.parametrize("name", ["adam", "tf1-adam"])
def test_checkpoint_before_device_counts_resumes(tmp_path, name):
    """A checkpoint of epoch 0 rewritten in the format before this one
    resumes: epoch 1 from it equals 2 epochs straight bit for bit (every
    parameter, the moments, the counts, the ε stream)."""
    _, tc = configs("small")
    tc = tc.with_(train=dataclasses.replace(tc.train, optimizer=name, checkpoint_every=1))
    data = load_dataset(tc, "train", num_graphs=20, device="cpu")
    trainer = lambda d: ttrain.Trainer(tc, data, device="cpu", workdir=str(tmp_path / d))
    straight = trainer("a")
    straight.run(2, verbose=False)
    first = trainer("b")
    first.run(1, verbose=False)
    path = first.checkpointer.path(0)
    payload = torch.load(path, weights_only=True)
    payload["optimizer"] = _old_format(payload["optimizer"], name)
    torch.save(payload, path)
    resumed = trainer("b")
    resumed.run(2, verbose=False)
    a, b = straight.state, resumed.state
    assert a.step == b.step == 4
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
