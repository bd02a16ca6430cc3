"""The plain reference: its motif convs against the literal motif sums, its
parameters against the program's, and the whole run with the timed path
broken underneath coming out not correct (the harness's look for a card
skipped: on the CPU, at a tiny size)."""

from __future__ import annotations

import time

import pytest
import torch

from conftest import tiny, tiny_traffic
from portbench import check
from portbench.drive import Context, drive, port_config
from portbench.reference import model as ref
from portbench.run import limits


def lrelu(x):
    return torch.maximum(x, 0.2 * x)


def motif3_literal(adj, x, rel, P, pre):
    """The reference's third-order formula as written (layers.py:143-198)."""
    B, N, F = x.shape
    R = rel.shape[-1]
    m1, b1 = P[pre + "Matrix1"], P[pre + "bias1"]
    m2, b2 = P[pre + "Matrix2"], P[pre + "bias2"]
    m3, b3 = P[pre + "Matrix3"], P[pre + "bias3"]
    e = lambda t, shape: t.expand(shape)
    s4 = (B, N, N, N)
    m3_in = torch.cat([e(x[:, :, None, None], s4 + (F,)), e(x[:, None, :, None], s4 + (F,)),
                       e(x[:, None, None], s4 + (F,)), e(rel[:, :, :, None], s4 + (R,)),
                       e(rel[:, None], s4 + (R,)), e(rel[:, :, None], s4 + (R,))], -1)
    m3t = lrelu(m3_in) @ m1 + b1
    m3s = torch.einsum("bijkh,bijk->bijh", m3t, adj[:, :, :, None] * adj[:, None])
    s3 = (B, N, N)
    m2_in = torch.cat([e(x[:, :, None], s3 + (F,)), e(x[:, None], s3 + (F,)), rel, m3s], -1)
    m2s = torch.einsum("bijh,bij->bih", lrelu(m2_in) @ m2 + b2, adj)
    return lrelu(torch.cat([x, m2s], -1)) @ m3 + b3


def motif4_literal(adj, x, rel, P, pre):
    """The fourth-order formula as written (layers.py:200-277), d = rel."""
    B, N, F = x.shape
    R = rel.shape[-1]
    m0, b0 = P[pre + "Matrix0"], P[pre + "bias0"]
    m1, b1 = P[pre + "Matrix1"], P[pre + "bias1"]
    m2, b2 = P[pre + "Matrix2"], P[pre + "bias2"]
    m3, b3 = P[pre + "Matrix3"], P[pre + "bias3"]
    s5 = (B, N, N, N, N)
    e = lambda t, c: t.expand(s5 + (c,))
    m4_in = torch.cat([e(x[:, :, None, None, None], F), e(x[:, None, :, None, None], F),
                       e(x[:, None, None, :, None], F), e(x[:, None, None, None], F),
                       e(rel[:, :, :, None, None], R), e(rel[:, None, :, :, None], R),
                       e(rel[:, None, None], R), e(rel[:, :, None, :, None], R),
                       e(rel[:, :, None, None], R)], -1)
    mask4 = adj[:, :, :, None, None] * adj[:, None, :, :, None] * adj[:, None, None]
    m4s = torch.einsum("bijkph,bijkp->bijkh", lrelu(m4_in) @ m0 + b0, mask4)
    s4 = (B, N, N, N)
    e = lambda t, c: t.expand(s4 + (c,))
    m3_in = torch.cat([e(x[:, :, None, None], F), e(x[:, None, :, None], F),
                       e(x[:, None, None], F), e(rel[:, :, :, None], R), e(rel[:, None], R),
                       e(rel[:, :, None], R), m4s], -1)
    m3s = torch.einsum("bijkh,bijk->bijh", lrelu(m3_in) @ m1 + b1,
                       adj[:, :, :, None] * adj[:, None])
    s3 = (B, N, N)
    m2_in = torch.cat([x[:, :, None].expand(s3 + (F,)), x[:, None].expand(s3 + (F,)), rel,
                       m3s], -1)
    m2s = torch.einsum("bijh,bij->bih", lrelu(m2_in) @ m2 + b2, adj)
    return lrelu(torch.cat([x, m2s], -1)) @ m3 + b3


@pytest.mark.parametrize("name,conv,literal", [("synthetic2", ref.motif3, motif3_literal),
                                               ("protein", ref.motif4, motif4_literal)])
def test_factored_motif_convs_equal_the_literal_sums(name, conv, literal):
    cfg = tiny(name)
    g = torch.Generator().manual_seed(0)
    T, N, Fi = 3, 6, 4
    adj = (torch.rand(T, N, N, generator=g) < 0.5).double()
    x = torch.randn(T, N, Fi, generator=g, dtype=torch.float64)
    rel = torch.randn(T, N, N, 1, generator=g, dtype=torch.float64)
    hidden = cfg["encoder"]["sg_conv_hidden"][1]
    # layer 1's weights read F_in = h_last of layer 0; give them F_in = 4
    spec = ref.param_spec({**cfg, "num_features": 1,
                           "encoder": {**cfg["encoder"], "sg_conv_hidden": [[Fi] * len(hidden),
                                                                            hidden]}})
    shapes = {k: s for k, s, _ in spec if k.startswith("sg_convs.1.")}
    Q = {k: torch.randn(s, generator=g, dtype=torch.float64) * 0.3 for k, s in shapes.items()}
    got = conv(adj, x, rel, Q, "sg_convs.1.")
    want = literal(adj, x, rel, Q, "sg_convs.1.")
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", ["synthetic2", "protein"])
def test_parameters_are_the_programs_at_full_width(name):
    from portbench.run import load_json
    from snd_vae_tpu_torch.models import build_model

    cfg = load_json("configs", name)
    model = build_model(port_config(cfg, 1), "cpu")
    spec = {k: tuple(s) for k, s, _ in ref.param_spec(cfg)}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == spec


def run_tiny(cell_cfg, traffic, patch=None):
    cfg, tr = tiny(cell_cfg), tiny_traffic(traffic)
    ctx = Context("test", cfg, tr, 2**31 + 11, 0.3, False, torch.device("cpu"),
                  time.perf_counter())
    if patch is not None:
        ctx.patch_program = patch
    out = drive(ctx)
    checked = check.judge(out.numbers, limits(cell_cfg, tr["mode"]))
    return check.passes(checked) and out.failed == 0, checked


def test_sound_runs_are_correct():
    assert run_tiny("synthetic2", "train")[0]
    assert run_tiny("protein", "reconstruct")[0]


def test_a_step_that_leaves_its_state_unchanged_is_not_correct():
    def frozen(trainer):
        trainer.state.optimizer.step = lambda closure=None: None

    ok, checked = run_tiny("synthetic2", "train", frozen)
    assert not ok and checked["change_gap_median"]["value"] == 1.0
    ok, checked = run_tiny("protein", "train", frozen)
    assert not ok and checked["change_gap"]["value"] == 1.0


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from snd_vae_tpu_torch import train

    step = train.train_step

    def half(state, batch, global_iter, eps=None):
        b = batch.adj.shape[0] // 2
        return step(state, batch._map(lambda t: t[:b]), global_iter, eps)

    monkeypatch.setattr(train, "train_step", half)
    ok, checked = run_tiny("synthetic2", "train")
    assert not ok, checked


def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    from snd_vae_tpu_torch import serve

    reconstruct = serve.reconstruct

    def altered(model, batch):
        out = reconstruct(model, batch)
        with torch.inference_mode():
            out.decoded.adj_prob[0, 0, 1, 1] += 1e-6      # one edge's logit
        return out

    monkeypatch.setattr(serve, "reconstruct", altered)
    ok, checked = run_tiny("protein", "reconstruct")
    assert not ok and checked["adj_logit_gap"]["value"] > checked["adj_logit_gap"]["limit"]

    def altered_loss(trainer):
        step = trainer.state.optimizer.step

        def bumped(closure=None):
            for p in trainer.state.model.parameters():
                if p.grad is not None:
                    p.grad.mul_(1.01)
            return step(closure)
        trainer.state.optimizer.step = bumped

    ok, checked = run_tiny("synthetic2", "train", altered_loss)
    number = checked["moment_gap_median"]
    assert not ok and number["value"] > number["limit"]
    ok, checked = run_tiny("protein", "train", altered_loss)
    assert not ok and checked["moment_gap"]["value"] > checked["moment_gap"]["limit"]
