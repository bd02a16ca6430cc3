"""Each FLOP and byte count against a brute-force count at a tiny shape, and
the trace reader on a made-up trace."""

from __future__ import annotations

import itertools
import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import tiny
from portbench import counts, inputs
from portbench.reference import model as ref
from portbench.traces import Trace


def tiny_batch(cfg, B=2, seed=3):
    data = inputs.make_split(cfg, B, seed, "train")
    return {k: torch.as_tensor(v) for k, v in data.items()}, data


def flops_of(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("name", ["synthetic2", "protein"])
def test_forward_and_decode_flops_equal_the_references_products(name):
    cfg = tiny(name)
    batch, _ = tiny_batch(cfg)
    P = inputs.make_weights(ref.param_spec(cfg), 1, "cpu")
    B, S = 2, cfg["sampling_num"]
    with torch.no_grad():
        assert flops_of(lambda: ref.forward(P, cfg, batch)) == counts.forward_flops(cfg, B, S)
        z = ref.normal_draws(torch.Generator().manual_seed(0), B, S, cfg)
        assert flops_of(lambda: ref.decode(P, cfg, *z)) == counts.decode_flops(cfg, B, S)
    assert counts.train_step_flops(cfg, B, S) == 3 * counts.forward_flops(cfg, B, S)


def brute_level3_ops(adj, R, h, backward=False):
    """Loops over (t, i, j, k) as the kernels' arithmetic is written."""
    T, N = adj.shape[:2]
    ops = 0
    for t, i, j in itertools.product(range(T), range(N), range(N)):
        if adj[t, i, j] == 0:
            continue
        ops += sum(2 * R for k in range(N) if adj[t, j, k] != 0)          # rf
        ops += h * (4 * R + 7)                                            # m3, lrelu, the j-sum
        if backward:   # the model's gradients: a_i 2, v_j 1, M1d 2R+1, M1f 2R, bias 1
            ops += h * (2 + 1 + 2 * R + 1 + 2 * R + 1)
    return ops


def test_motif_kernel_counts_against_loops():
    cfg = tiny("synthetic2")
    _, data = tiny_batch(cfg)
    adj = data["adj_samples"].reshape(-1, 6, 6)
    T, N, R, h = adj.shape[0], 6, 1, 5
    nbytes, ops = counts.level3_counts(adj, R, h, "float32")
    assert ops == brute_level3_ops(adj, R, h)
    # bytes: each input once (adj, φ(rel), a_i, v_j, deg, M1d, M1f, bias), nt once
    shapes = [(T, N, N), (T, N, N, R), (T, N, h), (T, N, h), (T, N), (R, h), (R, h), (h,),
              (T, N, h)]
    assert nbytes == 4 * sum(np.prod(s) for s in shapes)
    nbytes, ops = counts.level3_backward_counts(adj, R, h, "float32")
    assert ops == brute_level3_ops(adj, R, h, backward=True)
    # + the gradient of nt read, ∂a_i, ∂v_j, ∂M1d, ∂M1f, ∂bias written
    shapes += [(T, N, h), (T, N, h), (R, h), (R, h), (h,)]
    assert nbytes == 4 * sum(np.prod(s) for s in shapes)


def test_graph_conv_kernel_counts_against_a_product_count():
    b, n, f, h = 3, 5, 2, 4
    A, x, w = torch.rand(b, n, n), torch.rand(b, n, f), torch.rand(f, h)
    nbytes, ops = counts.adj_matmul_counts(b, n, f, h, "float32")
    # the products and the lrelu epilogue (2 a element), each input and output once
    assert ops == flops_of(lambda: A @ (x @ w)) + 2 * b * n * h
    assert nbytes == 4 * (A.numel() + x.numel() + w.numel() + b * n * h)
    for need_x in (False, True):
        nbytes, ops = counts.adj_matmul_backward_counts(b, n, f, h, need_x, "float32")
        g = torch.rand(b, n, h)
        gxw = A.transpose(1, 2) @ g
        products = flops_of(lambda: A.transpose(1, 2) @ g) + flops_of(
            lambda: x.reshape(-1, f).T @ gxw.reshape(-1, h))
        if need_x:
            products += flops_of(lambda: gxw @ w.T)
        assert ops == products + 3 * b * n * h               # gy = g·lrelu'(out): 3 an element
        reads = A.numel() + x.numel() + w.numel() + 2 * b * n * h
        assert nbytes == 4 * (reads + w.numel() + (x.numel() if need_x else 0))


def test_a_step_bound_is_the_sum_of_its_kernels():
    cfg = tiny("synthetic2")
    _, data = tiny_batch(cfg)
    trees = data["adj_samples"]
    both = counts.step_kernel_bound(cfg, trees, train=True)
    fwd = counts.step_kernel_bound(cfg, trees, train=False)
    assert 0 < fwd < both
    pro = tiny("protein")
    # no third-order conv: the GraphConvs' K3 alone
    f, h = counts.graph_conv_widths(pro)[0]
    assert counts.step_kernel_bound(pro, trees, train=False) >= counts.bound_s(
        *counts.adj_matmul_counts(2, 6, f, h, "float32"), "float32")


def test_trace_reader_on_a_made_up_trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "window", "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "sg_conv.0", "ts": 10, "dur": 20, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "dur": 2,
         "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 40, "dur": 2,
         "tid": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "adj_matmul_small", "ts": 20, "dur": 30,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 40, "dur": 20,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "ts": 90, "dur": 20,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sleep", "ts": 60, "dur": 30, "tid": 1},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = Trace.load(str(path))
    w = t.range_window("window")
    assert w == (0.0, 110.0)                     # to the end of the last record begun inside
    assert t.busy_us(w) == 40 + 20               # [20, 60) and [90, 110)
    assert t.device_us(w, ("adj_matmul_",)) == 30
    assert t.range_device_us(w, "sg_conv.") == {"sg_conv.0": 30.0}
    bd = t.breakdown(w)
    assert bd["device_ops"][0] == ["adj_matmul_small", 30e-6]
    gaps = dict(bd["idle_gaps"])
    assert gaps["aten::sleep"] == pytest.approx(30e-6)        # [60, 90)
    assert gaps["sg_conv.0"] == pytest.approx(20e-6)          # [0, 20): the innermost range
