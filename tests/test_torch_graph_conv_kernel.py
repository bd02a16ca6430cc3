"""K3 with GraphConv's projection fused in front: ``adj_matmul(adj, x,
leak, w)`` = lrelu(A @ round(x @ w)), held against JAX's ``GraphConv`` (float64
under ``exact_f64``, f32 at rtol/atol 1e-5, bf16 within one bf16 ulp of the
output's magnitude), against the Pallas kernel in interpret mode without
``w``, and its gradients against ``jax.vjp``; plus the launch plan
``adj_matmul_plan`` over a sweep of shapes, which the wrapper launches as it
says.  On the CPU the wrapper returns the plain version; the kernels run
only on a card, in ``tests/test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snd_vae_tpu import nn as jops
from snd_vae_tpu.nn.pallas import blocked_adj_matmul as jax_blocked_adj_matmul
from snd_vae_tpu_torch import nn as tops
from snd_vae_tpu_torch.nn import graph_conv
from snd_vae_tpu_torch.nn.kernels import adj_matmul as am
from test_torch_ops import exact_f64  # noqa: F401  (fixture)

# the served GraphConvs of synthetic2 (B = 10 graphs of N = 25: x [.,25,1] @
# W [1,10], then the skip concat x [.,25,11] @ W [11,20]) and a small odd one
GRAPH_CONVS = [(10, 25, 1, 10), (10, 25, 11, 20), (2, 7, 3, 5)]


def _inputs(rng, B, N, F, H, dtype=np.float64):
    adj = (rng.random((B, N, N)) < 0.3).astype(dtype)
    x = rng.standard_normal((B, N, F)).astype(dtype)
    w = (0.5 * rng.standard_normal((F, H))).astype(dtype)
    return adj, x, w


def _jax_graph_conv(adj, x, w):
    return jops.GraphConv(w.shape[1]).apply({"params": {"kernel": jnp.asarray(w)}},
                                            jnp.asarray(adj), jnp.asarray(x))


@pytest.mark.parametrize("B,N,F,H", GRAPH_CONVS)
def test_fused_matches_jax_graph_conv_f64(rng, exact_f64, B, N, F, H):  # noqa: F811
    adj, x, w = _inputs(rng, B, N, F, H)
    want = np.asarray(_jax_graph_conv(adj, x, w))
    got = am.adj_matmul(*map(torch.from_numpy, (adj, x)), leak=0.2, w=torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("B,N,F,H", GRAPH_CONVS)
def test_fused_matches_jax_graph_conv_f32(rng, B, N, F, H):
    """f32 at rtol/atol 1e-5: the sums run in another order."""
    adj, x, w = _inputs(rng, B, N, F, H, np.float32)
    want = np.asarray(_jax_graph_conv(adj, x, w))
    got = am.blocked_adj_matmul(*map(torch.from_numpy, (adj, x)), 0.2, torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,N,F,H", GRAPH_CONVS)
def test_fused_matches_jax_graph_conv_bf16(rng, B, N, F, H):
    """bf16: xw rounded to bf16, A @ xw summed in f32 and rounded, lrelu on
    the rounded value.  The f32 sums run in another order and the lrelu's
    product rounds differently (JAX in bf16 arithmetic, PyTorch from f32),
    so outputs may differ by one bf16 ulp of the output's magnitude."""
    adj, x, w = _inputs(rng, B, N, F, H, np.float32)
    want = np.asarray(_jax_graph_conv(*(jnp.asarray(t, jnp.bfloat16) for t in (adj, x, w))),
                      np.float32)
    got = am.adj_matmul(*(torch.from_numpy(t).bfloat16() for t in (adj, x)), leak=0.2,
                        w=torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_array_less(np.abs(got.float().numpy() - want), ulp * 1.0001)


def test_graph_conv_is_one_fused_call(rng, monkeypatch):
    """GraphConv passes its kernel to K3 and forms no x @ W of its own."""
    calls = []

    def spy(adj, x, leak=None, w=None):
        calls.append((tuple(x.shape), None if w is None else tuple(w.shape), leak))
        return torch.zeros(x.shape[:-1] + (w.shape[1],))

    def no_matmul(*args, **kwargs):
        raise AssertionError("GraphConv called torch.matmul")

    monkeypatch.setattr(graph_conv, "adj_matmul", spy)
    monkeypatch.setattr(torch, "matmul", no_matmul)
    adj, x, _ = _inputs(rng, 2, 6, 3, 4, np.float32)
    mod = tops.GraphConv(3, 4, torch.Generator().manual_seed(0))
    mod(torch.from_numpy(adj), torch.from_numpy(x))
    assert calls == [((2, 6, 3), (3, 4), 0.2)]


@pytest.mark.parametrize("leak", [None, 0.2])
@pytest.mark.parametrize("a_shape,x_shape", [((3, 20, 20), (3, 20, 7)), ((37, 50), (50, 9))])
def test_no_w_matches_pallas_interpret(rng, leak, a_shape, x_shape):
    """w=None keeps today's function: the Pallas kernel in interpret mode."""
    adj = (rng.random(a_shape) < 0.4).astype(np.float32)
    x = rng.standard_normal(x_shape).astype(np.float32)
    want = jax_blocked_adj_matmul(jnp.asarray(adj), jnp.asarray(x), leak=leak, interpret=True)
    got = am.blocked_adj_matmul(torch.from_numpy(adj), torch.from_numpy(x), leak)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_fused_matches_pallas_on_projected_input(rng):
    """With w, the same as the Pallas kernel on x @ w (f32)."""
    adj, x, w = _inputs(rng, 3, 20, 11, 20, np.float32)
    want = jax_blocked_adj_matmul(jnp.asarray(adj), jnp.asarray(x) @ jnp.asarray(w), leak=0.2,
                                  interpret=True)
    got = am.blocked_adj_matmul(*map(torch.from_numpy, (adj, x)), 0.2, torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("leak", [None, 0.2])
@pytest.mark.parametrize("batched", [True, False])
def test_grads_match_jax_vjp_f64(rng, exact_f64, leak, batched):  # noqa: F811
    adj, x, w = _inputs(rng, 2, 6, 3, 4)
    if not batched:
        adj, x = adj[0], x[0]
    g = rng.standard_normal(adj.shape[:-1] + (4,))

    def ref(a, xx, ww):
        out = jnp.einsum("...nm,...mo->...no", a, jnp.einsum("...nf,fo->...no", xx, ww))
        return out if leak is None else jnp.maximum(out, leak * out)

    _, vjp = jax.vjp(ref, *map(jnp.asarray, (adj, x, w)))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (adj, x, w)]
    got = torch.autograd.grad(am.adj_matmul(ts[0], ts[1], leak, ts[2]), ts, torch.from_numpy(g))
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-12, atol=1e-12)


def test_grad_of_w_alone(rng):
    adj, x, w = (torch.from_numpy(t) for t in _inputs(rng, 2, 5, 3, 4))
    w.requires_grad_(True)
    (gw,) = torch.autograd.grad(am.adj_matmul(adj, x, 0.2, w).sum(), [w])
    (want,) = torch.autograd.grad(am.adj_matmul_plain(adj, x, 0.2, w).sum(), [w])
    torch.testing.assert_close(gw, want)


@pytest.mark.parametrize("case", ["dtype", "shape", "rank", "device", "layout"])
def test_bad_w_rejected(case):
    adj, x = torch.ones(2, 5, 5), torch.ones(2, 5, 3)
    w = {"dtype": torch.ones(3, 4, dtype=torch.float64),
         "shape": torch.ones(4, 4),
         "rank": torch.ones(2, 3, 4),
         "device": torch.ones(3, 4, device="meta"),
         "layout": torch.ones(4, 3).t()}[case]
    err = TypeError if case == "dtype" else ValueError
    with pytest.raises(err):
        am.blocked_adj_matmul(adj, x, 0.2, w)
    with pytest.raises(err):
        am.adj_matmul(adj, x, 0.2, w)


def test_cpu_fused_call_counts_no_launch(rng):
    before = am.blocked_adj_matmul.launches
    am.adj_matmul(torch.ones(2, 4, 4), torch.ones(2, 4, 3), 0.2, torch.ones(3, 5))
    assert am.blocked_adj_matmul.launches == before


# (batch, n, m, h, f): from one node up to the large-graph bench's sizes
PLAN_SHAPES = [
    (1, 1, 1, 1, None), (10, 25, 25, 10, 1), (10, 25, 25, 20, 11), (10, 25, 25, 20, None),
    (100, 25, 25, 50, None), (3, 45, 70, 33, None), (2, 256, 256, 10, 1),
    (2, 1024, 1024, 20, 11), (1, 2048, 2048, 128, None), (1, 2047, 2047, 100, None),
    (1, 2048, 2048, 128, 128), (1, 4096, 4096, 128, None), (1, 8192, 8192, 128, None),
    (1, 8192, 8192, 128, 64), (4000, 30, 30, 5, None), (1, 64, 65, 3, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,n,m,h,f", PLAN_SHAPES)
def test_plan_is_legal(batch, n, m, h, f, dtype):
    p = am.adj_matmul_plan(batch, n, m, h, f, dtype)
    assert p.variant in ("small", "simt", "tc")
    assert p.smem <= am.SMEM_PER_BLOCK and p.threads <= 1024 and p.threads % 32 == 0
    assert 1 <= p.split <= am.MAX_SPLIT and p.split & (p.split - 1) == 0   # a legal cluster
    assert p.grid[0] % p.split == 0 and all(g >= 1 for g in p.grid)
    assert p.grid[1] <= am.GRID_YZ_MAX and p.grid[2] <= am.GRID_YZ_MAX
    # the k-slices cover [0, m) exactly once, in rank order
    assert len(p.k_slices) == p.split
    assert p.k_slices[0][0] == 0 and p.k_slices[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(p.k_slices, p.k_slices[1:]))
    assert all(s < e for s, e in p.k_slices)   # no rank without k
    assert all(s % p.tile[2] == 0 for s, _ in p.k_slices)
    if p.variant == "small":
        assert p.split == 1 and p.smem <= am.SMALL_MAX_SMEM
        assert p.grid == (batch * -(-h // am.SMALL_COLS), 1, 1)
    else:
        assert p.variant == ("tc" if dtype == torch.bfloat16 else "simt")
        rows, cols, _ = p.tile
        assert p.grid == (p.split, -(-n // rows) * -(-h // cols), batch)
        assert p.tile[0] % p.split == 0   # each rank reduces whole rows of the tile
    assert p.fuse_w == (f is not None and (p.variant == "small" or f <= am.MAX_FUSED_F))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,f", [(10, 1), (20, 11)])
def test_plan_small_serves_synthetic2(dtype, h, f):
    p = am.adj_matmul_plan(10, 25, 25, h, f, dtype)
    assert p.variant == "small" and p.fuse_w and p.blocks == 10


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_fills_the_card_at_2048(dtype):
    p = am.adj_matmul_plan(1, 2048, 2048, 128, None, dtype)
    assert p.blocks >= 100 and p.split > 1
    assert p.variant == ("tc" if dtype == torch.bfloat16 else "simt")
    assert p.tma_a and p.tma_x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_ragged_and_unaligned_avoid_wide_loads(dtype):
    p = am.adj_matmul_plan(1, 2047, 2047, 100, None, dtype)
    assert not p.tma_a                     # rows of 2047 are no multiple of 16 bytes
    assert p.tma_x == (dtype == torch.float32)   # rows of 100: 400 B in f32, 200 B in bf16
    q = am.adj_matmul_plan(1, 2048, 2048, 128, None, dtype, aligned=False)
    assert not (q.tma_a or q.tma_x)


def test_plan_wide_f_is_not_fused():
    p = am.adj_matmul_plan(1, 2048, 2048, 128, 128, torch.float32)
    assert not p.fuse_w and p.tma_x


@pytest.mark.parametrize("batch,n,m,h,f", PLAN_SHAPES[:9])
def test_plan_as_launched(batch, n, m, h, f):
    """The struct handed to the launch carries the plan unchanged."""
    p = am.adj_matmul_plan(batch, n, m, h, f, torch.bfloat16 if n > 1000 else torch.float32)
    c = p.as_c()
    assert am.VARIANTS[c.variant] == p.variant and c.split == p.split
    assert tuple(c.grid) == p.grid and tuple(c.tile) == p.tile
    assert (c.threads, c.smem, c.stages) == (p.threads, p.smem, p.stages)
    assert list(c.k_bound[:p.split + 1]) == [s for s, _ in p.k_slices] + [m]
    assert (c.tma_a, c.tma_x) == (p.tma_a, p.tma_x)


def test_plan_follows_the_cards_cluster_capacity():
    """A card that holds fewer clusters of 4 gets a smaller k-split."""
    full = am.adj_matmul_plan(1, 2048, 2048, 128, None, torch.bfloat16)
    held = {**am.H100_CLUSTERS, "tc": {**am.H100_CLUSTERS["tc"], 4: 16}}
    less = am.adj_matmul_plan(1, 2048, 2048, 128, None, torch.bfloat16, clusters=held)
    assert full.split == 4 and less.split == 2 and less.grid == (2, 32, 1)


def test_plan_rejects_what_no_grid_holds():
    with pytest.raises(ValueError):
        am.adj_matmul_plan(70_000, 100, 100, 8, None, torch.float32)
    with pytest.raises(TypeError):
        am.adj_matmul_plan(1, 100, 100, 8, None, torch.float64)
