"""K3's backward: ``adj_matmul_backward_plain``, the closed form the CPU runs
in place of the card's ``csrc/adj_matmul_backward.cu``, held against
``jax.vjp`` of the JAX ``GraphConv`` (flax apply, with respect to A, x and
the kernel) and of ``adj_matmul_reference`` (no W): float64 at rtol 1e-10
under ``exact_f64``, f32 at rtol/atol 1e-5, bf16 within 2e-2 of the largest
magnitude, against the port's own autograd through ``adj_matmul_plain`` in
bf16 (bit for bit) and against JAX.  Cases: batched and unbatched, with and
without W, narrow (<= 16) and wide F, each subset of the gradients with and
without ∂A, and graphs with rows of A that are all zero, where y = 0 and
``maximum``'s backward splits the gradient (0.6 at leak 0.2).  Plus the
backward's launch plan ``adj_matmul_backward_plan`` and that the autograd
wrapper's backward runs the closed form, never the plain forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ops import exact_f64  # noqa: F401  (fixture)
from torch_parity import one_thread  # noqa: F401  (fixture)

from snd_vae_tpu import nn as jops
from snd_vae_tpu.nn.pallas.blocked_spmm import adj_matmul_reference
from snd_vae_tpu_torch.nn.kernels import adj_matmul as am

pytestmark = pytest.mark.usefixtures("one_thread")

LEAK = 0.2
# (A shape, F or None (no W), H, rows of A that are all zero): synthetic2's
# two GraphConvs, one with zero rows, a wide F, unbatched, and no W
CASES = {
    "synthetic2_layer1": ((10, 25, 25), 1, 10, 0),
    "synthetic2_layer2": ((10, 25, 25), 11, 20, 0),
    "zero_rows": ((4, 25, 25), 11, 20, 3),
    "wide_f": ((2, 9, 9), 20, 6, 1),
    "unbatched": ((9, 7), 3, 5, 1),
    "no_w": ((3, 8, 10), None, 6, 2),
    "no_w_unbatched": ((8, 10), None, 6, 2),
}
# (∂A, ∂x, ∂W)
NEEDS = [(True, True, True), (False, True, True), (False, False, True), (False, True, False),
         (True, False, False)]


def _inputs(rng, a_shape, f, h, zero_rows, dtype=np.float64):
    adj = (rng.random(a_shape) < 0.3).astype(dtype)
    adj[..., :zero_rows, :] = 0.0
    x = rng.standard_normal(a_shape[:-2] + (a_shape[-1], h if f is None else f)).astype(dtype)
    w = None if f is None else (0.5 * rng.standard_normal((f, h))).astype(dtype)
    g = rng.standard_normal(a_shape[:-1] + (h,)).astype(dtype)
    return adj, x, w, g


def _jax_vjp(adj, x, w, g, dtype=None):
    """(∂A, ∂x, ∂W) from jax.vjp: of the JAX GraphConv with W, of
    adj_matmul_reference with leak 0.2 without."""
    cast = lambda t: jnp.asarray(t) if dtype is None else jnp.asarray(t, dtype)
    if w is None:
        _, vjp = jax.vjp(lambda a, xx: adj_matmul_reference(a, xx, LEAK), cast(adj), cast(x))
        return (*vjp(cast(g)), None)
    conv = jops.GraphConv(w.shape[1])
    _, vjp = jax.vjp(lambda a, xx, ww: conv.apply({"params": {"kernel": ww}}, a, xx),
                     cast(adj), cast(x), cast(w))
    return vjp(cast(g))


def _port(adj, x, w, g, needs, dtype=torch.float64):
    t = lambda a: None if a is None else torch.from_numpy(a).to(dtype)
    adj, x, w, g = t(adj), t(x), t(w), t(g)
    out = am.adj_matmul_plain(adj, x, LEAK, w)
    return am.adj_matmul_backward_plain(g, adj, x, out, LEAK, w, needs)


def _autograd(adj, x, w, g, needs, dtype):
    """The port's autograd through ``adj_matmul_plain`` (what the backward
    was before it had a kernel)."""
    ts = [None if a is None else torch.from_numpy(a).to(dtype).requires_grad_(nd)
          for a, nd in zip((adj, x, w), needs)]
    out = am.adj_matmul_plain(ts[0], ts[1], LEAK, ts[2])
    wanted = [t for t in ts if t is not None and t.requires_grad]
    got = iter(torch.autograd.grad(out, wanted, torch.from_numpy(g).to(dtype)))
    return [next(got) if t is not None and t.requires_grad else None for t in ts]


@pytest.mark.parametrize("needs", NEEDS)
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_vjp_f64(rng, exact_f64, case, needs):  # noqa: F811
    adj, x, w, g = _inputs(rng, *CASES[case])
    want = _jax_vjp(adj, x, w, g)
    got = _port(adj, x, w, g, needs)
    for need, a, b in zip(needs, got, want):
        if not need or b is None:
            assert a is None
            continue
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_vjp_f32(rng, case):
    """f32 at rtol/atol 1e-5: the sums run in another order."""
    adj, x, w, g = _inputs(rng, *CASES[case], dtype=np.float32)
    want = _jax_vjp(adj, x, w, g)
    got = _port(adj, x, w, g, (True, True, True), torch.float32)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_plain_bf16_matches_autograd_and_jax(rng, case):
    """bf16: the closed form rounds where autograd through the plain version
    rounds (gy, gxw, gx, gW, gA each to bf16), so the two are held within
    2e-2 of the largest magnitude and are in fact equal; JAX's bf16 vjp
    rounds elsewhere (its products and lrelu in bf16 arithmetic), within
    2e-2 of its largest magnitude."""
    adj, x, w, g = _inputs(rng, *CASES[case], dtype=np.float32)
    got = _port(adj, x, w, g, (True, True, True), torch.bfloat16)
    auto = _autograd(adj, x, w, g, (True, True, w is not None), torch.bfloat16)
    ref = _jax_vjp(adj, x, w, g, jnp.bfloat16)
    for a, b, c in zip(got, auto, ref):
        if c is None:
            assert a is None and b is None
            continue
        assert a.dtype == torch.bfloat16
        top = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= 2e-2 * top
        assert torch.equal(a, b)
        c = np.asarray(c, np.float32)
        assert np.abs(a.float().numpy() - c).max() <= 2e-2 * np.abs(c).max()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_lrelu_grad_is_maximums_backward(dtype):
    """``lrelu_grad`` from the output equals autograd through
    ``maximum(y, 0.2 y)``: 1 above 0, 0.2 below, 0.6 at y = +0 (the tie),
    and 0.2 where 0.2 y underflows to -0.0 (bf16's smallest subnormals)."""
    tiny = -(2.0 ** -133)
    y = torch.tensor([1.5, -1.5, 0.0, tiny, 2 * tiny, -3e-3, 7.0], dtype=dtype,
                     requires_grad=True)
    g = torch.tensor([1.0, 1.0, 1.0, 1.3, 1.7, -2.1, 0.3], dtype=dtype)
    out = torch.maximum(y, LEAK * y)
    (want,) = torch.autograd.grad(out, [y], g)
    got = am.lrelu_grad(g, out.detach(), LEAK)
    assert torch.equal(got, want)
    assert got[2].item() == pytest.approx(0.6, rel=1e-2)


@pytest.mark.parametrize("case", CASES)
def test_autograd_wrapper_runs_the_closed_form(rng, monkeypatch, case):
    """``adj_matmul``'s backward on the CPU is ``fused_adj_matmul_backward``
    → ``adj_matmul_backward_plain``: it never calls ``adj_matmul_plain``
    (the forward, which the CPU's forward does call), and its gradients
    equal the closed form's."""
    adj, x, w, g = (None if t is None else torch.from_numpy(t).float()
                    for t in _inputs(rng, *CASES[case], dtype=np.float32))
    xs = x.clone().requires_grad_(True)
    ws = None if w is None else w.clone().requires_grad_(True)
    out = am.adj_matmul(adj, xs, LEAK, ws)
    calls = {"plain": 0, "closed": 0}
    plain, closed = am.adj_matmul_plain, am.adj_matmul_backward_plain

    def count_plain(*args, **kwargs):
        calls["plain"] += 1
        return plain(*args, **kwargs)

    def count_closed(*args, **kwargs):
        calls["closed"] += 1
        return closed(*args, **kwargs)

    monkeypatch.setattr(am, "adj_matmul_plain", count_plain)
    monkeypatch.setattr(am, "adj_matmul_backward_plain", count_closed)
    leaves = [xs] + ([] if ws is None else [ws])
    got = torch.autograd.grad(out, leaves, g)
    assert calls == {"plain": 0, "closed": 1}
    want = closed(g, adj, x, out.detach(), LEAK, w, (False, True, w is not None))
    for a, b in zip(got, want[1:]):
        assert torch.equal(a, b)


def test_backward_skips_what_is_not_asked(rng, monkeypatch):
    """Layer 1's x is the data: only ∂W is formed."""
    adj, x, w, g = (torch.from_numpy(t) for t in _inputs(rng, (3, 6, 6), 2, 4, 0))
    ws = w.clone().requires_grad_(True)
    seen = []
    closed = am.adj_matmul_backward_plain

    def spy(*args):
        seen.append(args[-1])
        return closed(*args)

    out = am.adj_matmul(adj, x, LEAK, ws)
    monkeypatch.setattr(am, "adj_matmul_backward_plain", spy)
    torch.autograd.grad(out, [ws], g)
    assert seen == [(False, False, True)]


@pytest.mark.parametrize("case", ["dtype", "shape", "out_shape", "layout"])
def test_bad_backward_inputs_rejected(case):
    adj, x, w = torch.ones(2, 5, 5), torch.ones(2, 5, 3), torch.ones(3, 4)
    g = out = torch.ones(2, 5, 4)
    kw = {"dtype": dict(grad=g.double()), "shape": dict(grad=torch.ones(2, 5, 3)),
          "out_shape": dict(out=torch.ones(2, 4, 4)),
          "layout": dict(grad=torch.ones(2, 4, 5).transpose(1, 2))}[case]
    args = dict(grad=g, adj=adj, x=x, out=out, leak=LEAK, w=w) | kw
    with pytest.raises(TypeError if case == "dtype" else ValueError):
        am.fused_adj_matmul_backward(**args)


# ---- the launch plan

SERVED = [("synthetic2", 10, 25, 25, 10, 1), ("synthetic2", 10, 25, 25, 20, 11),
          ("protein", 50, 50, 50, 10, 1), ("protein", 50, 50, 50, 20, 11),
          ("mnist", 2, 50, 50, 10, 1), ("mnist", 2, 50, 50, 20, 11)]
# chip_smoke.py's K3_CASES off the model's path, (batch, n, m, h, f), and
# shapes whose strides TMA cannot take in one dtype or both (h = 20 and 17,
# m = 303: cp.async into the same layout)
TILED = [(2, 1024, 1024, 20, 11), (1, 2048, 2048, 128, None), (1, 8192, 8192, 128, None),
         (3, 45, 70, 33, None), (1, 2047, 2047, 100, None), (1, 2048, 2048, 128, 128),
         (1, 64, 65, 3, None), (4000, 30, 300, 5, 2), (2, 300, 300, 20, 11),
         (1, 2048, 2048, 128, 11), (1, 301, 303, 17, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("path,batch,n,m,h,f", SERVED)
def test_plan_small_serves_the_models(path, batch, n, m, h, f, dtype):
    """The model's GraphConvs take the small variant: one block per graph,
    W fused, the partial gW one per graph, one kernel per GraphConv (a
    second only for ∂A)."""
    p = am.adj_matmul_backward_plan(batch, n, m, h, f, dtype, (False, True, True))
    assert p.variant == "small" and p.fuse_w and p.grid == (batch, 1, 1)
    assert p.parts == batch and p.kernels == 1
    assert p.smem <= am.SMALL_MAX_SMEM and p.threads == am.BWD_THREADS
    assert p.smem == 4 * (n * (m | 1) + n * h + m * h + m * f + f * h)
    layer1 = am.adj_matmul_backward_plan(batch, n, m, h, f, dtype, (False, False, True))
    assert layer1.kernels == 1 and layer1.parts == batch
    with_a = am.adj_matmul_backward_plan(batch, n, m, h, f, dtype, (True, True, True))
    assert with_a.kernels == 2 and with_a.da_grid == (1, batch, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,n,m,h,f", TILED)
def test_plan_tiled_is_legal(batch, n, m, h, f, dtype):
    """Larger shapes take gxw tiles: "simt" (64 x 64, f32) or "tc" (128 x
    128, bf16), 64 i-rows a stage in a ring of 4; W fused up to F = 16 where
    h is one column tile (the partial gW one per block), else gW is a plain
    product.  The sum over i is split over a cluster of the most blocks
    (a power of two <= 8, at most one per i-step) whose clusters the card
    still holds at once; the i-slices cover [0, n) in rank order on i-step
    boundaries, none empty; every launch fits the grid and the 227 KB of
    shared memory; TMA is planned exactly where the rows are 16-byte
    multiples and the data aligned."""
    for aligned in (True, False):
        p = am.adj_matmul_backward_plan(batch, n, m, h, f, dtype, (True, True, True), aligned)
        bf16 = dtype == torch.bfloat16
        assert p.variant == ("tc" if bf16 else "simt")
        assert p.threads == (am.BWD_TC_THREADS if bf16 else am.BWD_SIMT_THREADS)
        assert p.tile == (am.BWD_TC_TILE if bf16 else am.BWD_SIMT_TILE)
        assert p.stages == am.BWD_STAGES == 4
        rows, cols, step = p.tile
        k_tiles, h_tiles = -(-m // rows), -(-h // cols)
        assert (p.k_tiles, p.h_tiles) == (k_tiles, h_tiles)
        assert p.fuse_w == (f is not None and f <= am.MAX_FUSED_F and h <= cols)
        tiles = k_tiles * h_tiles
        assert p.grid == (p.split, tiles, batch)
        assert p.parts == (p.split * tiles * batch if p.fuse_w else 0)
        assert p.da_grid == (-(-n // 64) * -(-m // 64), batch, 1) and p.kernels == 2
        # the split: a power of two the card holds, the largest that fits
        held = am.H100_BWD_CLUSTERS[p.variant]
        steps = -(-n // step)
        assert p.split in (1, 2, 4, 8) and p.split <= steps
        assert p.split == 1 or tiles * batch <= held[p.split]
        assert p.split == 8 or 2 * p.split > steps or tiles * batch > held[2 * p.split]
        # the i-slices
        assert len(p.i_slices) == p.split
        assert p.i_slices[0][0] == 0 and p.i_slices[-1][1] == n
        for (lo, hi), (nxt, _) in zip(p.i_slices, p.i_slices[1:] + ((n, n),)):
            assert lo % step == 0 and lo < hi == nxt
        # shared memory and the grid
        assert p.smem == (am.BWD_TC_SMEM if bf16 else am.BWD_SIMT_SMEM) <= am.SMEM_PER_BLOCK
        assert p.da_smem <= am.SMALL_MAX_SMEM
        assert p.grid[1] <= am.GRID_YZ_MAX and p.grid[2] <= am.GRID_YZ_MAX
        per16 = 8 if bf16 else 4
        assert p.tma_a == (aligned and m % per16 == 0)
        assert p.tma_g == (aligned and h % per16 == 0)


@pytest.mark.parametrize("dtype,shape,split,blocks", [
    (torch.float32, (1, 2048, 2048, 128, None), 2, 128),
    (torch.bfloat16, (1, 2048, 2048, 128, None), 4, 64),
    (torch.float32, (1, 8192, 8192, 128, None), 1, 256),
    (torch.bfloat16, (1, 8192, 8192, 128, None), 2, 128),
    (torch.float32, (2, 1024, 1024, 20, 11), 2, 64),
    (torch.bfloat16, (2, 1024, 1024, 20, 11), 4, 64),
    (torch.float32, (1, 2047, 2047, 100, None), 2, 128),
    (torch.bfloat16, (3, 45, 70, 33, None), 1, 3)])
def test_plan_splits_the_sum_over_rows(dtype, shape, split, blocks):
    """The split at the shapes that run the tiled kernels: at N = 2048, h =
    128 the 64 f32 tiles (16 bf16) become 128 (64) blocks, one wave."""
    p = am.adj_matmul_backward_plan(*shape, dtype)
    assert (p.split, p.grid[0] * p.grid[1] * p.grid[2]) == (split, blocks)


@pytest.mark.parametrize("needs", NEEDS)
def test_plan_launches_only_what_is_asked(needs):
    p = am.adj_matmul_backward_plan(10, 25, 25, 20, 11, torch.float32, needs)
    main = needs[1] or needs[2]
    assert (p.grid != (0, 0, 0)) == main and (p.da_grid != (0, 0, 0)) == needs[0]
    assert p.kernels == int(main) + int(needs[0])
    assert p.parts == (10 if needs[2] else 0)


def test_plan_as_launched():
    """The struct handed to the launch carries the plan unchanged."""
    for args in ((10, 25, 25, 20, 11), (2, 1024, 1024, 20, 11), (1, 2047, 2047, 100, None),
                 (1, 8192, 8192, 128, None)):
        for dtype in (torch.float32, torch.bfloat16):
            p = am.adj_matmul_backward_plan(*args, dtype, (True, True, True))
            c = p.as_c()
            assert c.variant == am.BWD_VARIANTS.index(p.variant) and c.fuse_w == p.fuse_w
            assert (c.threads, c.smem, c.k_tiles, c.h_tiles, c.parts, c.da_smem) == (
                p.threads, p.smem, p.k_tiles, p.h_tiles, p.parts, p.da_smem)
            assert tuple(c.grid) == p.grid and tuple(c.da_grid) == p.da_grid
            assert (c.split, tuple(c.tile), c.stages, c.tma_a, c.tma_g) == (
                p.split, p.tile, p.stages, p.tma_a, p.tma_g)
            bounds = [lo for lo, _ in p.i_slices] + [p.i_slices[-1][1]]
            assert list(c.i_bound) == bounds + [0] * (am.MAX_SPLIT + 1 - len(bounds))


def test_plan_rejects_what_no_grid_holds():
    with pytest.raises(ValueError):
        am.adj_matmul_backward_plan(70_000, 100, 100, 8, None, torch.float32)
    with pytest.raises(ValueError):   # more gxw row tiles than the grid's y
        am.adj_matmul_backward_plan(1, 100, 64 * 65_536 + 1, 8, None, torch.float32)
    with pytest.raises(TypeError):
        am.adj_matmul_backward_plan(1, 100, 100, 8, None, torch.float64)
