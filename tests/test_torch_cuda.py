"""The port's kernels on a CUDA card, against their plain PyTorch versions.

This file imports no JAX and none of the JAX package, so it runs where the
card is (that machine has no JAX); ``tests/conftest.py`` imports JAX, so
leave it out there:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Every test is marked ``cuda`` and skips without a card.  The CPU tests that
hold the plain versions against the JAX package are in
``tests/test_torch_kernels.py``, ``test_torch_motif_level3.py``,
``test_torch_motif_level4.py``, ``test_torch_graph_conv_kernel.py`` and
``test_torch_large_graph.py``."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from snd_vae_tpu_torch.nn.kernels import adj_matmul as am
from snd_vae_tpu_torch.nn.kernels.adj_matmul import adj_matmul, adj_matmul_backward_plain, \
    adj_matmul_plain, blocked_adj_matmul, fused_adj_matmul_backward
from snd_vae_tpu_torch.nn.kernels.motif_combine import fused_motif_combine, \
    motif_combine_plain
from snd_vae_tpu_torch.nn.kernels.motif_level3 import fused_motif_level3, \
    fused_motif_level3_backward, motif_level3, motif_level3_backward_plain, motif_level3_plain
from snd_vae_tpu_torch.nn.kernels.motif_level4 import fused_motif_level4, \
    fused_motif_level4_backward, motif_level4_backward_plain, motif_level4_plain
from snd_vae_tpu_torch.parallel import initialize_distributed, make_mesh
from snd_vae_tpu_torch.parallel import large_graph as lg

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernels compile only there)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _motif_inputs(rng, B, N, h, dtype=np.float32):
    adj = np.triu((rng.random((B, N, N)) < 0.4).astype(dtype), 1)
    adj = adj + adj.transpose(0, 2, 1)
    return (adj, rng.standard_normal((B, N, h)).astype(dtype),
            rng.standard_normal((B, N, N, h)).astype(dtype),
            rng.standard_normal((B, N, h)).astype(dtype),
            rng.standard_normal((B, N, N, h)).astype(dtype),
            rng.standard_normal((h,)).astype(dtype))


def _level3_inputs(rng, B, N, h, R, weighted=False):
    """adj, φ(rel), a_i, v_j, deg, M1d, M1f, bias as numpy float64."""
    adj = np.triu((rng.random((B, N, N)) < 0.4).astype(np.float64), 1)
    adj = adj + np.swapaxes(adj, 1, 2)
    if weighted:
        adj = adj * rng.random((B, N, N))
        adj = (adj + np.swapaxes(adj, 1, 2)) / 2
    rel = rng.standard_normal((B, N, N, R))
    rel = (rel + np.swapaxes(rel, 1, 2)) / 2
    draw = lambda *s: rng.standard_normal(s)
    return [adj, np.maximum(rel, 0.2 * rel), draw(B, N, h), draw(B, N, h), adj.sum(-1),
            draw(R, h), draw(R, h), draw(h)]


def test_cuda_kernels_match_plain_versions():
    """On the card: each kernel against its plain version (f32 at 1e-5)."""
    _card()
    rng = np.random.default_rng(0)
    inputs = [t.cuda() for t in _t(_motif_inputs(rng, 4, 29, 37))]
    n0 = fused_motif_combine.launches
    got = fused_motif_combine(*inputs)
    torch.cuda.synchronize()
    assert fused_motif_combine.launches == n0 + 1
    torch.testing.assert_close(got, motif_combine_plain(*inputs), rtol=1e-5, atol=1e-5)
    adj = torch.from_numpy(rng.standard_normal((3, 45, 70)).astype(np.float32)).cuda()
    x = torch.from_numpy(rng.standard_normal((3, 70, 33)).astype(np.float32)).cuda()
    torch.testing.assert_close(blocked_adj_matmul(adj, x, leak=0.2),
                               adj_matmul_plain(adj, x, leak=0.2), rtol=1e-5, atol=1e-5)
    # the autograd wrapper launches the kernel forward and the backward
    # kernel backward, and passes gradients back
    n0, b0 = blocked_adj_matmul.launches, fused_adj_matmul_backward.launches
    xg = x.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(adj_matmul(adj, xg, leak=0.2).sum(), [xg])
    torch.cuda.synchronize()
    assert blocked_adj_matmul.launches == n0 + 1
    assert fused_adj_matmul_backward.launches == b0 + 1
    xp = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(adj_matmul_plain(adj, xp, leak=0.2).sum(), [xp])
    torch.testing.assert_close(gx, want, rtol=1e-5, atol=1e-5)


def test_cuda_kernel_matches_plain_version():
    """On the card: ``motif_level3`` against its plain version at ragged N
    and h with R = 2 and a weighted A (one tile of j and k), f32 at
    rtol/atol 1e-5; and at N = 70, h = 75 (several j-tiles, k-chunks and h
    chunks) against the plain version in float64, within (2N + 2R +
    10)·2^-24 times the sum of the terms' magnitudes (the f32 rounding of
    the k-sum, the R-sums and the j-sum; lrelu is 1-Lipschitz)."""
    _card()
    rng = np.random.default_rng(0)
    for B, N, h, R, weighted in ((3, 29, 37, 2, True), (2, 70, 75, 1, False)):
        ts = [t.float().cuda() for t in _t(_level3_inputs(rng, B, N, h, R, weighted))]
        n0 = fused_motif_level3.launches
        got = fused_motif_level3(*ts)
        torch.cuda.synchronize()
        assert fused_motif_level3.launches == n0 + 1
        if N < 32:
            torch.testing.assert_close(got, motif_level3_plain(*ts), rtol=1e-5, atol=1e-5)
        x64 = [t.double() for t in ts]
        err = (got.double() - motif_level3_plain(*x64)).abs()
        mag = motif_level3_plain(*[t.abs() for t in x64])
        assert bool((err <= (2 * N + 2 * R + 10) * 2.0 ** -24 * mag).all())


def test_cuda_kernel_row_windows_match_the_rows():
    """On the card: ``fused_motif_level3``'s row windows (the rows of each
    of m = 2 and 4 model ranks of an uneven N, ``node_block``'s split) held
    against ``_level3_rows`` on those rows, f32 within the summation bound
    of float64 and bf16 within 2e-2 of the largest magnitude, one launch
    each; the windows put together equal the full launch bit for bit."""
    from snd_vae_tpu_torch.nn.kernels.motif_level3 import _level3_rows
    from snd_vae_tpu_torch.parallel.mesh import node_block

    _card()
    rng = np.random.default_rng(1)
    for B, N, h, R in ((5, 25, 50, 1), (2, 70, 75, 2)):
        x64 = _t(_level3_inputs(rng, B, N, h, R))
        for dt in (torch.float32, torch.bfloat16):
            ts = [t.to(dt).cuda() for t in x64]
            full = fused_motif_level3(*ts)
            for m in (2, 4):
                parts = []
                for r in range(m):
                    r0, n = node_block(N, m, r)
                    win = [ts[0], ts[1][:, r0:r0 + n].contiguous(),
                           ts[2][:, r0:r0 + n].contiguous(), *ts[3:]]
                    n0 = fused_motif_level3.launches
                    got = fused_motif_level3(*win, r0)
                    torch.cuda.synchronize()
                    assert fused_motif_level3.launches == n0 + 1
                    rows = lambda w: _level3_rows(w[0], w[0][:, r0:r0 + n], *w[1:])
                    if dt == torch.float32:
                        w64 = [t.double() for t in win]
                        err = (got.double() - rows(w64)).abs()
                        mag = rows([t.abs() for t in w64])
                        assert bool((err <= (2 * N + 2 * R + 10) * 2.0 ** -24 * mag).all())
                    else:
                        want = rows(win).float()
                        err = (got.float() - want).abs().max().item()
                        assert err <= 2e-2 * want.abs().max().item()
                    parts.append(got)
                assert torch.equal(torch.cat(parts, dim=1), full)


MODEL_NEEDS = (False, False, True, True, False, True, True, True)


def _held_to_f64(got, g, ts, row0, needs=(True,) * 8):
    """Each gradient ``needs`` asks for within (its longest sum + 8)·2^-24
    times the plain version on the inputs' magnitudes (the worst-case
    rounding of an f32 sum of that many terms) of the plain version in
    float64; None where not asked."""
    B, n, N, R = ts[1].shape
    h = ts[2].shape[-1]
    w64 = [t.double() for t in ts]
    want = motif_level3_backward_plain(g.double(), *w64, row0=row0)
    mag = motif_level3_backward_plain(g.double().abs(), *[t.abs() for t in w64], row0=row0)
    depth = N + 2 * R + 8
    terms = (depth + n * R + h, depth + N + h, depth + N, depth + n, depth + n * h,
             *(depth + B * n * N,) * 3)
    for got_i, want_i, mag_i, k, need in zip(got, want, mag, terms, needs):
        assert (got_i is None) != need
        if need:
            assert got_i.dtype == torch.float32 and got_i.shape == want_i.shape
            assert bool(((got_i.double() - want_i).abs() <= (k + 8) * 2.0 ** -24 * mag_i).all())


@pytest.mark.parametrize("B,N,h,R,n,row0,weighted", [
    (4, 25, 50, 1, 25, 0, False), (3, 29, 37, 2, 29, 0, True), (2, 72, 75, 2, 31, 20, False),
    (2, 40, 70, 5, 40, 0, True), (2, 72, 75, 2, 72, 0, False), (2, 256, 50, 1, 256, 0, False),
    (100, 25, 20, 1, 25, 0, False)])
def test_cuda_backward_pair_matches_plain_version(B, N, h, R, n, row0, weighted):
    """On the card: the level-3 backward against its closed-form plain
    version in float64 for all eight gradients, each within its summation
    bound (``_held_to_f64``); one count per call; each subset of gradients
    asked for (the model's, ∂A alone, ∂φ with ∂deg, ∂a_i and ∂v_j alone,
    the bias alone, ∂deg alone) gets exactly those, equal to the full call's
    bit for bit; the autograd wrapper launches the kernel and no autograd
    chain.  Shapes: the served one tile, ragged N and h with a weighted A, a
    row window with several j-tiles and h chunks, R = 5 (two channel
    groups), N = 72 and 256 (more row tiles than one cluster holds: five
    and 16 clusters a tree, their sums through L2), and the served B = 100
    trees at h = 20 (one h column per lane)."""
    _card()
    rng = np.random.default_rng(2)
    x64 = _t(_level3_inputs(rng, B, N, h, R, weighted))
    x64[1], x64[2] = x64[1][:, row0:row0 + n].contiguous(), x64[2][:, row0:row0 + n].contiguous()
    g64 = torch.from_numpy(rng.standard_normal((B, n, h)))
    ts, g = [t.float().cuda() for t in x64], g64.float().cuda()
    n0 = fused_motif_level3_backward.launches
    got = fused_motif_level3_backward(g, *ts, row0=row0)
    torch.cuda.synchronize()
    assert fused_motif_level3_backward.launches == n0 + 1
    _held_to_f64(got, g, ts, row0)
    for needs in (MODEL_NEEDS, (True, False, False, False, False, False, False, False),
                  (False, True, False, False, True, False, False, False),
                  (False, False, True, True, False, False, False, False),
                  (False, False, False, False, False, False, False, True),
                  (False, False, False, False, True, False, False, False)):
        part = fused_motif_level3_backward(g, *ts, row0=row0, needs=needs)
        for p, full, need in zip(part, got, needs):
            assert (p is None) != need
            if need:
                torch.testing.assert_close(p, full, rtol=0, atol=0)
    leaves = [t.clone().requires_grad_(True) for t in ts]
    n0 = fused_motif_level3_backward.launches
    grads = torch.autograd.grad(motif_level3(*leaves, row0=row0), leaves, g)
    assert fused_motif_level3_backward.launches == n0 + 1
    for a, b in zip(grads, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cuda_backward_windows_and_repeats():
    """On the card, at synthetic2's layer 2 ([100,25,25,50], R = 1): the
    mesh's row windows (every rank's rows at m = 2 and 4, ``node_block``)
    for the model's gradients and all eight, each within its summation
    bound of float64; two calls bit-equal; a call after calls with other
    numbers of trees (B = 3 and 1, so other block counts reach the election
    counter) bit-equal to the first, so the counter reset itself; the same
    at [4,256,256,50] (16 clusters a tree: the per-tree counters) with a
    call at B = 2 between."""
    from snd_vae_tpu_torch.parallel.mesh import node_block

    _card()
    rng = np.random.default_rng(4)
    ts = [t.float().cuda() for t in _t(_level3_inputs(rng, 100, 25, 50, 1))]
    for m in (2, 4):
        for k in range(m):
            row0, n = node_block(25, m, k)
            win = [ts[0], ts[1][:, row0:row0 + n].contiguous(),
                   ts[2][:, row0:row0 + n].contiguous(), *ts[3:]]
            g = torch.from_numpy(rng.standard_normal((100, n, 50))).float().cuda()
            for needs in (MODEL_NEEDS, (True,) * 8):
                _held_to_f64(fused_motif_level3_backward(g, *win, row0=row0, needs=needs),
                             g, win, row0, needs)
    g = torch.from_numpy(rng.standard_normal((100, 25, 50))).float().cuda()
    first = fused_motif_level3_backward(g, *ts, needs=MODEL_NEEDS)
    again = fused_motif_level3_backward(g, *ts, needs=MODEL_NEEDS)
    for B in (3, 1):
        small = [ts[0][:B], ts[1][:B], ts[2][:B], ts[3][:B], ts[4][:B], *ts[5:]]
        _held_to_f64(fused_motif_level3_backward(g[:B], *small, needs=MODEL_NEEDS),
                     g[:B], small, 0, MODEL_NEEDS)
    after = fused_motif_level3_backward(g, *ts, needs=MODEL_NEEDS)
    for a, b, c in zip(first, again, after):
        assert (a is None) == (b is None) == (c is None)
        if a is not None:
            assert torch.equal(a, b) and torch.equal(a, c)
    ts = [t.float().cuda() for t in _t(_level3_inputs(rng, 4, 256, 50, 1))]
    g = torch.from_numpy(rng.standard_normal((4, 256, 50))).float().cuda()
    for needs in (MODEL_NEEDS, (True,) * 8):
        first = fused_motif_level3_backward(g, *ts, needs=needs)
        _held_to_f64(first, g, ts, 0, needs)
        again = fused_motif_level3_backward(g, *ts, needs=needs)
        small = [ts[0][:2], ts[1][:2], ts[2][:2], ts[3][:2], ts[4][:2], *ts[5:]]
        _held_to_f64(fused_motif_level3_backward(g[:2], *small, needs=needs),
                     g[:2], small, 0, needs)
        after = fused_motif_level3_backward(g, *ts, needs=needs)
        for a, b, c in zip(first, again, after):
            assert (a is None) == (b is None) == (c is None)
            if a is not None:
                assert torch.equal(a, b) and torch.equal(a, c)


def test_cuda_backward_pair_bf16():
    """On the card: the backward on bf16 inputs, each gradient in bf16
    within 2e-2 of the largest magnitude of the f32 plain version on the
    same (bf16-rounded) inputs, all eight and the model's, at 6 and at the
    served 100 trees."""
    _card()
    rng = np.random.default_rng(3)
    for B in (6, 100):
        ts = [t.to(torch.bfloat16).cuda() for t in _t(_level3_inputs(rng, B, 25, 50, 1))]
        g = torch.from_numpy(rng.standard_normal((B, 25, 50))).to(torch.bfloat16).cuda()
        want = motif_level3_backward_plain(g.float(), *[t.float() for t in ts])
        for needs in ((True,) * 8, MODEL_NEEDS):
            got = fused_motif_level3_backward(g, *ts, needs=needs)
            for a, b, need in zip(got, want, needs):
                if not need:
                    assert a is None
                    continue
                assert a.dtype == torch.bfloat16
                assert (a.float() - b).abs().max().item() <= 2e-2 * b.abs().max().item()


def test_cuda_fused_matches_plain():
    """On a card: K3 with GraphConv's W fused, small and tiled, against the
    plain version (f32 at rtol/atol 1e-5)."""
    _card()
    rng = np.random.default_rng(0)
    for B, N, F, H in ((10, 25, 11, 20), (2, 300, 11, 20)):
        adj = (rng.random((B, N, N)) < 0.3).astype(np.float32)
        x = rng.standard_normal((B, N, F)).astype(np.float32)
        w = (0.5 * rng.standard_normal((F, H))).astype(np.float32)
        adj, x, w = (torch.from_numpy(t).cuda() for t in (adj, x, w))
        torch.testing.assert_close(am.blocked_adj_matmul(adj, x, 0.2, w),
                                   am.adj_matmul_plain(adj, x, 0.2, w), rtol=1e-5, atol=1e-5)


def _k3_backward_inputs(rng, a_shape, f, h, zero_rows=0):
    """adj (density 0.3, its first ``zero_rows`` rows all zero: y = 0 there,
    the tie), x [.., M, F or H], W [F, H] or None, and the upstream
    gradient, as float64 tensors on the card."""
    adj = (rng.random(a_shape) < 0.3).astype(np.float64)
    adj[..., :zero_rows, :] = 0.0
    x = rng.standard_normal(a_shape[:-2] + (a_shape[-1], h if f is None else f))
    w = None if f is None else 0.5 * rng.standard_normal((f, h))
    g = rng.standard_normal(a_shape[:-1] + (h,))
    return [None if t is None else torch.from_numpy(t).cuda() for t in (adj, x, w, g)]


# (A shape, F or None, H): the served GraphConvs of synthetic2 and protein,
# a graph with zero rows, the fused tiled variant and an unfused ragged one
K3_BACKWARD_CASES = [((10, 25, 25), 1, 10), ((10, 25, 25), 11, 20), ((50, 50, 50), 11, 20),
                     ((2, 300, 300), 11, 20), ((3, 45, 70), None, 33), ((130, 70), 20, 9)]


@pytest.mark.parametrize("a_shape,f,h", K3_BACKWARD_CASES)
def test_cuda_adj_matmul_backward_matches_plain(a_shape, f, h):
    """On a card: K3's backward (∂A, ∂x, ∂W) against its closed form,
    ``adj_matmul_backward_plain``, on the same inputs: f32 against the
    closed form in float64 within (M + F + 8)·2^-24 times the closed form
    on |inputs| (the f32 sums over i, then over H for ∂x and over B·M for
    ∂W, the ∂A sum over H; each within M + F + B·M terms, bounded below by
    the looser count), bf16 within 2e-2 of the largest magnitude; one count
    per call; two calls bit-equal."""
    _card()
    rng = np.random.default_rng(3)
    adj, x, w, g = _k3_backward_inputs(rng, a_shape, f, h, zero_rows=2)
    batch = a_shape[0] if len(a_shape) == 3 else 1
    terms = {0: h + (f or 0), 1: a_shape[-2] + h, 2: a_shape[-2] + batch * a_shape[-1]}
    for dt in (torch.float32, torch.bfloat16):
        a_, x_, g_ = adj.to(dt), x.to(dt), g.to(dt)
        w_ = None if w is None else w.to(dt)
        out = blocked_adj_matmul(a_, x_, 0.2, w_)
        b0 = fused_adj_matmul_backward.launches
        got = fused_adj_matmul_backward(g_, a_, x_, out, 0.2, w_, (True, True, True))
        torch.cuda.synchronize()
        assert fused_adj_matmul_backward.launches == b0 + 1
        again = fused_adj_matmul_backward(g_, a_, x_, out, 0.2, w_, (True, True, True))
        assert all(u is None or torch.equal(u, v) for u, v in zip(got, again))
        if dt == torch.float32:
            f64 = lambda t: None if t is None else t.double()
            want = adj_matmul_backward_plain(g_.double(), a_.double(), x_.double(), out.double(),
                                             0.2, f64(w_))
            mag = adj_matmul_backward_plain(g_.double().abs(), a_.double(), x_.double().abs(),
                                            out.double(), 0.2, None if w_ is None else
                                            w_.double().abs())
            for k, (a, b, c) in enumerate(zip(got, want, mag)):
                if b is None:
                    assert a is None
                    continue
                assert a.dtype == dt and a.shape == b.shape
                lim = (terms[k] + 8) * 2.0 ** -24 * c.abs()
                err = (a.double() - b).abs()
                assert bool((err <= lim).all()), (k, err.max().item())
        else:
            want = adj_matmul_backward_plain(g_, a_, x_, out, 0.2, w_)
            for a, b in zip(got, want):
                if b is None:
                    assert a is None
                    continue
                assert a.dtype == dt
                err = (a.float() - b.float()).abs().max().item()
                assert err <= 2e-2 * b.float().abs().max().item()


def test_cuda_adj_matmul_backward_subsets_and_graph_conv():
    """On a card: each subset of (∂A, ∂x, ∂W) gives the same gradients as
    all three (bit for bit), only those asked; GraphConv's backward is one
    launch of the backward kernel per layer and none of the plain version;
    without W and with an identity act it is the plain transpose product."""
    from snd_vae_tpu_torch import nn as tops

    _card()
    rng = np.random.default_rng(4)
    adj, x, w, g = (t.float() for t in _k3_backward_inputs(rng, (10, 25, 25), 11, 20, 1))
    out = blocked_adj_matmul(adj, x, 0.2, w)
    full = fused_adj_matmul_backward(g, adj, x, out, 0.2, w, (True, True, True))
    for needs in ((False, False, True), (False, True, True), (False, True, False),
                  (True, False, False)):
        got = fused_adj_matmul_backward(g, adj, x, out, 0.2, w, needs)
        for need, a, b in zip(needs, got, full):
            assert (a is None) if not need else torch.equal(a, b)
    conv = tops.GraphConv(11, 20, torch.Generator().manual_seed(0)).cuda()
    xg = x.clone().requires_grad_(True)
    b0, p0 = fused_adj_matmul_backward.launches, blocked_adj_matmul.launches
    gx, gw = torch.autograd.grad(conv(adj, xg), [xg, conv.kernel], g)
    torch.cuda.synchronize()
    assert (fused_adj_matmul_backward.launches, blocked_adj_matmul.launches) == (b0 + 1, p0 + 1)
    out = blocked_adj_matmul(adj, x, 0.2, conv.kernel.detach())
    _, wx, ww = adj_matmul_backward_plain(g, adj, x, out, 0.2, conv.kernel.detach())
    # gW sums B·M = 250 products, in another order than the closed form's
    # cuBLAS product: 1e-4
    torch.testing.assert_close(gx, wx, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gw, ww, rtol=1e-4, atol=1e-5)
    xo = torch.randn(3, 70, 33, device="cuda")
    a3 = (torch.rand(3, 45, 70, device="cuda") < 0.3).float()
    g3 = torch.randn(3, 45, 33, device="cuda")
    _, gx3, _ = fused_adj_matmul_backward(g3, a3, xo, None, None, None, (False, True, False))
    torch.testing.assert_close(gx3, a3.transpose(1, 2) @ g3, rtol=1e-5, atol=1e-5)


def _held_to_closed_form(got, g, adj, x, out, w, leak, needs):
    """K3's backward ``got`` against ``adj_matmul_backward_plain`` on the
    same inputs: f32 against float64 within (terms + 8)·2^-24 times the
    closed form on |inputs| (the longest f32 sum behind each gradient: ∂A H
    + F, ∂x N + H, ∂W N + B·M), bf16 within 2e-2 of the largest magnitude."""
    batch = adj.shape[0] if adj.dim() == 3 else 1
    n, m = adj.shape[-2:]
    h = x.shape[-1] if w is None else w.shape[1]
    f = 0 if w is None else w.shape[0]
    terms = (h + f, n + h, n + batch * m)
    if x.dtype == torch.float32:
        f64 = lambda t: None if t is None else t.double()
        want = adj_matmul_backward_plain(g.double(), adj.double(), x.double(), f64(out), leak,
                                         f64(w), needs)
        mag = adj_matmul_backward_plain(g.double().abs(), adj.double(), x.double().abs(),
                                        f64(out), leak, None if w is None else w.double().abs(),
                                        needs)
    else:
        want = adj_matmul_backward_plain(g, adj, x, out, leak, w, needs)
        mag = want
    for k, (a, b, c) in enumerate(zip(got, want, mag)):
        if b is None:
            assert a is None
            continue
        assert a.dtype == x.dtype and a.shape == b.shape
        if x.dtype == torch.float32:
            err = (a.double() - b).abs()
            assert bool((err <= (terms[k] + 8) * 2.0 ** -24 * c.abs()).all()), (k, err.max().item())
        else:
            err = (a.float() - b.float()).abs().max().item()
            assert err <= 2e-2 * b.float().abs().max().item(), (k, err)


# (A shape, F or None, H) of the tiled variants: GraphConv 2 of synthetic2's
# widths at N = 1024 (W fused), the large-graph contraction at N = 2048,
# ragged N, odd strides (cp.async or plain copies in place of TMA), h = 64
# (bf16: the second column box wholly past h) and h = 128 with W (bf16
# fused in one tile, f32 two column tiles and the plain W products)
K3_TILED_CASES = [((2, 1024, 1024), 11, 20), ((2048, 2048), None, 128),
                  ((2047, 2047), None, 100), ((3, 45, 70), None, 33),
                  ((2, 300, 301), 11, 17), ((2, 200, 200), 11, 64), ((2, 130, 130), 11, 128)]
K3_TILED_NEEDS = ((False, True, True), (False, False, True), (False, True, False),
                  (True, True, True))


@pytest.mark.parametrize("leak", [0.2, None])
@pytest.mark.parametrize("a_shape,f,h", K3_TILED_CASES)
def test_cuda_adj_matmul_backward_tiled_variants(a_shape, f, h, leak):
    """On a card: the tiled variants of K3's backward, simt (f32) and tc
    (bf16), against ``adj_matmul_backward_plain`` (f32 within the float64
    summation bound, bf16 within 2e-2) with and without W and act, three
    rows of A all zero (the tie), each subset of the gradients; two calls
    bit-equal, and the election counter back at 0 after each call."""
    from snd_vae_tpu_torch.nn.kernels import _launch

    _card()
    rng = np.random.default_rng(5)
    adj, x, w, g = _k3_backward_inputs(rng, a_shape, f, h, zero_rows=3)
    batch = a_shape[0] if len(a_shape) == 3 else 1
    for dt in (torch.float32, torch.bfloat16):
        a_, x_, g_ = adj.to(dt), x.to(dt), g.to(dt)
        w_ = None if w is None else w.to(dt)
        out = blocked_adj_matmul(a_, x_, leak, w_)
        plan = am.adj_matmul_backward_plan(batch, *a_shape[-2:], h, f, dt)
        assert plan.variant == ("simt" if dt == torch.float32 else "tc")
        for needs in K3_TILED_NEEDS if w is not None else K3_TILED_NEEDS[2:]:
            got = fused_adj_matmul_backward(g_, a_, x_, out, leak, w_, needs)
            again = fused_adj_matmul_backward(g_, a_, x_, out, leak, w_, needs)
            torch.cuda.synchronize()
            assert all(u is None or torch.equal(u, v) for u, v in zip(got, again))
            for counter in _launch._COUNTERS.values():
                assert int(counter.sum().item()) == 0
            _held_to_closed_form(got, g_, a_, x_, out, w_, leak, needs)


def test_cuda_graph_conv_backward_at_1024():
    """On a card: a GraphConv (11 -> 20) over two graphs of N = 1024, its
    loss.backward() one launch of the tiled backward (and one of K3), the
    gradients of x and W held to the closed form."""
    from snd_vae_tpu_torch import nn as tops

    _card()
    rng = np.random.default_rng(6)
    adj, x, _, _ = (t.float() if t is not None else None
                    for t in _k3_backward_inputs(rng, (2, 1024, 1024), 11, 20, zero_rows=3))
    conv = tops.GraphConv(11, 20, torch.Generator().manual_seed(0)).cuda()
    xg = x.clone().requires_grad_(True)
    b0, p0 = fused_adj_matmul_backward.launches, blocked_adj_matmul.launches
    out = conv(adj, xg)
    loss = (out * out).sum()
    loss.backward()
    torch.cuda.synchronize()
    assert (fused_adj_matmul_backward.launches, blocked_adj_matmul.launches) == (b0 + 1, p0 + 1)
    w = conv.kernel.detach()
    _held_to_closed_form((None, xg.grad, conv.kernel.grad), 2 * out.detach(), adj, x,
                         out.detach(), w, 0.2, (False, True, True))


def test_cuda_large_graph_kernel_path_matches_library(tmp_path):
    """On a card, in an NCCL group of one process: the node-sharded encoder
    (hidden 128, 128) at N = 2048 with K3 (2 launches) against the library
    path, f32 at rtol 1e-4 / atol 1e-6 on the pooled vector."""
    _card()
    initialize_distributed(f"file://{tmp_path}/rendezvous", 1, 0)
    try:
        mesh = make_mesh(1, 1)
        g = torch.Generator(device="cuda").manual_seed(0)
        n = 2048
        adj = (torch.rand(n, n, generator=g, device="cuda") < 0.01).float().triu(1)
        adj = lg.sharded_gcn_normalize(adj + adj.T, mesh)
        x = torch.randn(n, 128, generator=g, device="cuda")
        pooled = {}
        for use_kernel in (False, True):
            enc = lg.ShardedGCNEncoder(mesh, (128, 128), 128, torch.Generator().manual_seed(1),
                                       use_kernel=use_kernel).cuda()
            n0 = blocked_adj_matmul.launches
            with torch.no_grad():
                pooled[use_kernel] = enc(adj, x)
            torch.cuda.synchronize()
            assert blocked_adj_matmul.launches == n0 + (2 if use_kernel else 0)
        torch.testing.assert_close(pooled[True], pooled[False], rtol=1e-4, atol=1e-6)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# K4: level 4 of the fourth-order conv and its masked k-sum, and its backward
# --------------------------------------------------------------------------

def _level4_trees(tmp_path, dataset):
    """The preset's seeded spanning trees of one train batch, [B·S,N,N] f32
    on the card: protein's 500 trees, mnist's 20 (hull graphs, whose
    interior points have no edge)."""
    from snd_vae_tpu_torch.config import mnist_preset, protein_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset

    cfg = {"protein": protein_preset, "mnist": mnist_preset}[dataset](
        dataset_path=str(tmp_path / dataset))
    data = load_dataset(cfg, "train", num_graphs=cfg.train.batch_size, device="cuda")
    N = cfg.num_nodes
    return data.adj_samples.reshape(-1, N, N).float().contiguous()


def _level4_inputs(mask, h, seed, rows=None, dtype=torch.float32):
    """mask_i (the rows ``rows`` = (start, n), all by default), mask, deg,
    and pu, alpha, beta, gamma drawn from N(0, 1), on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    T, N = mask.shape[:2]
    s, n = rows or (0, N)
    draw = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    ts = [mask[:, s:s + n].contiguous(), mask, mask.sum(-1), draw(T, n, N, h), draw(T, n, N, h),
          draw(T, N, N, h), draw(T, N, h)]
    return [t.to(dtype) for t in ts]


def _level4_held(ts, grad, tol):
    """K4's forward against the plain chain in float64, and its backward
    against the closed form on the card in the inputs' dtype (the same z,
    rounded as the kernel rounds it, so the same slope of lrelu), each
    element within ``tol`` times the magnitude of its sum (the plain pair
    on the inputs' absolute values: every term counted positive).  Returns
    the kernel's gradients."""
    n0, b0 = fused_motif_level4.launches, fused_motif_level4_backward.launches
    got = fused_motif_level4(*ts)
    grads = fused_motif_level4_backward(grad, *ts)
    torch.cuda.synchronize()
    assert (fused_motif_level4.launches, fused_motif_level4_backward.launches) == (n0 + 1, b0 + 1)
    x64 = [t.double() for t in ts]
    err = (got.double() - motif_level4_plain(*x64)).abs()
    assert bool((err <= tol * motif_level4_plain(*[t.abs() for t in x64])).all())
    del err, x64
    want = motif_level4_backward_plain(grad, *ts)
    mags = motif_level4_backward_plain(grad.float().abs(), *[t.float().abs() for t in ts])
    for name, a, b, m in zip(("pu", "alpha", "beta", "gamma"), grads, want, mags):
        assert a.dtype == ts[3].dtype, name
        assert bool(((a.float() - b.float()).abs() <= tol * m).all()), name
    return grads


@pytest.mark.parametrize("dataset,h", [("protein", 10), ("protein", 20), ("mnist", 50)])
def test_cuda_motif_level4_pair_matches_plain_on_the_trees(tmp_path, dataset, h):
    """On the card: K4 and its backward at protein's two layers (500 trees,
    N = 50, h0 = 10 / 20) and mnist's layer 2 (h0 = 50: two chunks of h),
    one launch each, f32 within (2N + 16)·2^-24 of each sum's magnitude
    (the k-sum's, or a gradient's sum over the paths, rounded in another
    order than the plain version's, and z's four roundings); two backward
    calls bit-equal."""
    _card()
    mask = _level4_trees(tmp_path, dataset)
    ts = _level4_inputs(mask, h, seed=h)
    grad = torch.randn(ts[3].shape, generator=torch.Generator(device="cuda").manual_seed(1),
                       device="cuda")
    grads = _level4_held(ts, grad, (2 * mask.shape[1] + 16) * 2.0 ** -24)
    again = fused_motif_level4_backward(grad, *ts)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("kind", ["dense", "weighted_asymmetric", "zero_rows", "window", "bf16",
                                  "n90"])
def test_cuda_motif_level4_masks_windows_and_bf16(kind):
    """On the card, N = 37 and h = 45 (two chunks of j, k and h, ragged):
    a dense mask, an asymmetric weighted one, trees with rows all zero, a
    window of rows 5-24 (its forward the full launch's rows bit for bit),
    bf16 (f32 arithmetic: within 1e-2 of each sum's magnitude); and trees
    at N = 90 (three chunks of j and k)."""
    _card()
    rng = np.random.default_rng(0)
    B, N, h = 6, 90 if kind == "n90" else 37, 45
    if kind == "dense":
        m = np.ones((B, N, N))
    elif kind == "weighted_asymmetric":
        m = (rng.random((B, N, N)) < 0.3) * rng.random((B, N, N))
    else:
        m = np.zeros((B, N, N))
        for b in range(B):
            for v in range(1, N):
                u = rng.integers(0, v)
                m[b, u, v] = m[b, v, u] = 1.0
        if kind == "zero_rows":
            m[:, [0, 3, 33], :] = 0.0
    mask = torch.from_numpy(m).float().cuda()
    rows = (5, 20) if kind == "window" else None
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    ts = _level4_inputs(mask, h, seed=2, rows=rows, dtype=dtype)
    grad = torch.randn(ts[3].shape, generator=torch.Generator(device="cuda").manual_seed(3),
                       device="cuda").to(dtype)
    _level4_held(ts, grad, 1e-2 if kind == "bf16" else (2 * N + 16) * 2.0 ** -24)
    if kind == "window":
        full = _level4_inputs(mask, h, seed=4)
        full[3][:, 5:25], full[4][:, 5:25] = ts[3], ts[4]
        full[5], full[6] = ts[5], ts[6]
        assert torch.equal(fused_motif_level4(*ts), fused_motif_level4(*full)[:, 5:25])


# --------------------------------------------------------------------------
# The trainer's default dispatch: CUDA-graph replays of the train step
# --------------------------------------------------------------------------

def _graph_trainers(tmp_path, names, graphs=20, compute_dtype="float32", mesh=None, **train):
    """Trainers of synthetic2 at full width on ``graphs`` generated graphs
    (2 steps an epoch), one per name, from the same seed (on ``mesh``)."""
    import dataclasses

    from snd_vae_tpu_torch import train as tt
    from snd_vae_tpu_torch.config import synthetic2_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset

    cfg = synthetic2_preset(dataset_path=str(tmp_path / "dataset"))
    cfg = cfg.with_(compute_dtype=compute_dtype,
                    train=dataclasses.replace(cfg.train, **train))
    data = load_dataset(cfg, "train", num_graphs=graphs, device="cuda")
    return [tt.Trainer(cfg, data, device="cuda", workdir=str(tmp_path / n), mesh=mesh)
            for n in names]


def _logged(trainer):
    got = []
    log = trainer.logger.log
    trainer.logger.log = lambda epoch, storer: (got.append(storer), log(epoch, storer))[1]
    return got


def _train_state(trainer):
    st = trainer.state
    return ([p.detach().clone() for p in st.model.parameters()],
            [{k: v.clone() for k, v in st.optimizer.state[p].items()}
             for p in st.model.parameters()],
            st.step, st.generator.get_state())


def _assert_same_state(a, b):
    (pa, oa, sa, ga), (pb, ob, sb, gb) = a, b
    assert sa == sb
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    assert all(torch.equal(x[k], y[k]) for x, y in zip(oa, ob) for k in x)
    assert torch.equal(ga, gb)


@pytest.mark.parametrize("train", [dict(), dict(reshuffle=True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_graph_epochs_equal_per_step_epochs(tmp_path, dtype, train):
    """Two epochs of the default dispatch (the first step eager, the rest
    replays of its capture) against two of ``per_step=True`` from the same
    seed, and against a second graph run: every aux value, parameter, Adam
    moment and count, the step and the generator bit for bit; each
    replay's loss is its own batch's (with ``reshuffle`` each epoch's
    permuted batches, copied into the graph's static buffers)."""
    _card()
    trainers = _graph_trainers(tmp_path, ("graph", "again", "per_step"), compute_dtype=dtype,
                               **train)
    logs = [_logged(tr) for tr in trainers]
    for tr in trainers:
        tr.run(2, verbose=False, per_step=tr is trainers[2])
    assert logs[0] == logs[1] == logs[2]
    assert all(len(set(log["loss"])) == 2 for log in logs[0])
    for tr in trainers[1:]:
        _assert_same_state(_train_state(trainers[0]), _train_state(tr))


def test_cuda_two_replays_in_a_row_are_equal(tmp_path):
    """One replay from a state, the state put back in place, the same
    replay again: the same aux values and state bit for bit (the kernels'
    election counters are left zero by each launch)."""
    from snd_vae_tpu_torch import train as tt

    _card()
    (tr,) = _graph_trainers(tmp_path, ("graph",))
    graph = tt.StepGraph(tr, 4)
    tr.graph_epochs(graph, range(0, 1))          # the eager step, the capture, a replay
    snap = _train_state(tr)
    runs = []
    for _ in range(2):
        params, adam, step, gen = snap
        for p, q, s, t in zip(tr.state.model.parameters(), params,
                              (tr.state.optimizer.state[p] for p in tr.state.model.parameters()),
                              adam):
            with torch.no_grad():
                p.copy_(q)
            for k in s:
                s[k].copy_(t[k])
        tr.state.step = step
        tr.state.generator.set_state(gen)
        graph.begin()
        graph.load(tr.batched)
        graph.step()
        torch.cuda.synchronize()
        runs.append((graph.aux[0].clone(), _train_state(tr)))
    assert torch.equal(runs[0][0], runs[1][0])
    _assert_same_state(runs[0][1], runs[1][1])
    assert graph.graph is not None


def test_cuda_protein_replayed_step_equals_eager_step(tmp_path):
    """Protein (the fourth-order conv through K4): an epoch of 2 steps by
    the default dispatch (the first step eager, then the capture and one
    replay of it) against 2 eager steps from the same seed, every aux
    value, parameter, Adam moment, the step and the generator bit for bit;
    2 launches of K4 and 2 of its backward a step."""
    from snd_vae_tpu_torch import train as tt
    from snd_vae_tpu_torch.config import protein_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset

    _card()
    cfg = protein_preset(dataset_path=str(tmp_path / "dataset"))
    data = load_dataset(cfg, "train", num_graphs=2 * cfg.train.batch_size, device="cuda")
    trainers = [tt.Trainer(cfg, data, device="cuda", workdir=str(tmp_path / n))
                for n in ("graph", "per_step")]
    logs = [_logged(tr) for tr in trainers]
    n0, b0 = fused_motif_level4.launches, fused_motif_level4_backward.launches
    trainers[1].run(1, verbose=False, per_step=True)
    assert (fused_motif_level4.launches - n0, fused_motif_level4_backward.launches - b0) == (4, 4)
    trainers[0].run(1, verbose=False)
    assert logs[0] == logs[1]
    _assert_same_state(_train_state(trainers[0]), _train_state(trainers[1]))


def test_cuda_uncapturable_step_raises(tmp_path, monkeypatch):
    """A step that reads a device value on the host (legal eagerly, not
    under capture): the run takes its first step eagerly, then the capture
    raises naming where it failed, and nothing trains per step instead."""
    from snd_vae_tpu_torch import train as tt

    _card()
    (tr,) = _graph_trainers(tmp_path, ("graph",))
    step = tt.train_step
    monkeypatch.setattr(tt, "train_step",
                        lambda st, b, gi: (float(gi), step(st, b, gi))[1])
    monkeypatch.setattr(tr, "run_epoch", lambda epoch: pytest.fail("ran per step"))
    with pytest.raises(RuntimeError, match="capturing the train step as a CUDA graph failed"):
        tr.run(1, verbose=False)
    assert tr.state.step == 1


def test_cuda_graph_on_mesh_of_one_equals_per_step(tmp_path):
    """The default dispatch on ``make_mesh(1, 1)`` (an NCCL group of one:
    the step's collectives become NCCL kernels in the captured graph)
    against ``per_step=True`` on the same mesh, 2 epochs from the same seed:
    every aux value, parameter, Adam moment and count, the step and the
    generator bit for bit; the graph's kernel and copy nodes are counted."""
    from snd_vae_tpu_torch import train as tt

    _card()
    initialize_distributed(f"file://{tmp_path}/rendezvous", 1, 0)
    try:
        mesh = make_mesh(1, 1)
        trainers = _graph_trainers(tmp_path, ("graph", "per_step"), mesh=mesh)
        logs = [_logged(tr) for tr in trainers]
        made = []
        step_graph = tt.StepGraph
        tt.StepGraph = lambda *a: made.append(step_graph(*a)) or made[-1]
        try:
            for tr in trainers:
                tr.run(2, verbose=False, per_step=tr is trainers[1])
        finally:
            tt.StepGraph = step_graph
        assert logs[0] == logs[1] and len(made) == 1
        _assert_same_state(_train_state(trainers[0]), _train_state(trainers[1]))
        assert made[0].replays == 3 and made[0].kernels_per_replay > 100
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("epochs", [2, 1])
def test_cuda_profiled_replayed_epoch_on_mesh_misses_no_record(tmp_path, epochs):
    """``profile_dir`` on the default dispatch under ``make_mesh(1, 1)``:
    the trace of epoch 1's 2 replays, or, with one epoch, of the eager first
    step, the capture and one replay, holds a device record of every kernel
    launched eagerly and of every kernel and copy node of each replay."""
    import json

    _card()
    initialize_distributed(f"file://{tmp_path}/rendezvous", 1, 0)
    try:
        mesh = make_mesh(1, 1)
        (tr,) = _graph_trainers(tmp_path, ("graph",), mesh=mesh)
        tr.run(epochs, verbose=False, profile_dir=str(tmp_path / "profile"))
        written = json.loads((tmp_path / "profile" / "trace_rank0.launches.json").read_text())
        assert written["graph_replays"] == (2 if epochs == 2 else 1)
        assert written["kernels_per_replay"] > 100 and written["host_launches"] > 0
        assert written["launches_without_device_record"] == 0
    finally:
        dist.destroy_process_group()


def test_cuda_failing_run_on_mesh_leaves_no_live_graph(tmp_path, monkeypatch):
    """A default-dispatch run on ``make_mesh(1, 1)`` that raises after its
    capture (here its first checkpoint's save) frees the captured graph
    before the error leaves ``Trainer.run``: with the error's traceback
    still held, no ``torch.cuda.CUDAGraph`` made by the run is alive, so
    the process group's teardown meets none (``ROADMAP.md`` §3, fault
    3.8)."""
    import gc

    from snd_vae_tpu_torch import train as tt

    _card()
    initialize_distributed(f"file://{tmp_path}/rendezvous", 1, 0)
    try:
        mesh = make_mesh(1, 1)
        (tr,) = _graph_trainers(tmp_path, ("graph",), mesh=mesh)
        gc.collect()
        before = sum(isinstance(o, torch.cuda.CUDAGraph) for o in gc.get_objects())
        made = []
        step_graph = tt.StepGraph
        monkeypatch.setattr(tt, "StepGraph", lambda *a: made.append(step_graph(*a)) or made[-1])

        def fail(epoch):
            raise OSError("no space left on device")

        monkeypatch.setattr(tr, "_save", fail)
        with pytest.raises(OSError, match="no space left") as info:
            tr.run(2, verbose=False)
        gc.collect()
        live = sum(isinstance(o, torch.cuda.CUDAGraph) for o in gc.get_objects())
        assert info.tb is not None and len(made) == 1 and made[0].replays == 1
        assert made[0].graph is None and made[0].grads is None and live == before
    finally:
        dist.destroy_process_group()


# Spans inside the port: the stamp kernel and the stamped graph
# --------------------------------------------------------------------------

def test_cuda_stamp_kernel_writes_its_row():
    """``span_stamp_kernel`` writes the card's ``%globaltimer`` at [row, k],
    the row read on the card: later stamps read later, the other rows stay
    zero, and a row outside the buffer writes nothing."""
    from snd_vae_tpu_torch import spans

    _card()
    stamps = spans.Stamps(3, torch.ones((), dtype=torch.int64, device="cuda"))
    with spans.stamping(stamps):
        spans.stamp("step.start")
        torch.cuda._sleep(1_000_000)
        spans.stamp("step.end")
        stamps.row.fill_(5)
        spans.stamp("train_step.forward")
    t = stamps.times.cpu()
    start, end = t[1, spans.INDEX["step.start"]], t[1, spans.INDEX["step.end"]]
    assert 0 < start < end and int((t != 0).sum()) == 2 and stamps.launched == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_stamped_graph_adds_its_stamps_alone(tmp_path, dtype):
    """Two epochs through a ``StepGraph`` with stamps and through one
    without, from the same seed: every aux value, parameter, Adam moment
    and count, the step and the generator bit for bit; the graph without
    stamps has no stamp nodes, the stamped one the same kernel and copy
    nodes and ``len(STAMPS)`` kernel nodes more.  In each step (the eager
    first, then replays) the stamps do not decrease, and forward, backward
    and optimizer lie inside the step's extent and cover 90% of it."""
    from snd_vae_tpu_torch import spans
    from snd_vae_tpu_torch import train as tt

    _card()
    trainers = _graph_trainers(tmp_path, ("plain", "stamped"), compute_dtype=dtype)
    plain, stamped = graphs = [tt.StepGraph(tr, 2 * tr.batched.adj.shape[0]) for tr in trainers]
    stamped.stamps = spans.Stamps(stamped.rows, stamped.row)
    out = [tr.graph_epochs(g, range(0, 2)) for tr, g in zip(trainers, graphs)]
    assert out[0] == out[1]
    _assert_same_state(_train_state(trainers[0]), _train_state(trainers[1]))
    assert plain.stamps_per_replay == 0 and stamped.stamps_per_replay == len(spans.STAMPS)
    assert (stamped.kernels_per_replay, stamped.copies_per_replay) == (
        plain.kernels_per_replay, plain.copies_per_replay)
    nodes = [tt.graph_device_nodes(g.graph.raw_cuda_graph())["kernel"] for g in graphs]
    assert nodes == [plain.kernels_per_replay, plain.kernels_per_replay + len(spans.STAMPS)]
    t = trainers[1].last_stamps
    assert t.shape == (4, len(spans.STAMPS)) and (t > 0).all()
    assert (np.diff(t, axis=1) >= 0).all() and (t[1:, 0] >= t[:-1, -1]).all()
    k = spans.INDEX
    extent = t[:, k["step.end"]] - t[:, k["step.start"]]
    phases = t[:, k["train_step.end"]] - t[:, k["train_step.forward"]]
    assert (phases <= extent).all() and (phases >= 0.9 * extent).all()
    for g in graphs:
        g.release()
