"""The port's level-3 kernel ``motif_level3`` (φ(rel) to the masked j-sum in
one launch) against the JAX package: its default rank-R path and dense
oracle in float64, the Pallas motif-combine kernel (interpret mode) in f32,
and ``jax.vjp`` for the gradients; its backward's closed form
(``motif_level3_backward_plain``) against ``jax.vjp`` and autograd through
the plain level 3.  On the CPU the wrappers return their plain PyTorch
versions; the CUDA kernels run only where there is a card, in
``tests/test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ops import exact_f64  # noqa: F401  (fixture)

from snd_vae_tpu import nn as jops
from snd_vae_tpu_torch import nn as tops
from snd_vae_tpu_torch.nn.kernels.motif_combine import motif_combine_plain
from snd_vae_tpu_torch.nn.kernels.motif_level3 import (
    MAX_CLUSTER,
    NAMES,
    ROW_TILE,
    SPLIT_CLUSTER,
    _level3_rows,
    fused_motif_level3,
    fused_motif_level3_backward,
    motif_level3,
    motif_level3_backward_plain,
    motif_level3_backward_plan,
)


def _graph(rng, B, N, F, R, weighted=False):
    adj = np.triu((rng.random((B, N, N)) < 0.4).astype(np.float64), 1)
    adj = adj + np.swapaxes(adj, 1, 2)
    if weighted:
        adj = adj * rng.random((B, N, N))
        adj = (adj + np.swapaxes(adj, 1, 2)) / 2
    x = rng.standard_normal((B, N, F))
    rel = rng.standard_normal((B, N, N, R))
    return adj, x, (rel + np.swapaxes(rel, 1, 2)) / 2


def _level3_inputs(rng, B, N, h, R, weighted=False):
    """adj, φ(rel), a_i, v_j, deg, M1d, M1f, bias as numpy float64."""
    adj, _, rel = _graph(rng, B, N, 1, R, weighted)
    draw = lambda *s: rng.standard_normal(s)
    return [adj, np.maximum(rel, 0.2 * rel), draw(B, N, h), draw(B, N, h), adj.sum(-1),
            draw(R, h), draw(R, h), draw(h)]


def _window_inputs(rng, B, N, h, R, n, row0, directed=False):
    """``_level3_inputs`` with a weighted A (asymmetric with ``directed``)
    and φ(rel), a_i cut to the window of rows [row0, row0 + n)."""
    x = _level3_inputs(rng, B, N, h, R, weighted=True)
    if directed:
        x[0] = x[0] * rng.random((B, N, N)) * 4
        x[4] = x[0].sum(-1)
    x[1], x[2] = x[1][:, row0:row0 + n], x[2][:, row0:row0 + n]
    return x


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_level3(adj, phi_r, a_i, v_j, deg, m1d, m1f, bias):
    """Level 3 as the JAX default path writes it (snd_vae_tpu/nn/spatial_conv.py
    :208-238, with b_j, neigh_c and ve folded into v_j), from the package's
    own lrelu.  Its einsums ask for f32 accumulation, as the package's do."""
    f32 = dict(preferred_element_type=jnp.float32)
    rf = jnp.einsum("bjk,bikr->bijr", adj, phi_r, **f32).astype(adj.dtype)
    d_ij = jnp.einsum("...f,fo->...o", phi_r, m1d, **f32).astype(adj.dtype)
    wf = jnp.einsum("...f,fo->...o", rf, m1f, **f32).astype(adj.dtype)
    m3 = deg[:, None, :, None] * (a_i[:, :, None] + d_ij + bias) + v_j[:, None] + wf
    m3 = adj[..., None] * m3
    return jnp.einsum("bij,bijh->bih", adj, jops.lrelu(m3), **f32).astype(adj.dtype)


def _old_chain(adj, phi_r, a_i, v_j, deg, m1d, m1f, bias):
    """What the served path ran before: the d_ij / f_ik projections, the
    motif combine (deg recomputed from adj inside), lrelu and the j-sum."""
    m3 = motif_combine_plain(adj, a_i, phi_r @ m1d, v_j, phi_r @ m1f, bias)
    return torch.einsum("bij,bijh->bih", adj, tops.lrelu(m3))


@pytest.mark.parametrize("F,R,N,weighted", [(3, 1, 13, False), (2, 2, 13, True)])
def test_spatial_graph_conv_matches_jax_default_f64(rng, key, exact_f64, F, R, N, weighted):
    """The port's conv (level 3 through motif_level3's plain version) equals
    the JAX default rank-R path and the dense oracle at rtol 1e-9, at an N
    that is no multiple of 8 (test_torch_ops.py::test_spatial_graph_conv
    holds N = 7)."""
    adj, x, rel = _graph(rng, 2, N, F, R, weighted)
    jm = jops.SpatialGraphConv(hidden=(5, 4, 3))
    p = jm.init(key, *(jnp.asarray(a, jnp.float32) for a in (adj, x, rel)))["params"]
    p = jax.tree.map(lambda t: rng.standard_normal(t.shape), p)
    jargs = tuple(map(jnp.asarray, (adj, x, rel)))
    want = np.asarray(jops.spatial_graph_conv(*jargs, p))
    oracle = np.asarray(jops.spatial_graph_conv_dense_oracle(*jargs, p))
    got = tops.spatial_graph_conv(*_t([adj, x, rel]), {k: torch.from_numpy(v)
                                                       for k, v in p.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got, oracle, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("N,h,R,weighted", [(7, 5, 1, False), (7, 5, 2, False),
                                            (9, 4, 2, True), (13, 6, 1, False)])
def test_level3_matches_old_composition_f64(rng, N, h, R, weighted):
    """motif_level3 equals the chain it replaced on the served path, in float64."""
    ts = _t(_level3_inputs(rng, 2, N, h, R, weighted))
    got = motif_level3(*ts)
    assert got.shape == (2, N, h) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), _old_chain(*ts).numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(fused_motif_level3(*ts).numpy(), got.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("F,R,N", [(1, 1, 10), (2, 2, 13)])
def test_spatial_graph_conv_matches_pallas_f32(rng, key, F, R, N):
    """The whole f32 conv against JAX's use_pallas=True branch, whose level 3
    runs the Pallas motif-combine kernel in interpret mode, at rtol/atol 1e-5
    (f32 sums in another order)."""
    adj, x, rel = (a.astype(np.float32) for a in _graph(rng, 2, N, F, R))
    jm = jops.SpatialGraphConv(hidden=(5, 4, 3))
    p = jm.init(key, *map(jnp.asarray, (adj, x, rel)))["params"]
    p = jax.tree.map(lambda t: (0.5 * rng.standard_normal(t.shape)).astype(np.float32), p)
    want = np.asarray(jops.spatial_graph_conv(*map(jnp.asarray, (adj, x, rel)), p,
                                              use_pallas=True))
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}
    got = tops.spatial_graph_conv(*_t([adj, x, rel]), tp).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_level3_grad_matches_jax_vjp_f64(rng, exact_f64):
    """The autograd wrapper's gradients for all eight inputs equal jax.vjp of
    the JAX level-3 formula in float64.  That formula asks for f32
    accumulation, as the package does; exact_f64 lifts it to float64 (with
    f32 sums the 0.2 leak would round even integer-valued operands)."""
    inputs = _level3_inputs(rng, 2, 6, 4, 2, weighted=True)
    g = rng.standard_normal((2, 6, 4))
    ts = [t.requires_grad_(True) for t in _t(inputs)]
    grads = torch.autograd.grad(motif_level3(*ts), ts, torch.from_numpy(g))
    _, vjp = jax.vjp(_jax_level3, *map(jnp.asarray, inputs))
    for got_i, want_i in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=1e-10, atol=1e-12)


def test_spatial_graph_conv_grad_matches_jax_vjp_f64(rng, key, exact_f64):
    """Gradients through the whole conv (adj, x, rel and every parameter)
    equal jax.vjp of the JAX layer, in float64."""
    adj, x, rel = _graph(rng, 2, 7, 2, 2, weighted=True)
    jm = jops.SpatialGraphConv(hidden=(5, 4, 3))
    p = jm.init(key, *(jnp.asarray(a, jnp.float32) for a in (adj, x, rel)))["params"]
    p = jax.tree.map(lambda t: rng.standard_normal(t.shape), p)
    g = rng.standard_normal((2, 7, 3))
    _, vjp = jax.vjp(jops.spatial_graph_conv, *map(jnp.asarray, (adj, x, rel)), p)
    want_adj, want_x, want_rel, want_p = vjp(jnp.asarray(g))
    targs = [t.requires_grad_(True) for t in _t([adj, x, rel])]
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    names = sorted(tp)
    got = torch.autograd.grad(tops.spatial_graph_conv(*targs, tp),
                              targs + [tp[k] for k in names], torch.from_numpy(g))
    for got_i, want_i in zip(got, [want_adj, want_x, want_rel] + [want_p[k] for k in names]):
        np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=1e-9, atol=1e-11)


def _jax_level3_rows(adj, phi_r, a_i, v_j, deg, m1d, m1f, bias, row0):
    """``_jax_level3`` for the window of rows [row0, row0 + n) that φ(rel)
    and a_i hold: rf reads the whole A, the mask and the j-sum A's rows."""
    f32 = dict(preferred_element_type=jnp.float32)
    n = phi_r.shape[1]
    rows = adj[:, row0:row0 + n]
    rf = jnp.einsum("bjk,bikr->bijr", adj, phi_r, **f32).astype(adj.dtype)
    d_ij = jnp.einsum("...f,fo->...o", phi_r, m1d, **f32).astype(adj.dtype)
    wf = jnp.einsum("...f,fo->...o", rf, m1f, **f32).astype(adj.dtype)
    m3 = deg[:, None, :, None] * (a_i[:, :, None] + d_ij + bias) + v_j[:, None] + wf
    m3 = rows[..., None] * m3
    return jnp.einsum("bij,bijh->bih", rows, jops.lrelu(m3), **f32).astype(adj.dtype)


BACKWARD_CASES = [  # B, N, h, R, n, row0, block_rows, directed
    (2, 7, 5, 1, 7, 0, None, False), (2, 9, 4, 2, 9, 0, 4, True),
    (2, 10, 4, 1, 10, 0, 5, False), (2, 11, 6, 2, 5, 3, None, True),
    (3, 13, 5, 3, 6, 7, 2, True), (2, 12, 3, 2, 7, 5, 3, False)]


@pytest.mark.parametrize("B,N,h,R,n,row0,block_rows,directed", BACKWARD_CASES)
def test_backward_plain_matches_jax_vjp_f64(rng, exact_f64, B, N, h, R, n, row0, block_rows,
                                            directed):
    """The closed-form backward equals jax.vjp of JAX's level 3 for all
    eight inputs in float64 at rtol 1e-10: a weighted (and directed) A,
    ragged N, row windows with row0 > 0, and block_rows that do and do not
    divide the window."""
    x = _window_inputs(rng, B, N, h, R, n, row0, directed)
    g = rng.standard_normal((B, n, h))
    got = motif_level3_backward_plain(torch.from_numpy(g), *_t(x), row0=row0,
                                      block_rows=block_rows)
    _, vjp = jax.vjp(lambda *a: _jax_level3_rows(*a, row0), *map(jnp.asarray, x))
    for name, got_i, want_i in zip(NAMES, got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=1e-10, atol=1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("B,N,h,R,n,row0,block_rows,directed", BACKWARD_CASES)
def test_backward_plain_matches_the_autograd_chain(rng, B, N, h, R, n, row0, block_rows,
                                                   directed):
    """The closed form equals autograd through the plain level 3 of the
    window's rows (the backward it replaced) at 1e-12 in float64; the
    autograd wrapper ``motif_level3`` returns the closed form (to the
    rounding of the CPU's vectorized sums, 1e-13)."""
    x = _t(_window_inputs(rng, B, N, h, R, n, row0, directed))
    g = torch.from_numpy(rng.standard_normal((B, n, h)))
    leaves = [t.clone().requires_grad_(True) for t in x]
    want = torch.autograd.grad(_level3_rows(leaves[0], leaves[0][:, row0:row0 + n],
                                            *leaves[1:]), leaves, g)
    got = motif_level3_backward_plain(g, *x, row0=row0, block_rows=block_rows)
    leaves = [t.clone().requires_grad_(True) for t in x]
    wrapped = torch.autograd.grad(motif_level3(*leaves, block_rows=block_rows, row0=row0),
                                  leaves, g)
    for name, got_i, want_i, w_i in zip(NAMES, got, want, wrapped):
        torch.testing.assert_close(got_i, want_i, rtol=1e-12, atol=1e-12, msg=name)
        torch.testing.assert_close(w_i, got_i, rtol=1e-13, atol=1e-13, msg=name)


def test_backward_plain_bf16_within_2e2_of_f32(rng):
    """bf16 inputs: the closed form runs in f32 and casts back, each
    gradient bf16 and within 2e-2 of the largest magnitude of the f32
    result on the same (bf16-rounded) inputs."""
    x = [t.to(torch.bfloat16) for t in _t(_window_inputs(rng, 3, 11, 6, 2, 11, 0))]
    g = torch.from_numpy(rng.standard_normal((3, 11, 6))).to(torch.bfloat16)
    got = motif_level3_backward_plain(g, *x)
    want = motif_level3_backward_plain(g.float(), *[t.float() for t in x])
    for name, got_i, want_i in zip(NAMES, got, want):
        assert got_i.dtype == torch.bfloat16, name
        assert (got_i.float() - want_i).abs().max() <= 2e-2 * want_i.abs().max(), name


@pytest.mark.parametrize("wanted", [(2, 3, 5, 6, 7), (0,), (1,), (4,), (0, 1, 4), (5, 6)])
def test_backward_gives_exactly_the_gradients_asked(rng, wanted):
    """Each subset of needs_input_grad gets exactly its gradients, equal to
    the full backward's (to rounding: the CPU's vectorized sums may take
    another order for another buffer): through the autograd wrapper (the
    others None) and through the wrapper's ``needs`` (the model's path asks
    for a_i, v_j, M1d, M1f and bias)."""
    x = _t(_window_inputs(rng, 2, 9, 4, 2, 6, 2, directed=True))
    g = torch.from_numpy(rng.standard_normal((2, 6, 4)))
    full = fused_motif_level3_backward(g, *x, row0=2)
    needs = tuple(i in wanted for i in range(8))
    part = fused_motif_level3_backward(g, *x, row0=2, needs=needs)
    leaves = [t.clone().requires_grad_(need) for t, need in zip(x, needs)]
    got = iter(torch.autograd.grad(motif_level3(*leaves, row0=2), [leaves[i] for i in wanted],
                                   g))
    for i, (f, p) in enumerate(zip(full, part)):
        assert (p is None) == (i not in wanted)
        if i in wanted:
            torch.testing.assert_close(p, f, rtol=1e-13, atol=1e-13)
            torch.testing.assert_close(next(got), f, rtol=1e-13, atol=1e-13)


def test_backward_wrapper_rejects_a_bad_gradient(rng):
    x = _t(_level3_inputs(rng, 1, 4, 3, 1))
    with pytest.raises(ValueError):
        fused_motif_level3_backward(torch.zeros(1, 4, 2, dtype=torch.float64), *x)
    with pytest.raises(TypeError):
        fused_motif_level3_backward(torch.zeros(1, 4, 3), *x)


def test_level3_partial_grads(rng):
    """Only the inputs that need a gradient get one."""
    ts = _t(_level3_inputs(rng, 1, 5, 3, 1))
    ts[6].requires_grad_(True)
    (gf,) = torch.autograd.grad(motif_level3(*ts).sum(), [ts[6]])
    assert gf.shape == ts[6].shape and torch.isfinite(gf).all()


def test_cpu_calls_count_no_launches(rng):
    """On the CPU neither the forward's nor the backward's wrapper counts a
    launch: they run the plain versions."""
    before = fused_motif_level3.launches, fused_motif_level3_backward.launches
    ts = _t(_level3_inputs(rng, 1, 4, 3, 1))
    fused_motif_level3(*ts)
    leaves = [t.clone().requires_grad_(True) for t in ts]
    torch.autograd.grad(motif_level3(*leaves).sum(), leaves)
    fused_motif_level3_backward(torch.ones(1, 4, 3, dtype=torch.float64), *ts)
    tops.spatial_graph_conv(*_t(_graph(rng, 1, 4, 2, 1)),
                            {k: torch.from_numpy(v) for k, v in _conv_params(rng, 2, 1).items()})
    assert (fused_motif_level3.launches, fused_motif_level3_backward.launches) == before


def _conv_params(rng, F, R, hidden=(5, 4, 3)):
    h0, h1, h2 = hidden
    shapes = {"Matrix1": (3 * F + 3 * R, h0), "bias1": (h0,), "Matrix2": (2 * F + R + h0, h1),
              "bias2": (h1,), "Matrix3": (F + h1, h2), "bias3": (h2,)}
    return {k: rng.standard_normal(s) for k, s in shapes.items()}


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "contiguous", "shape", "rank",
                                  "weights"])
def test_wrapper_rejects_bad_inputs(rng, case):
    ts = _t(_level3_inputs(rng, 1, 4, 3, 2))
    if case == "dtype":
        ts = [t.to(torch.int32) for t in ts]
        err = TypeError
    elif case == "mixed_dtype":
        ts[3] = ts[3].float()
        err = TypeError
    elif case == "contiguous":
        ts[1] = ts[1].transpose(1, 2)
        err = ValueError
    elif case == "shape":
        ts[2] = ts[2][:, :3].contiguous()
        err = ValueError
    elif case == "rank":
        ts[0] = ts[0][0]
        err = ValueError
    else:
        ts[5] = ts[5][:1].contiguous()
        err = ValueError
    with pytest.raises(err):
        fused_motif_level3(*ts)


MODEL_NEEDS = (False, False, True, True, False, True, True, True)


@pytest.mark.parametrize("B,N,rows,R,h", [
    (100, 25, 25, 1, 20), (100, 25, 25, 1, 50), (100, 25, 13, 1, 50), (100, 25, 7, 1, 50),
    (100, 25, 4, 1, 50), (2, 72, 72, 2, 75), (4, 256, 256, 1, 50), (4, 256, 64, 1, 50),
    (2, 40, 40, 5, 70), (3, 29, 29, 2, 37), (1, 8, 8, 1, 3), (2, 9, 9, 1, 33),
    (1, 2048, 2048, 1, 8)])
def test_backward_plan_clusters_cover_every_row_once(B, N, rows, R, h):
    """The backward's launch plan: one block per row tile, a tree's blocks
    one cluster where it has at most 4 row tiles (every tree of N <= 32),
    else clusters of 2, as few clusters as hold its row tiles and
    fewer padding blocks (without rows) than clusters; the blocks' rows
    covering the window once each; the h chunk one column per lane only
    in the model's instance (N <= 32, R = 1, h <= 32); the parameter
    partials' row (2R + 1)·h rounded up to 4."""
    p = motif_level3_backward_plan(B, N, rows, R, h)
    assert 1 <= p.cluster <= MAX_CLUSTER and p.cluster <= p.tiles
    assert p.tiles == -(-rows // ROW_TILE)
    assert (p.clusters == 1 if p.tiles <= MAX_CLUSTER else
            p.clusters == -(-p.tiles // SPLIT_CLUSTER) and p.cluster == SPLIT_CLUSTER)
    assert p.clusters == 1 or N > 32
    assert 0 <= p.clusters * p.cluster - p.tiles < p.clusters
    got = [p.rows_of(q) for q in range(p.clusters * p.cluster)]
    assert all(len(g) <= ROW_TILE for g in got)
    assert sorted(i for g in got for i in g) == list(range(rows))
    assert all(got[q] for q in range(p.tiles)) and not any(got[p.tiles:])
    assert p.h_chunk == (32 if N <= 32 and R == 1 and h <= 32 else 64)
    assert p.cols % 4 == 0 and 0 <= p.cols - (2 * R + 1) * h < 4


@pytest.mark.parametrize("needs,names,kernels", [
    (MODEL_NEEDS, {"pp"}, 1),
    ((True,) * 8, {"gd", "grf", "loc", "pdeg", "pp"}, 2),
    ((False, False, True, True, False, False, False, False), set(), 1),
    ((False, False, False, False, True, False, False, False), {"pdeg"}, 1),
    ((True, False, False, False, False, False, False, False), {"grf", "loc"}, 2),
    ((False, True, False, False, True, False, False, False), {"gd", "grf", "pdeg"}, 2),
    ((False, False, False, False, False, False, False, True), {"pp"}, 1)])
def test_backward_plan_scratch(needs, names, kernels):
    """The scratch the plan asks for, and its sizes: the per-cluster
    parameter partials [B, clusters, cols] and the election counter only
    where a parameter's gradient is asked, ∂deg's sum over h chunks [B,
    clusters, N], gd / grf / loc for the contractions, which take the second
    kernel; the model's path (a_i, v_j, M1d, M1f, bias) one kernel and
    B·cols floats, below the earlier per-block partials ([B·tiles, (2R+1)h] and
    [B, tiles, N, h]).  At N = 256 (16 clusters of 2 a tree) the clusters'
    ∂v_j sums [B, 16, N, h] and a counter per tree and rank besides, where
    ∂v_j or ∂deg is asked."""
    B, N, rows, R, h = 100, 25, 25, 1, 50
    p = motif_level3_backward_plan(B, N, rows, R, h, needs)
    assert set(p.scratch) == names and p.kernels == kernels and p.clusters == 1
    assert p.counters == ("pp" in names)
    want = {"gd": (B, rows, N, R), "grf": (B, rows, N, R), "loc": (B, rows, N),
            "pdeg": (B, 1, N), "pp": (B, 1, p.cols)}
    assert all(p.scratch[k] == want[k] for k in names)
    if needs == MODEL_NEEDS:
        tiles = -(-rows // ROW_TILE)
        assert B * p.cols < B * tiles * (2 * R + 1) * h + B * tiles * N * h
    B, N = 4, 256
    big = motif_level3_backward_plan(B, N, N, R, h, needs)
    need = dict(zip(NAMES, needs))
    assert big.clusters == 16 and big.cluster == 2
    assert set(big.scratch) == names | ({"pv"} if need["v_j"] else set())
    assert big.counters == ((1 + B * 2) if need["v_j"] or need["deg"] else
                            1 if "pp" in names else 0)
    assert big.scratch.get("pv", (B, 16, N, h)) == (B, 16, N, h)
    assert big.scratch.get("pp", (B, 16, big.cols)) == (B, 16, big.cols)
