"""The port's level-3 kernel ``motif_level3`` (φ(rel) to the masked j-sum in
one launch) against the JAX package: its default rank-R path and dense
oracle in float64, the Pallas motif-combine kernel (interpret mode) in f32,
and ``jax.vjp`` for the gradients.  On the CPU the wrapper returns its plain
PyTorch version; the CUDA kernel runs only where there is a card, in
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
    fused_motif_level3,
    motif_level3,
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


def test_level3_partial_grads(rng):
    """Only the inputs that need a gradient get one."""
    ts = _t(_level3_inputs(rng, 1, 5, 3, 1))
    ts[6].requires_grad_(True)
    (gf,) = torch.autograd.grad(motif_level3(*ts).sum(), [ts[6]])
    assert gf.shape == ts[6].shape and torch.isfinite(gf).all()


def test_cpu_calls_count_no_launches(rng):
    before = fused_motif_level3.launches
    ts = _t(_level3_inputs(rng, 1, 4, 3, 1))
    fused_motif_level3(*ts)
    motif_level3(*ts)
    tops.spatial_graph_conv(*_t(_graph(rng, 1, 4, 2, 1)),
                            {k: torch.from_numpy(v) for k, v in _conv_params(rng, 2, 1).items()})
    assert fused_motif_level3.launches == before


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
