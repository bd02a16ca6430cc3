"""The port's kernels (K1 motif combine, K2 its autograd wrapper, K3 A@X+lrelu)
held against the JAX package's Pallas kernels, run in interpret mode on the
CPU, and their reference oracles.  On the CPU each wrapper returns its plain
PyTorch version; the CUDA launch path runs only where there is a card, in
``tests/test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snd_vae_tpu.nn.pallas import (
    adj_matmul_reference,
    blocked_adj_matmul as jax_blocked_adj_matmul,
    fused_motif_combine as jax_fused_motif_combine,
    fused_motif_combine_reference,
)
from snd_vae_tpu_torch.nn.kernels.adj_matmul import (
    adj_matmul,
    blocked_adj_matmul,
)
from snd_vae_tpu_torch.nn.kernels.motif_combine import (
    fused_motif_combine,
    motif_combine,
)


def _motif_inputs(rng, B, N, h, dtype=np.float32):
    adj = (rng.random((B, N, N)) < 0.4).astype(dtype)
    adj = np.triu(adj, 1)
    adj = adj + adj.transpose(0, 2, 1)
    return (
        adj,
        rng.standard_normal((B, N, h)).astype(dtype),      # a_i
        rng.standard_normal((B, N, N, h)).astype(dtype),   # d_ij
        rng.standard_normal((B, N, h)).astype(dtype),      # v_j
        rng.standard_normal((B, N, N, h)).astype(dtype),   # f_ik
        rng.standard_normal((h,)).astype(dtype),           # bias
    )


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("B,N,h", [(2, 10, 6), (2, 13, 5)])
def test_motif_combine_plain_matches_pallas_f32(rng, B, N, h):
    """f32 at rtol/atol 1e-5: the sum over k is taken in another order."""
    inputs = _motif_inputs(rng, B, N, h)
    got = fused_motif_combine(*_t(inputs)).numpy()
    pallas = jax_fused_motif_combine(*map(jnp.asarray, inputs), interpret=True)
    ref = fused_motif_combine_reference(*map(jnp.asarray, inputs))
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


def _integer_f_ik(rng, inputs):
    """The JAX oracle accumulates its Σ_k einsum in f32 even for float64
    inputs (preferred_element_type), so float64 checks against it give f_ik
    small integer values, whose sums f32 represents exactly."""
    inputs = list(inputs)
    inputs[4] = rng.integers(-8, 9, inputs[4].shape).astype(np.float64)
    return inputs


def _numpy_motif_combine(adj, a_i, d_ij, v_j, f_ik, bias):
    deg = adj.sum(-1)
    wf = np.einsum("bjk,bikh->bijh", adj, f_ik)
    out = deg[:, None, :, None] * (a_i[:, :, None] + d_ij + bias) + v_j[:, None] + wf
    return adj[..., None] * out


@pytest.mark.parametrize("B,N,h", [(2, 10, 6), (2, 13, 5)])
def test_motif_combine_plain_matches_reference_f64(rng, B, N, h):
    """float64 at rtol 1e-12: the same formula, only rounding differs."""
    inputs = _motif_inputs(rng, B, N, h, np.float64)
    got = fused_motif_combine(*_t(inputs)).numpy()
    np.testing.assert_allclose(got, _numpy_motif_combine(*inputs), rtol=1e-12, atol=1e-12)
    inputs = _integer_f_ik(rng, inputs)
    got = fused_motif_combine(*_t(inputs)).numpy()
    with jax.enable_x64():
        want = np.asarray(fused_motif_combine_reference(*map(jnp.asarray, inputs)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_motif_combine_grad_matches_jax_vjp_f64(rng):
    """K2's backward (autograd through the plain version) equals jax.vjp of
    the reference formula for all six inputs, in float64 (f_ik and the
    cotangent integer-valued: see _integer_f_ik)."""
    inputs = _integer_f_ik(rng, _motif_inputs(rng, 2, 9, 4, np.float64))
    g = rng.integers(-4, 5, (2, 9, 9, 4)).astype(np.float64)
    ts = [t.requires_grad_(True) for t in _t(inputs)]
    out = motif_combine(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    with jax.enable_x64():
        _, vjp = jax.vjp(fused_motif_combine_reference, *map(jnp.asarray, inputs))
        want = vjp(jnp.asarray(g))
    for got_i, want_i in zip(grads, want):
        np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=1e-10, atol=1e-12)


def test_motif_combine_partial_grads(rng):
    """Only the inputs that need a gradient get one."""
    ts = _t(_motif_inputs(rng, 1, 5, 3, np.float64))
    ts[4].requires_grad_(True)
    (gf,) = torch.autograd.grad(motif_combine(*ts).sum(), [ts[4]])
    assert gf.shape == ts[4].shape and torch.isfinite(gf).all()


@pytest.mark.parametrize("leak", [None, 0.2])
@pytest.mark.parametrize("shape", [((40, 40), (40, 12)), ((30, 30), (30, 20)),
                                   ((3, 20, 20), (3, 20, 8)), ((2, 25, 25), (2, 25, 10))])
def test_adj_matmul_plain_matches_pallas(rng, shape, leak):
    """2-D and batched, with and without the lrelu epilogue, as
    tests/test_pallas.py:17-47 holds the Pallas kernel."""
    a_shape, x_shape = shape
    adj = (rng.random(a_shape) < 0.4).astype(np.float32)
    x = rng.standard_normal(x_shape).astype(np.float32)
    got = adj_matmul(*_t([adj, x]), leak=leak).numpy()
    want = jax_blocked_adj_matmul(jnp.asarray(adj), jnp.asarray(x), leak=leak,
                                  interpret=True)
    ref = adj_matmul_reference(jnp.asarray(adj), jnp.asarray(x), leak=leak)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_adj_matmul_multiblock(rng):
    """Larger than one Pallas tile: the k-accumulation loop."""
    adj = rng.standard_normal((200, 300)).astype(np.float32)
    x = rng.standard_normal((300, 150)).astype(np.float32)
    got = adj_matmul(*_t([adj, x]), leak=0.2).numpy()
    want = jax_blocked_adj_matmul(jnp.asarray(adj), jnp.asarray(x), leak=0.2,
                                  interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("leak", [None, 0.25])
@pytest.mark.parametrize("shape", [((7, 9), (9, 4)), ((2, 6, 6), (2, 6, 3))])
def test_adj_matmul_grad_matches_jax_vjp_f64(rng, shape, leak):
    """The autograd wrapper's backward (autograd through the plain version)
    equals jax.vjp of the reference for both inputs, in float64.  The JAX
    oracle accumulates in f32, so x and the cotangent are integer-valued and
    the leak a power of two: every sum is exact in f32."""
    a_shape, x_shape = shape
    adj = (rng.random(a_shape) < 0.5).astype(np.float64)
    x = rng.integers(-8, 9, x_shape).astype(np.float64)
    g = rng.integers(-4, 5, a_shape[:-1] + x_shape[-1:]).astype(np.float64)
    ts = [t.requires_grad_(True) for t in _t([adj, x])]
    grads = torch.autograd.grad(adj_matmul(*ts, leak=leak), ts, torch.from_numpy(g))
    with jax.enable_x64():
        _, vjp = jax.vjp(lambda a, b: adj_matmul_reference(a, b, leak=leak),
                         jnp.asarray(adj), jnp.asarray(x))
        want = vjp(jnp.asarray(g))
    for got_i, want_i in zip(grads, want):
        np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=1e-12, atol=1e-12)


def test_adj_matmul_partial_grads(rng):
    """Only the inputs that need a gradient get one."""
    adj, x = _t([rng.random((5, 5)), rng.standard_normal((5, 3))])
    x.requires_grad_(True)
    (gx,) = torch.autograd.grad(adj_matmul(adj, x, leak=0.2).sum(), [x])
    assert gx.shape == x.shape and torch.isfinite(gx).all()


def test_cpu_wrappers_do_not_count_launches(rng):
    before = (fused_motif_combine.launches, blocked_adj_matmul.launches)
    fused_motif_combine(*_t(_motif_inputs(rng, 1, 4, 2)))
    blocked_adj_matmul(torch.ones(3, 3), torch.ones(3, 2))
    adj_matmul(torch.ones(3, 3), torch.ones(3, 2))
    assert (fused_motif_combine.launches, blocked_adj_matmul.launches) == before


@pytest.mark.parametrize("case", ["dtype", "contiguous", "shape", "mixed_dtype", "rank"])
def test_wrappers_reject_bad_inputs(rng, case):
    a, x = torch.ones(4, 5), torch.ones(5, 3)
    inputs = _t(_motif_inputs(rng, 1, 4, 2))
    if case == "dtype":
        with pytest.raises(TypeError):
            adj_matmul(a.half(), x.half())
        with pytest.raises(TypeError):
            fused_motif_combine(*[t.to(torch.int32) for t in inputs])
    elif case == "contiguous":
        with pytest.raises(ValueError):
            adj_matmul(torch.ones(5, 4).t(), x)
        inputs[2] = inputs[2].transpose(1, 2)
        with pytest.raises(ValueError):
            fused_motif_combine(*inputs)
    elif case == "shape":
        with pytest.raises(ValueError):
            adj_matmul(a, torch.ones(4, 3))
        inputs[4] = inputs[4][:, :, :3].contiguous()
        with pytest.raises(ValueError):
            fused_motif_combine(*inputs)
    elif case == "mixed_dtype":
        with pytest.raises(TypeError):
            adj_matmul(a, x.double())
    else:
        with pytest.raises(ValueError):
            adj_matmul(a, torch.ones(2, 5, 3))
