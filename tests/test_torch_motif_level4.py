"""Level 4 of the fourth-order motif conv and its masked k-sum
(``nn/kernels/motif_level4.py``, K4) on the CPU, where the wrappers run
the plain versions:

  * ``motif_level4_backward_plain``, the closed form, held to autograd
    through ``motif_level4_plain`` (the chain of PyTorch ops the conv ran
    before the kernel pair) in float64 (rtol 1e-12), on trees, a dense mask,
    an asymmetric weighted mask and a mask with rows all zero, for all N
    rows and for a window of rows;
  * the whole conv (``spatial_graph_conv_3d``) on that path against the
    dense oracle (the reference formula) in float64 at N <= 6, with a row
    window (``rows``) and ``block_rows``, and its gradients against
    autograd through the plain chain;
  * a mask or deg that requires a gradient raises; shapes are checked; on
    CPU tensors no launch is counted; bf16 runs in f32.

The kernels themselves run on the card: ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch
from torch_parity import one_thread  # noqa: F401  (fixture)

from snd_vae_tpu_torch import nn as tops
from snd_vae_tpu_torch.nn import spatial_conv
from snd_vae_tpu_torch.nn.kernels import motif_level4 as m4

pytestmark = pytest.mark.usefixtures("one_thread")
HIDDEN = (4, 3, 3, 2)
KINDS = ("tree", "dense", "weighted_asymmetric", "zero_rows")


def _mask(rng, kind, B, N):
    """[B,N,N] float64: random spanning trees (0/1, symmetric), all ones,
    an asymmetric mask of weights in (0, 1), or trees whose rows 0 and 2
    are zero (their columns not)."""
    if kind == "dense":
        return np.ones((B, N, N))
    if kind == "weighted_asymmetric":
        return (rng.random((B, N, N)) < 0.5) * rng.random((B, N, N))
    m = np.zeros((B, N, N))
    for b in range(B):
        for v in range(1, N):
            u = rng.integers(0, v)
            m[b, u, v] = m[b, v, u] = 1.0
    if kind == "zero_rows":
        m[:, [0, 2], :] = 0.0
    return m


def _inputs(rng, kind, B, N, h, window=None):
    """mask_i, mask, deg, pu, alpha, beta, gamma (float64) for the rows
    ``window`` = (start, n) of N, all rows by default."""
    mask = _mask(rng, kind, B, N)
    s, n = window or (0, N)
    draw = lambda *shape: rng.standard_normal(shape)
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        mask[:, s:s + n], mask, mask.sum(-1), draw(B, n, N, h), draw(B, n, N, h),
        draw(B, N, N, h), draw(B, N, h))]


@pytest.mark.parametrize("window", [None, (2, 3)])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_is_the_chain_and_closed_form_is_its_gradient(kind, window):
    rng = np.random.default_rng(len(kind) + 7 * (window is None))
    ts = _inputs(rng, kind, 3, 7, 5, window)
    leaves = [t.clone().requires_grad_(True) for t in ts[3:]]
    out = m4.motif_level4_plain(*ts[:3], *leaves)
    g = torch.from_numpy(rng.standard_normal(out.shape))
    want = torch.autograd.grad(out, leaves, g)
    got = m4.motif_level4_backward_plain(g, *ts)
    for name, a, b in zip(("pu", "alpha", "beta", "gamma"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-14 * b.abs().max().item(),
                                   msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_autograd_wrapper_runs_the_plain_pair_on_the_cpu(kind):
    """``motif_level4``'s forward and backward on CPU tensors are the plain
    pair, and neither counts a launch."""
    rng = np.random.default_rng(3)
    ts = _inputs(rng, kind, 2, 6, 3)
    leaves = [t.clone().requires_grad_(True) for t in ts[3:]]
    n0 = m4.fused_motif_level4.launches, m4.fused_motif_level4_backward.launches
    out = m4.motif_level4(*ts[:3], *leaves)
    assert torch.equal(out, m4.motif_level4_plain(*ts))
    g = torch.from_numpy(rng.standard_normal(out.shape))
    got = torch.autograd.grad(out, leaves, g)
    for a, b in zip(got, m4.motif_level4_backward_plain(g, *ts)):
        assert torch.equal(a, b)
    assert (m4.fused_motif_level4.launches, m4.fused_motif_level4_backward.launches) == n0
    # only the gradients asked for come back
    (g_beta,) = torch.autograd.grad(m4.motif_level4(*ts[:5], leaves[2], ts[6]), [leaves[2]], g)
    assert torch.equal(g_beta, got[2])


@pytest.mark.parametrize("name", ["mask_i", "mask", "deg"])
def test_mask_or_deg_requiring_grad_raises(name):
    ts = dict(zip(m4.NAMES, _inputs(np.random.default_rng(0), "tree", 2, 5, 3)))
    ts[name] = ts[name].clone().requires_grad_(True)
    with pytest.raises(ValueError, match=f"{name} requires grad"):
        m4.motif_level4(*ts.values())


def test_shapes_and_dtypes_are_checked():
    ts = _inputs(np.random.default_rng(0), "tree", 2, 5, 3)
    with pytest.raises(ValueError, match="beta"):
        m4.fused_motif_level4(*ts[:5], ts[5][:, :4].contiguous(), ts[6])
    with pytest.raises(ValueError, match=r"mask must be \[B,N,N\]"):
        m4.fused_motif_level4(ts[0], ts[1][:, :4].contiguous(), *ts[2:])
    with pytest.raises(TypeError, match="gamma"):
        m4.fused_motif_level4(*ts[:6], ts[6].float())
    with pytest.raises(ValueError, match="grad has shape"):
        m4.fused_motif_level4_backward(ts[3][:, :, :4].contiguous(), *ts)


def test_bf16_runs_in_f32():
    """bf16 inputs: the plain pair computes in f32 and casts the results."""
    ts = [t.to(torch.bfloat16) for t in _inputs(np.random.default_rng(5), "tree", 2, 6, 4)]
    f32 = [t.float() for t in ts]
    out = m4.motif_level4_plain(*ts)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, m4.motif_level4_plain(*f32).to(torch.bfloat16))
    g = torch.ones_like(out)
    for a, b in zip(m4.motif_level4_backward_plain(g, *ts),
                    m4.motif_level4_backward_plain(g.float(), *f32)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.to(torch.bfloat16))


# --------------------------------------------------------------------------
# The whole fourth-order conv on this path
# --------------------------------------------------------------------------

def _conv_inputs(rng, kind, B=2, N=6, F=2, R=1):
    """adj (the mask's kind; ``dense`` is the fully_connected variant over
    trees), x, rel, and seeded float64 parameters."""
    adj = _mask(rng, "tree" if kind == "dense" else kind, B, N)
    x = rng.standard_normal((B, N, F))
    rel = np.abs(rng.standard_normal((B, N, N, R)))
    rel = (rel + np.swapaxes(rel, 1, 2)) / 2
    full = kind == "dense"
    mod = tops.SpatialGraphConv3D(F, R, HIDDEN, torch.Generator().manual_seed(0),
                                  fully_connected=full)
    params = {k: torch.from_numpy(0.5 * rng.standard_normal(tuple(v.shape)))
              for k, v in mod.state_dict().items()}
    ta = [torch.from_numpy(a) for a in (adj, x, rel)]
    trel = torch.cat([ta[2], ta[0][..., None]], -1) if full else ta[2]
    return ta[0], ta[1], trel, ta[2], params, full


@pytest.mark.parametrize("kind", KINDS)
def test_conv_matches_dense_oracle_f64(kind):
    rng = np.random.default_rng(11)
    adj, x, rel, dis, params, full = _conv_inputs(rng, kind)
    oracle = tops.spatial_graph_conv_3d_dense_oracle(adj, x, rel, dis, params,
                                                    fully_connected=full)
    got = tops.spatial_graph_conv_3d(adj, x, rel, dis, params, fully_connected=full)
    torch.testing.assert_close(got, oracle, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("how", [dict(rows=(1, 3)), dict(rows=(4, 2)), dict(block_rows=2),
                                 dict(block_rows=3), dict(rows=(0, 4), block_rows=2)])
@pytest.mark.parametrize("kind", ["tree", "weighted_asymmetric"])
def test_conv_row_windows_and_blocks_match_dense_oracle_f64(kind, how):
    """A window of rows (``rows``) is those rows of the oracle; ``block_rows``
    (a window's too) the same result."""
    rng = np.random.default_rng(13)
    adj, x, rel, dis, params, full = _conv_inputs(rng, kind)
    oracle = tops.spatial_graph_conv_3d_dense_oracle(adj, x, rel, dis, params)
    s, n = how.get("rows", (0, adj.shape[1]))
    got = tops.spatial_graph_conv_3d(adj, x, rel, dis, params, **how)
    torch.testing.assert_close(got, oracle[:, s:s + n], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("how", [dict(), dict(block_rows=3), dict(rows=(1, 4))])
@pytest.mark.parametrize("kind", KINDS)
def test_conv_gradients_match_autograd_through_the_chain(monkeypatch, kind, how):
    """Gradients of x, rel and every parameter through K4's closed form
    against autograd through the plain chain, float64 at rtol 1e-12."""
    rng = np.random.default_rng(17)
    adj, x, rel, dis, params, full = _conv_inputs(rng, kind)
    names = sorted(params)

    def grads():
        leaves = [x.clone().requires_grad_(True), rel.clone().requires_grad_(True)] + [
            params[k].clone().requires_grad_(True) for k in names]
        d = leaves[1] if not full else leaves[1][..., :-1]
        out = tops.spatial_graph_conv_3d(adj, leaves[0], leaves[1], d,
                                         dict(zip(names, leaves[2:])), fully_connected=full,
                                         **how)
        g = torch.from_numpy(np.random.default_rng(1).standard_normal(out.shape))
        return out, torch.autograd.grad(out, leaves, g)

    out, got = grads()
    monkeypatch.setattr(spatial_conv, "motif_level4", m4.motif_level4_plain)
    out0, want = grads()
    assert torch.equal(out, out0)
    for name, a, b in zip(["x", "rel"] + names, got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-14 * b.abs().max().item(),
                                   msg=name)
