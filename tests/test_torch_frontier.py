"""The JAX package's single-chip frontier configuration in the port
(``benchmarks/frontier_2048.py:43-47``: the synthetic2 preset at
``num_nodes`` N with ``sampling_num=2`` and batches of 2 graphs; the
separable adjacency head by the auto rule), on the CPU:

  * one train step at N = 128 against ``jax.value_and_grad`` of the JAX
    model (compiled without XLA's ``algsimp``, as
    ``tests/test_torch_train.py`` explains): the loss and every gradient in
    float64 at rtol 1e-8 (``exact_f64``) and in f32 at rtol 1e-4 (atol 3e-4
    of each gradient's largest magnitude), with and without ``remat`` and
    ``motif_block_rows=64``;
  * the kernels' launch plans at the shapes this configuration gives them
    at N = 256, 1024 and 2048 (the card's ``chip_smoke.py`` frontier phase
    trains there): tiled variants within the grid's and shared memory's
    limits, and K2's backward clusters and scratch as derived by hand;
  * the data at N = 1024: the port's loader bit-equal to JAX's, with the
    native sampler and with the numpy route."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from test_torch_protein_train import _jax_loss_and_grads
from torch_parity import exact_f64, jax_native, one_thread  # noqa: F401  (fixtures)
from torch_parity import init_like, setup_models

import snd_vae_tpu.data.spanning_tree as jax_spanning_tree
from snd_vae_tpu import config as jcfg
from snd_vae_tpu.data import loaders as jax_loaders
from snd_vae_tpu.data.graphbatch import from_numpy as jax_batch
from snd_vae_tpu.data.loaders import load_dataset as jax_load_dataset
from snd_vae_tpu_torch import config as tcfg
from snd_vae_tpu_torch import train as ttrain
from snd_vae_tpu_torch.data import loaders, spanning_tree
from snd_vae_tpu_torch.data.graphbatch import from_numpy as torch_batch
from snd_vae_tpu_torch.data.loaders import load_dataset
from snd_vae_tpu_torch.models import Latents
from snd_vae_tpu_torch.nn.kernels import adj_matmul as am
from snd_vae_tpu_torch.nn.kernels import motif_level3 as ml
from snd_vae_tpu_torch.params import torch_layout, torch_name

pytestmark = pytest.mark.usefixtures("one_thread")
NODES = 128
# the level-3 backward's gradients on the model's path: a_i, v_j, M1d, M1f, bias
MODEL_NEEDS = (False, False, True, True, False, True, True, True)


def _frontier(module, n, **over):
    """``benchmarks/frontier_2048.py:43-47`` in ``module``'s config."""
    cfg = module.synthetic2_preset().with_(num_nodes=n, sampling_num=2, **over)
    return cfg.with_(train=cfg.train.__class__(batch_size=2))


def test_frontier_config_is_jaxs():
    """The port's frontier config equals JAX's field for field (the
    dataset path aside) and engages the separable head."""
    for n in (NODES, 1024, 2048):
        jc, tc = _frontier(jcfg, n), _frontier(tcfg, n)
        assert (dict(dataclasses.asdict(jc), dataset_path=None)
                == dict(dataclasses.asdict(tc), dataset_path=None))
        assert tc.adj_factored_engaged and tc.train.batch_size == 2


def _step(np_dtype, remat):
    """One step at N = 128 from the same weights (``init_like``), batch and
    ε in both packages: (JAX loss, JAX gradients, port loss, port
    gradients)."""
    over = dict(remat=True, motif_block_rows=64) if remat else {}
    jc, tc, jm, params, tm, arrays = setup_models(
        "synthetic2", np_dtype, "synthetic2", split="train", init=init_like,
        num_nodes=NODES, sampling_num=2, **over)
    assert tc.adj_factored_engaged and len(arrays["adj"]) == 2
    rng, enc = np.random.default_rng(7), jc.encoder
    eps = {"z_sg": rng.standard_normal((2, 2, enc.sg_latent_size)),
           "z_s": rng.standard_normal((2, enc.s_latent_size)),
           "z_g": rng.standard_normal((2, enc.g_latent_size))}
    eps = {k: v.astype(np_dtype) for k, v in eps.items()}
    j_total, grads = _jax_loss_and_grads(jc, jm, params, jax_batch(**arrays, dtype=np_dtype),
                                         {k: jnp.asarray(v) for k, v in eps.items()})
    dt = torch.float64 if np_dtype == np.float64 else torch.float32
    state = ttrain.TrainState(cfg=tc, model=tm.train(),
                              optimizer=ttrain.make_optimizer(tc, tm.parameters()),
                              generator=torch.Generator().manual_seed(0))
    aux = ttrain.train_step(state, torch_batch(**arrays, dtype=dt), torch.tensor(0.0, dtype=dt),
                            eps=Latents(**{k: torch.from_numpy(v) for k, v in eps.items()}))
    return (float(j_total), flatten_dict(grads, sep="/"), aux["loss"].item(),
            {k: p.grad for k, p in tm.named_parameters()})


def _assert_step(np_dtype, remat, rtol, atol):
    j_loss, j_grads, loss, got = _step(np_dtype, remat)
    np.testing.assert_allclose(loss, j_loss, rtol=rtol)
    assert len(j_grads) == len(got)
    for path, g in j_grads.items():
        g = torch_layout(path, np.asarray(g))
        np.testing.assert_allclose(got[torch_name(path)].numpy(), g, rtol=rtol,
                                   atol=atol * np.abs(g).max(), err_msg=path)


@pytest.mark.parametrize("remat", [False, True])
def test_frontier_step_matches_jax_f64(exact_f64, remat):
    """Float64: the loss and every gradient at rtol 1e-8 (atol 1e-10 of
    each gradient's largest magnitude)."""
    _assert_step(np.float64, remat, 1e-8, 1e-10)


@pytest.mark.parametrize("remat", [False, True])
def test_frontier_step_matches_jax_f32(remat):
    """F32: the loss and every gradient at rtol 1e-4, atol 3e-4 of each
    gradient's largest magnitude: the decoder's first Dense layers sum the
    adjacency head's gradient over the N² = 16,384 pairs, which the two
    packages order differently (their largest gap read 1.7e-4 of the
    largest magnitude, at d_g_lin1's kernel)."""
    _assert_step(np.float32, remat, 1e-4, 3e-4)


# ---------------------------------------------------------------------------
# The launch plans at this configuration's shapes
# ---------------------------------------------------------------------------

SIZES = [256, 1024, 2048]
DTYPES = [torch.float32, torch.bfloat16]
# GraphConv 1 ([2,N,N] @ ([2,N,1] @ [1,10]), the gradient of W) and 2
# ([2,N,N] @ ([2,N,11] @ [11,20]), the gradients of x and W)
GRAPH_CONVS = [(1, 10, (False, False, True)), (11, 20, (False, True, True))]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f,h,needs", GRAPH_CONVS)
def test_adj_matmul_plans_at_the_frontier(n, dtype, f, h, needs):
    """K3 and its backward at both GraphConvs: the tiled variant of the
    dtype (simt in f32, tc in bf16) with W fused, the grid's y and z and
    the shared memory within the card's limits, the k (i) split a power of
    two that fits the card's clusters at once; TMA for A (16-byte rows)
    but not for the 10 / 20 columns of x W and gy where a row is not a
    multiple of 16 bytes."""
    tiled = "tc" if dtype == torch.bfloat16 else "simt"
    esz = 2 if dtype == torch.bfloat16 else 4
    fwd = am.adj_matmul_plan(2, n, n, h, f, dtype)
    bwd = am.adj_matmul_backward_plan(2, n, n, h, f, dtype, needs)
    for plan, held, tile in ((fwd, am.H100_CLUSTERS, fwd.tile), (bwd, am.H100_BWD_CLUSTERS,
                                                                  bwd.tile)):
        assert plan.variant == tiled and plan.fuse_w
        assert max(plan.grid[1:]) <= am.GRID_YZ_MAX and plan.smem <= am.SMEM_PER_BLOCK
        assert plan.split in (1, 2, 4, 8) and plan.grid[0] == plan.split
        assert plan.grid[1] * plan.grid[2] <= held[tiled][plan.split]
        assert plan.tma_a
    assert fwd.grid[1:] == (-(-n // fwd.tile[0]) * -(-h // fwd.tile[1]), 2)
    assert bwd.grid[1:] == (-(-n // bwd.tile[0]) * -(-h // bwd.tile[1]), 2)
    assert bwd.kernels == 1 and bwd.parts == bwd.split * bwd.grid[1] * 2
    assert bwd.tma_g == (h * esz % 16 == 0) and not fwd.tma_x
    # every k (i) slice a whole number of k steps, in rank order, covering n
    for slices, step in ((fwd.k_slices, fwd.tile[2]), (bwd.i_slices, bwd.tile[2])):
        assert slices[0][0] == 0 and slices[-1][1] == n
        assert all(a[1] == b[0] and a[0] % step == 0 for a, b in zip(slices, slices[1:]))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("h", [20, 50])
def test_level3_backward_plan_at_the_frontier(n, h):
    """K2's backward at [4,N,N,h] (B·S = 4 trees), the model's gradients:
    one block a row tile of 8 rows, clusters of 2 (more row tiles than one
    cluster of 4 holds), so the sums over a tree's rows go through L2:
    ``pv`` [4, N/16, N, h] holds each cluster's ∂v_j partial, ``pp`` [4,
    N/16, 3h rounded up to 4] its parameter partial, with one election
    counter for the sum over trees and one per tree and rank (1 + 4·2); no
    scratch of the gradients the model does not ask for."""
    plan = ml.motif_level3_backward_plan(4, n, n, 1, h, MODEL_NEEDS)
    tiles = n // ml.ROW_TILE
    assert (plan.tiles, plan.clusters, plan.cluster) == (tiles, tiles // 2, 2)
    assert plan.h_chunk == 64 and plan.kernels == 1 and plan.counters == 1 + 4 * 2
    cols = -(-3 * h // 4) * 4
    assert plan.scratch == {"pv": (4, tiles // 2, n, h), "pp": (4, tiles // 2, cols)}
    assert sorted(r for q in range(plan.clusters * plan.cluster)
                  for r in plan.rows_of(q)) == list(range(n))


# ---------------------------------------------------------------------------
# The data at N = 1024
# ---------------------------------------------------------------------------

FIELDS = ("adj", "features", "coords", "rel", "adj_samples", "factors")


@pytest.fixture
def numpy_route(jax_native, monkeypatch):
    """Both packages' loaders on the numpy Kruskal (``use_native=False``)."""
    for mod, fn in ((jax_loaders, jax_spanning_tree.sample_spanning_trees),
                    (loaders, spanning_tree.sample_spanning_trees)):
        monkeypatch.setattr(mod, "sample_spanning_trees", functools.partial(fn, use_native=False))


def _assert_data_bit_equal(tmp_path, split):
    jc = _frontier(jcfg, 1024, dataset_path=str(tmp_path))
    tc = _frontier(tcfg, 1024, dataset_path=str(tmp_path))
    want = jax_load_dataset(jc, split, num_graphs=2)
    got = load_dataset(tc, split, num_graphs=2, device="cpu")
    assert got.adj.shape == (2, 1024, 1024) and got.adj_samples.shape == (2, 2, 1024, 1024)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    # spanning trees of each graph: N - 1 edges inside A
    trees = got.adj_samples.numpy()
    assert (trees.sum((2, 3)) == 2 * 1023).all()
    assert (trees <= got.adj.numpy()[:, None]).all()


@pytest.mark.parametrize("split", ["train", "test"])
def test_frontier_data_bit_equal(jax_native, tmp_path, split):
    """Both packages generate N = 1024 from the seed and sample with their
    native library."""
    _assert_data_bit_equal(tmp_path, split)


@pytest.mark.parametrize("split", ["train", "test"])
def test_frontier_data_bit_equal_numpy_route(numpy_route, tmp_path, split):
    """The same with ``use_native=False`` on both sides."""
    _assert_data_bit_equal(tmp_path, split)


# ---------------------------------------------------------------------------
# The untrained model at N = 2048
# ---------------------------------------------------------------------------

def _graph_stats(tmp_path, n):
    """The topology branch's posterior (μ, log σ) at the seed weights on
    2 train graphs of the frontier config at N (the other branches do not
    enter the graph KL)."""
    from snd_vae_tpu_torch.models import build_model

    cfg = _frontier(tcfg, n, dataset_path=str(tmp_path))
    batch = load_dataset(cfg, "train", num_graphs=2, device="cpu")
    model = build_model(cfg, device="cpu")
    with torch.no_grad():
        feats, g = batch.features, batch.features
        for conv, bn in zip(model.g_convs, model.g_bns):
            g = torch.cat([bn(conv(batch.adj, g)), feats], dim=-1)
        hidden = model.g_lin1(model.encoder_g_bn(g).reshape(2, -1))
        return model.g_lin_mean(hidden), model.g_lin_std(hidden)


def test_graph_kl_overflows_at_the_untrained_init_at_2048(tmp_path):
    """At N = 2048 the truth graphs' mean degree (~390) makes the
    topology branch's second GraphConv reach ~67 and its Dense layers log σ
    ~50 at the seed weights, past log(√f32max) ≈ 44.4, so exp(log σ)² and
    the graph KL overflow f32 in both packages' formula: the frontier's
    loss is not finite from the first step (the card's frontier phase reads
    it there, and the CPU's KL terms).  At N = 1024 it stays finite."""
    import jax.numpy as jnp_

    from snd_vae_tpu.losses import kl_diag_gaussian as jax_kl
    from snd_vae_tpu_torch.losses import kl_diag_gaussian

    mean, logstd = _graph_stats(tmp_path, 2048)
    assert logstd.abs().max() > 0.5 * np.log(np.finfo(np.float32).max)
    assert torch.isinf(kl_diag_gaussian(mean, logstd))
    assert np.isinf(float(jax_kl(jnp_.asarray(mean.numpy()), jnp_.asarray(logstd.numpy()))))
    assert torch.isfinite(kl_diag_gaussian(*_graph_stats(tmp_path, 1024)))


# ---------------------------------------------------------------------------
# E2E's conv lowering at the frontier: the backward of its row and column convs
# ---------------------------------------------------------------------------

def _row_col(dtype, seed=0):
    """A [2,9,9,3] NHWC map, a 1 x 9 kernel of 4 outputs and a bias: the
    shapes of an E2E layer at N = 9 (kernel width N, SAME)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 9, 9, 3, generator=g, dtype=torch.float64).to(dtype).requires_grad_()
    w = torch.randn(4, 3, 1, 9, generator=g, dtype=torch.float64).to(dtype).requires_grad_()
    b = torch.randn(4, generator=g, dtype=torch.float64).to(dtype).requires_grad_()
    return x, w, b


def _plain_row_col(xc, w, b):
    """The two convs as plain autograd ops (what E2E ran before)."""
    import torch.nn.functional as F

    from snd_vae_tpu_torch.nn.basic import same_pad

    H, W, k = xc.shape[2], xc.shape[3], w.shape[-1]
    return (F.conv2d(F.pad(xc, same_pad(W, k, 1)), w, b),
            F.conv2d(F.pad(xc, (0, 0) + same_pad(H, k, 1)), w.transpose(2, 3), b))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_row_col_convs_gradients(dtype):
    """``_row_col_convs``: the forward bit-equal to the plain convs; the
    gradients of the map, the kernel and the bias equal to autograd through
    them (float64 1e-12; f32 1e-6 of the largest magnitude, the map's
    gradient being another convolution; bf16 bit-equal, the library's)."""
    from snd_vae_tpu_torch.nn.edge_conv import _row_col_convs

    x, w, b = _row_col(dtype)
    got = _row_col_convs(x.permute(0, 3, 1, 2), w, b)
    want = _plain_row_col(x.permute(0, 3, 1, 2), w, b)
    for u, v in zip(got, want):
        assert torch.equal(u, v)
    gr, gc = (torch.randn(t.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
              for t in got)
    grads = [torch.autograd.grad((o[0] * gr).sum() + (o[1] * gc).sum(), (x, w, b))
             for o in (got, want)]
    tol = {torch.float64: 1e-12, torch.float32: 1e-6, torch.bfloat16: 0.0}[dtype]
    for u, v in zip(*grads):
        assert (u.double() - v.double()).abs().max() <= tol * v.double().abs().max()
    if dtype == torch.float64:
        assert torch.autograd.gradcheck(
            lambda x, w, b: _row_col_convs(x.permute(0, 3, 1, 2), w, b), (x, w, b))


def test_row_col_convs_keep_the_unpadded_map_and_no_f32_data_gradient():
    """The repair of the frontier's f32 step: the backward keeps only the
    map as it came (autograd kept both SAME-padded copies), and in f32 it
    asks the library for no data gradient of a convolution (cuDNN's f32
    kernel for a 1 x N kernel ran for minutes at N = 2048): the map's
    gradient is a forward convolution."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from snd_vae_tpu_torch.nn.edge_conv import _row_col_convs

    class ConvBackwards(TorchDispatchMode):
        masks = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket == torch.ops.aten.convolution_backward:
                self.masks.append(list(args[-1]))
            return func(*args, **(kwargs or {}))

    x, w, b = _row_col(torch.float32)
    shapes = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: shapes.append(tuple(t.shape)) or t, lambda t: t):
        row, col = _row_col_convs(x.permute(0, 3, 1, 2), w, b)
    assert (2, 3, 9, 9) in shapes and not any(s[2:] in ((9, 17), (17, 9)) for s in shapes)
    with ConvBackwards() as mode:
        (row.sum() + col.sum()).backward()
    assert mode.masks and all(not mask[0] for mask in mode.masks)
