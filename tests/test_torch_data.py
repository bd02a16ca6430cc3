"""The port's data pipeline (the synthetic datasets, protein, mnist) is
bit-equal to the JAX package's for the same cfg and seed.

Both packages sample spanning trees with their native library by default
(``snd_vae_tpu/data/spanning_tree.py:75-101``); the JAX side's library is
built privately for the test (``jax_native``), so its default path runs
here and not its numpy fallback.  With ``use_native=False`` on both sides
(the numpy Kruskal) the loaders are bit-equal too."""

import functools

import numpy as np
import pytest
import torch
from torch_parity import jax_native  # noqa: F401  (fixture)

import snd_vae_tpu.data.spanning_tree as jax_spanning_tree
from snd_vae_tpu import config as jcfg
from snd_vae_tpu.data import loaders as jax_loaders
from snd_vae_tpu.data.loaders import load_dataset as jax_load_dataset
from snd_vae_tpu_torch import config as tcfg
from snd_vae_tpu_torch.data import loaders
from snd_vae_tpu_torch.data import spanning_tree
from snd_vae_tpu_torch.data.graphbatch import GraphBatch
from snd_vae_tpu_torch.data.loaders import load_dataset

FIELDS = ("adj", "features", "coords", "rel", "adj_samples", "factors",
          "node_mask", "feat_samples", "rel_samples")


@pytest.fixture
def numpy_route(jax_native, monkeypatch):
    """Both packages' loaders on the numpy Kruskal (``use_native=False``)."""
    for mod, fn in ((jax_loaders, jax_spanning_tree.sample_spanning_trees),
                    (loaders, spanning_tree.sample_spanning_trees)):
        monkeypatch.setattr(mod, "sample_spanning_trees", functools.partial(fn, use_native=False))


LOADER_CASES = [
    ("synthetic2", "test", {}),
    ("synthetic2", "train", {}),
    ("synthetic1", "test", {"sampling_num": 3}),
    ("synthetic3", "train", {"reproduce_pairing_skew": True, "sampling_num": 4}),
    ("synthetic2", "test", {"normalize_coords": True}),
    ("protein", "test", {}),
    ("protein", "train", {"normalize_coords": True, "sampling_num": 3}),
    ("mnist", "test", {}),
    ("mnist", "train", {"reproduce_pairing_skew": True, "sampling_num": 2}),
    ("mnist", "test", {"normalize_coords": True, "num_nodes": 30}),
]


@pytest.mark.parametrize("dataset,split,over", LOADER_CASES)
def test_load_dataset_bit_equal(jax_native, tmp_path, dataset, split, over):
    """Both generate from the seed: the dataset path holds no files
    (protein: seeded 3-D Waxman graphs; mnist: noisy 3-D curves and their
    convex hulls).  Each package samples with its default, the native
    library."""
    over = dict(over, dataset_path=str(tmp_path))
    _assert_bit_equal(jcfg.preset(dataset, **over), tcfg.preset(dataset, **over), split)


@pytest.mark.parametrize("dataset,split,over", LOADER_CASES)
def test_load_dataset_bit_equal_numpy_route(numpy_route, tmp_path, dataset, split, over):
    """The same cases with ``use_native=False`` on both sides."""
    over = dict(over, dataset_path=str(tmp_path))
    _assert_bit_equal(jcfg.preset(dataset, **over), tcfg.preset(dataset, **over), split)


def _assert_bit_equal(jc, tc, split, num_graphs=12):
    want = jax_load_dataset(jc, split, num_graphs=num_graphs)
    got = load_dataset(tc, split, num_graphs=num_graphs, device="cpu")
    for f in FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if w is not None:
            assert g.dtype == torch.float32, f
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
    return got


# the authors' on-disk layouts, written by the JAX package's own tests'
# writers (G = 6 graphs of N = 12 nodes): synthetic's 2D_adj.npy as an
# object array of scipy sparse matrices, mnist's mesh pickle
LAYOUT_CASES = [(ds, split, norm) for ds in ("synthetic2", "mnist")
                for split in ("train", "test") for norm in (False, True)]


@pytest.mark.parametrize("dataset,split,normalize", LAYOUT_CASES)
def test_authors_layout_bit_equal(jax_native, tmp_path, dataset, split, normalize):
    """Both packages' loaders give bit-equal batches from the authors'
    files, both splits, with and without ``normalize_coords``; the batch
    holds the files' graphs (in the loaders' order), not the seeded
    fallback."""
    import pickle

    from test_data_roundtrip import FakeMesh, FakeMeshData
    from test_realdata_e2e import G, N, _write_synthetic

    rng = np.random.default_rng(4)
    if dataset == "synthetic2":
        _write_synthetic(tmp_path, rng)
        path = tmp_path / "spatial_network_correlated2" / "25" / split / "2D_adj.npy"
        written = [m.toarray() for m in np.load(path, allow_pickle=True)]
    else:
        (tmp_path / "3D_mesh").mkdir()
        for s in ("train", "test"):
            clouds = [rng.normal(0, 1.0, (N, 3)) for _ in range(G)]
            with open(tmp_path / "3D_mesh" / f"mnist-combined-{s}-tasp_meshes.pickle", "wb") as f:
                pickle.dump(FakeMeshData([FakeMesh(c) for c in clouds]), f)
            if s == split:
                written = [c + 10.0 for c in clouds]   # the reference's shift
    over = dict(dataset_path=str(tmp_path) + "/", num_nodes=N, sampling_num=2,
                normalize_coords=normalize)
    got = _assert_bit_equal(jcfg.preset(dataset, **over), tcfg.preset(dataset, **over), split,
                            num_graphs=G)
    if dataset == "synthetic2" or not normalize:
        held = got.adj if dataset == "synthetic2" else got.coords
        for g in held.numpy():
            assert any(np.allclose(g, w, rtol=1e-6, atol=1e-5) for w in written)


def test_graph_batch_slice_and_to():
    b = load_dataset(tcfg.synthetic2_preset(), "test", num_graphs=6, device="cpu")
    assert (b.batch_size, b.num_nodes, b.num_samples) == (6, 25, 10)
    s = b.slice_batch(2, 3)
    assert isinstance(s, GraphBatch) and s.batch_size == 3
    assert torch.equal(s.adj_samples, b.adj_samples[2:5])
    d = s.to("cpu", torch.float64)
    assert d.adj.dtype == torch.float64 and d.factors.dtype == torch.float32
    assert d.device == torch.device("cpu")


def test_spanning_trees_are_trees():
    b = load_dataset(tcfg.synthetic2_preset(), "test", num_graphs=4, device="cpu")
    trees = b.adj_samples.numpy()
    assert np.all(trees <= b.adj.numpy()[:, None])            # subgraphs of the truth
    assert np.all(trees.sum(axis=(-1, -2)) == 2 * (25 - 1))   # N-1 undirected edges
    assert np.array_equal(trees, np.swapaxes(trees, -1, -2))


def test_unported_dataset_raises(jax_native, tmp_path):
    """protein is ported: its on-disk layout (``edge_<split>.npy`` and
    ``node_<split>.npy`` under ``<dataset_path>/protein``), a few graphs of
    10 nodes written to tmp_path, loads bit-equal to JAX's, each split from
    its own files."""
    rng = np.random.default_rng(0)
    (tmp_path / "protein").mkdir()
    for split, G in (("train", 6), ("test", 4)):
        adj = np.triu((rng.random((G, 10, 10)) < 0.4).astype(np.float64), 1)
        np.save(tmp_path / "protein" / f"edge_{split}.npy", adj + np.swapaxes(adj, 1, 2))
        np.save(tmp_path / "protein" / f"node_{split}.npy", rng.uniform(0, 20, (G, 10, 3)))
    over = dict(dataset_path=str(tmp_path), num_nodes=10, sampling_num=3)
    for split, G in (("train", 6), ("test", 4)):
        _assert_bit_equal(jcfg.preset("protein", **over), tcfg.preset("protein", **over), split)
        got = load_dataset(tcfg.preset("protein", **over), split, device="cpu")
        assert got.batch_size == G and got.factors.shape == (G, 1)


def test_convex_hull_adj_matches_jax():
    """mnist's hull adjacency on seeded 3-D clouds, with points well inside
    the hull: equal to JAX's, symmetric, and the interior points isolated."""
    rng = np.random.default_rng(3)
    for _ in range(4):
        shell = rng.standard_normal((40, 3))
        shell /= np.linalg.norm(shell, axis=1, keepdims=True)
        pts = np.concatenate([shell, 0.1 * rng.standard_normal((10, 3))])
        got = loaders._convex_hull_adj(pts)
        np.testing.assert_array_equal(got, jax_loaders._convex_hull_adj(pts))
        assert np.array_equal(got, got.T) and not got[40:].any() and got[:40].any(1).all()


@pytest.mark.parametrize("dataset", ["protein", "mnist"])
def test_train_coord_bounds_match_jax(jax_native, tmp_path, dataset):
    """normalize_coords' affine map: the train split's scalar bounds."""
    over = dict(dataset_path=str(tmp_path), normalize_coords=True)
    want = jax_loaders.train_coord_bounds(jcfg.preset(dataset, **over))
    assert loaders.train_coord_bounds(tcfg.preset(dataset, **over)) == want
