"""The port's synthetic data pipeline is bit-equal to the JAX package's for
the same cfg and seed.

The JAX loader takes the ctypes spanning-tree sampler whenever
``native/libsndkern.so`` is built (``snd_vae_tpu/data/spanning_tree.py:87``);
its random stream differs from the numpy Kruskal, which is the only sampler
the port keeps.  So the JAX side runs with the native sampler disabled."""

import numpy as np
import pytest
import torch

import snd_vae_tpu.utils.native
from snd_vae_tpu import config as jcfg
from snd_vae_tpu.data.loaders import load_dataset as jax_load_dataset
from snd_vae_tpu_torch import config as tcfg
from snd_vae_tpu_torch.data.graphbatch import GraphBatch
from snd_vae_tpu_torch.data.loaders import load_dataset

FIELDS = ("adj", "features", "coords", "rel", "adj_samples", "factors",
          "node_mask", "feat_samples", "rel_samples")


@pytest.fixture
def numpy_sampler(monkeypatch):
    monkeypatch.setattr(snd_vae_tpu.utils.native, "available", lambda: False)


@pytest.mark.parametrize("dataset,split,over", [
    ("synthetic2", "test", {}),
    ("synthetic2", "train", {}),
    ("synthetic1", "test", {"sampling_num": 3}),
    ("synthetic3", "train", {"reproduce_pairing_skew": True, "sampling_num": 4}),
    ("synthetic2", "test", {"normalize_coords": True}),
])
def test_load_dataset_bit_equal(numpy_sampler, tmp_path, dataset, split, over):
    """Both generate from the seed: the dataset path holds no files."""
    over = dict(over, dataset_path=str(tmp_path))
    want = jax_load_dataset(jcfg.preset(dataset, **over), split, num_graphs=12)
    got = load_dataset(tcfg.preset(dataset, **over), split, num_graphs=12, device="cpu")
    for f in FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if w is not None:
            assert g.dtype == torch.float32, f
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)


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


def test_unported_dataset_raises():
    with pytest.raises(NotImplementedError):
        load_dataset(tcfg.preset("protein"), "test", num_graphs=2, device="cpu")
