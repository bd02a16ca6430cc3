"""The port's native data-path library (``snd_vae_tpu_torch/utils/native.py``)
against the JAX package's (``snd_vae_tpu/utils/native.py``, built privately
for the test by ``jax_native``): the same trees bit for bit, the same
distances, the hashed build path, and no fallback when the compiler
fails."""

import numpy as np
import pytest
from torch_parity import jax_native  # noqa: F401  (fixture)

import snd_vae_tpu.data.spanning_tree as jax_spanning_tree
from snd_vae_tpu_torch.data import spanning_tree
from snd_vae_tpu_torch.utils import native


def _random_adj(rng, G, N, p):
    a = np.triu((rng.random((G, N, N)) < p).astype(np.float64), 1)
    return a + np.swapaxes(a, 1, 2)


def _components(adj):
    """Each node's component label (the smallest node index in it)."""
    n = len(adj)
    label = list(range(n))
    for i in range(n):
        for j in np.nonzero(adj[i])[0]:
            a, b = label[i], label[j]
            if a != b:
                lo, hi = min(a, b), max(a, b)
                label = [lo if x == hi else x for x in label]
    return label


@pytest.mark.parametrize("G,N,S,seed,p", [
    (3, 8, 4, 0, 0.5),
    (5, 25, 10, 1, 0.3),
    (2, 50, 3, 12345, 0.1),     # sparse: disconnected graphs, spanning forests
    (4, 1, 2, 7, 0.5),          # one node: no edges
    (1, 30, 1, 2 ** 40 + 3, 0.9),
])
def test_trees_bit_equal_to_jax_native(jax_native, G, N, S, seed, p):
    adj = _random_adj(np.random.default_rng(seed % 1000), G, N, p)
    got = spanning_tree.sample_spanning_trees(adj, S, seed=seed)
    want = jax_spanning_tree.sample_spanning_trees(adj, S, seed=seed)
    np.testing.assert_array_equal(got, jax_native.sample_spanning_trees(adj, S, seed))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.float64 and got.shape == (G, S, N, N)
    assert np.array_equal(got, spanning_tree.sample_spanning_trees(adj, S, seed=seed))
    # every tree lies inside A, is symmetric and spans each component of A
    assert np.all(got <= adj[:, None]) and np.array_equal(got, np.swapaxes(got, -1, -2))
    for g in range(G):
        comps = _components(adj[g])
        for s in range(S):
            assert _components(got[g, s]) == comps
            assert got[g, s].sum() == 2 * (N - len(set(comps)))


def test_disconnected_graph_bit_equal_and_a_forest(jax_native):
    """Two triangles and an isolated node: one forest of 4 edges."""
    a = np.zeros((1, 7, 7))
    for i, j in ((0, 1), (1, 2), (0, 2), (3, 4), (4, 5), (3, 5)):
        a[0, i, j] = a[0, j, i] = 1.0
    got = spanning_tree.sample_spanning_trees(a, 6, seed=5)
    np.testing.assert_array_equal(got, jax_spanning_tree.sample_spanning_trees(a, 6, seed=5))
    assert np.all(got.sum(axis=(-1, -2)) == 2 * 4) and not got[..., 6, :].any()


@pytest.mark.parametrize("shape", [(3, 0, 0), (2, 5, 5)])
def test_empty_sizes_follow_jax_default(jax_native, shape):
    """No nodes, or no samples: the library refuses them and JAX's default
    path takes the numpy route; the port returns the same empty result."""
    adj = np.ones(shape, np.float32)
    got = spanning_tree.sample_spanning_trees(adj, 0 if shape[1] else 2, seed=1)
    want = jax_spanning_tree.sample_spanning_trees(adj, 0 if shape[1] else 2, seed=1)
    assert got.shape == want.shape and got.dtype == want.dtype


def test_numpy_route_bit_equal_to_jax_numpy_route():
    adj = _random_adj(np.random.default_rng(3), 3, 12, 0.4)
    got = spanning_tree.sample_spanning_trees(adj, 4, seed=9, use_native=False)
    np.testing.assert_array_equal(
        got, jax_spanning_tree.sample_spanning_trees(adj, 4, seed=9, use_native=False))
    assert not np.array_equal(got, spanning_tree.sample_spanning_trees(adj, 4, seed=9))


@pytest.mark.parametrize("G,N,D", [(4, 25, 2), (3, 50, 3), (1, 1, 3)])
def test_pairwise_distances_bit_equal_to_jax_native(jax_native, G, N, D):
    coords = np.random.default_rng(N).uniform(-20, 20, (G, N, D))
    got = native.pairwise_distances(coords)
    np.testing.assert_array_equal(got, jax_native.pairwise_distances(coords))
    want = np.linalg.norm(coords[:, :, None] - coords[:, None, :], axis=-1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got.dtype == np.float64 and np.all(np.diagonal(got, axis1=1, axis2=2) == 0)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The port's library built into an empty directory, as on a new host."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path / "native"


def test_hashed_build_path(fresh_build, monkeypatch):
    path = native.library_path()
    assert path.parent == fresh_build and path.name.startswith("libsndkern_")
    assert len(path.name) == len("libsndkern_") + 16 + len(".so")
    assert native.build() > 0 and path.exists()
    assert [p.name for p in fresh_build.iterdir()] == [path.name]   # no temporary left
    assert native.build() == 0.0                                    # built once
    adj = _random_adj(np.random.default_rng(0), 2, 10, 0.5)
    assert native.sample_spanning_trees(adj, 3, 4).shape == (2, 3, 10, 10)
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-DSND_OTHER",))
    assert native.library_path() != path and native.library_path().parent == fresh_build


def test_failing_compiler_raises_without_fallback(fresh_build, monkeypatch):
    monkeypatch.setenv("CXX", "false")
    adj = _random_adj(np.random.default_rng(0), 2, 6, 0.5)
    with pytest.raises(RuntimeError, match="exited 1"):
        spanning_tree.sample_spanning_trees(adj, 2, seed=0)
    with pytest.raises(RuntimeError, match="exited 1"):
        native.pairwise_distances(np.zeros((1, 3, 2)))
    assert not fresh_build.exists() or not any(fresh_build.iterdir())
    # the numpy route is the explicit choice
    assert spanning_tree.sample_spanning_trees(adj, 2, seed=0, use_native=False).shape == (
        2, 2, 6, 6)


def test_wrong_shapes_raise_before_the_library():
    with pytest.raises(ValueError, match=r"\[G, N, N\]"):
        native.sample_spanning_trees(np.ones((2, 3, 4)), 2)
    with pytest.raises(ValueError, match=r"\[G, N, D\]"):
        native.pairwise_distances(np.ones((3, 4)))


def test_missing_compiler_raises(fresh_build, monkeypatch):
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C.. compiler"):
        spanning_tree.sample_spanning_trees(np.ones((1, 3, 3)), 2)
