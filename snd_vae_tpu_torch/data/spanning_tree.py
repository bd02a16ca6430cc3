"""Random spanning-tree sampling for the sg-branch augmentation, as
``snd_vae_tpu/data/spanning_tree.py:25-101`` samples: by default with the
native library (``utils/native.py``, the JAX package's C++ sampler, which
draws the JAX package's trees for the same seed), or with
``use_native=False`` by the numpy Kruskal, whose stream is numpy's and so
also the same in both packages.  Where the library cannot be built or
loaded, the default raises; it never falls back to numpy.
"""

from __future__ import annotations

import numpy as np


def _kruskal_random_tree(edges: np.ndarray, num_nodes: int,
                         rng: np.random.Generator) -> np.ndarray:
    """One random spanning tree via Kruskal on uniformly weighted edges.
    ``edges`` [E, 2] lists each undirected edge in both directions; returns
    [T, 2] tree edges, one direction each."""
    e = edges[edges[:, 0] < edges[:, 1]]  # dedupe undirected pairs
    if len(e) == 0:
        return np.zeros((0, 2), dtype=np.int64)
    order = rng.permutation(len(e))  # random weights == random edge order
    parent = np.arange(num_nodes)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:  # path compression
            parent[x], x = root, parent[x]
        return root

    out = []
    for idx in order:
        u, v = int(e[idx, 0]), int(e[idx, 1])
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[ru] = rv
            out.append((u, v))
            if len(out) == num_nodes - 1:
                break
    return np.asarray(out, dtype=np.int64).reshape(-1, 2)


def sample_spanning_tree_adj(adj: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One random spanning-tree adjacency (symmetric, zero diagonal)."""
    n = adj.shape[0]
    x, y = np.nonzero(adj)
    tree = _kruskal_random_tree(np.stack([x, y], axis=1), n, rng)
    out = np.zeros_like(adj)
    if len(tree):
        out[tree[:, 0], tree[:, 1]] = 1
        out[tree[:, 1], tree[:, 0]] = 1
    return out


def sample_spanning_trees(adj_batch: np.ndarray, num_samples: int, seed: int = 0,
                          use_native: bool = True) -> np.ndarray:
    """[G, N, N] adjacencies -> [G, S, N, N] spanning-tree samples: float64
    from the native library, the input's dtype from the numpy Kruskal.  The
    library refuses no nodes or no samples; for those the JAX package's
    default path takes the numpy route, whose result is empty, and so does
    this one."""
    if use_native and num_samples > 0 and adj_batch.shape[1] > 0:
        from ..utils import native

        return native.sample_spanning_trees(adj_batch, num_samples, seed)
    rng = np.random.default_rng(seed)
    G = adj_batch.shape[0]
    out = np.zeros((G, num_samples) + adj_batch.shape[1:], dtype=adj_batch.dtype)
    for g in range(G):
        for s in range(num_samples):
            out[g, s] = sample_spanning_tree_adj(adj_batch[g], rng)
    return out
