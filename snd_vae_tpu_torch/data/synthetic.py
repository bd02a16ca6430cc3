"""Synthetic spatial-network generator — a numpy copy of
``snd_vae_tpu/data/synthetic.py``, draw for draw, so the same seed gives
the same graphs in both packages.

Random geometric (Waxman-style) and grid spatial networks in a 600x600 box,
node attributes in [0, 120] and per-graph generative factors; every graph
is connected (the spanning-tree augmentation needs it).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

BOX = 600.0      # coordinate range; the reference normalizes coords/rel by /600
FEAT_MAX = 120.0  # feature range; the reference normalizes node features by /120


def _connect(adj: np.ndarray, coords: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Connect components by linking nearest node pairs across components."""
    n = adj.shape[0]
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    xs, ys = np.nonzero(adj)
    for u, v in zip(xs, ys):
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[ru] = rv
    roots = np.array([find(i) for i in range(n)])
    comps = np.unique(roots)
    while len(comps) > 1:
        a = np.nonzero(roots == comps[0])[0]
        b = np.nonzero(roots != comps[0])[0]
        d = np.linalg.norm(coords[a][:, None] - coords[b][None], axis=-1)
        i, j = np.unravel_index(np.argmin(d), d.shape)
        u, v = a[i], b[j]
        adj[u, v] = adj[v, u] = 1
        parent[find(u)] = find(v)
        roots = np.array([find(i) for i in range(n)])
        comps = np.unique(roots)
    return adj


def waxman_graph(
    n: int,
    rng: np.random.Generator,
    spread: float,
    density: float,
    feat_level: float,
    spatial_dim: int = 2,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One Waxman random geometric graph; factors ``spread`` (spatial extent),
    ``density`` (edge probability scale) and ``feat_level`` (mean node
    attribute)."""
    center = BOX / 2 + (rng.random(spatial_dim) - 0.5) * BOX * (1 - spread) * 0.5
    coords = center + (rng.random((n, spatial_dim)) - 0.5) * BOX * spread
    coords = np.clip(coords, 0, BOX)
    d = np.linalg.norm(coords[:, None] - coords[None], axis=-1)
    L = max(d.max(), 1e-9)
    p = density * np.exp(-d / (0.25 * L))
    upper = rng.random((n, n)) < p
    adj = np.triu(upper, k=1)
    adj = (adj | adj.T).astype(np.float64)
    adj = _connect(adj, coords, rng)
    np.fill_diagonal(adj, 0.0)
    feats = np.clip(
        feat_level + rng.normal(0, FEAT_MAX * 0.05, size=(n, 1)), 0, FEAT_MAX
    )
    return adj, coords, feats


def grid_graph(
    n: int, rng: np.random.Generator, spread: float, jitter: float, feat_level: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A jittered grid spatial network."""
    side = int(np.ceil(np.sqrt(n)))
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    pts = np.stack([xs.ravel(), ys.ravel()], axis=-1)[:n].astype(np.float64)
    pts = pts / max(side - 1, 1) * BOX * spread + BOX * (1 - spread) / 2
    pts += rng.normal(0, jitter * BOX * 0.02, pts.shape)
    pts = np.clip(pts, 0, BOX)
    adj = np.zeros((n, n))
    for i in range(n):
        r, c = divmod(i, side)
        for dr, dc in ((0, 1), (1, 0)):
            j = (r + dr) * side + (c + dc)
            if r + dr < side and c + dc < side and j < n:
                adj[i, j] = adj[j, i] = 1
    adj = _connect(adj, pts, rng)
    feats = np.clip(feat_level + rng.normal(0, FEAT_MAX * 0.05, (n, 1)), 0, FEAT_MAX)
    return adj, pts, feats


def generate_synthetic(
    num_graphs: int,
    num_nodes: int = 25,
    seed: int = 0,
    kind: str = "waxman",
    spatial_dim: int = 2,
) -> dict:
    """A raw (unnormalized) synthetic dataset in the reference's on-disk
    contract: adj [G,N,N] (0/1, zero diag), node [G,N,1] in [0,120],
    geometry [G,N,D] in [0,600], rel [G,N,N] distances, prop [G,3] factors."""
    rng = np.random.default_rng(seed)
    adjs, coords, feats, props = [], [], [], []
    for _ in range(num_graphs):
        spread = rng.uniform(0.3, 1.0)
        density = rng.uniform(0.15, 0.7)
        level = rng.uniform(0.2, 0.8) * FEAT_MAX
        if kind == "waxman":
            a, c, f = waxman_graph(num_nodes, rng, spread, density, level, spatial_dim)
        elif kind == "grid":
            a, c, f = grid_graph(num_nodes, rng, spread, density, level)
        else:
            raise ValueError(f"unknown synthetic kind {kind!r}")
        adjs.append(a)
        coords.append(c)
        feats.append(f)
        props.append([spread, density, level / FEAT_MAX])
    adj = np.stack(adjs)
    geometry = np.stack(coords)
    node = np.stack(feats)
    rel = np.linalg.norm(geometry[:, :, None] - geometry[:, None, :], axis=-1)
    return {
        "adj": adj,
        "node": node,
        "geometry": geometry,
        "rel": rel,
        "prop": np.asarray(props),
    }


def save_synthetic_npy(data: dict, path: str, prefix: str = "2D") -> None:
    """Write ``generate_synthetic``'s arrays in the reference's on-disk
    layout (input_data.py:56-60): ``<prefix>_{adj,node,geometry,rel,prop}.npy``
    under ``path``."""
    os.makedirs(path, exist_ok=True)
    for name in ("adj", "node", "geometry", "rel", "prop"):
        np.save(os.path.join(path, f"{prefix}_{name}.npy"), data[name])
