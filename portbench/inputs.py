"""Inputs and weights of a cell, made from ``--seed`` by the benchmark itself.

The graphs are frozen numpy copies of the port's generators
(``snd_vae_tpu_torch/data/synthetic.py`` and ``data/spanning_tree.py``'s numpy
Kruskal route), so the yardstick does not move when the program's loaders do:

  * ``waxman``: the synthetic datasets' generated split (``generate_synthetic``:
    a per-graph spread, density and feature level, 600 x 600 box, features in
    [0, 120], then / 120 and / 600);
  * ``waxman3d``: protein's stand-in (3-D Waxman graphs, spread 0.8, density
    0.3, coordinates / 600 x 20, all-ones features), as the port's loader
    draws it where the paper's protein files are absent.

Every graph is connected, so each of its spanning trees has N - 1 edges.  The
sizes depend on the configuration and the traffic alone, never on the seed:
a seed changes the values, not the work.

The weights are drawn on the device from a ``torch.Generator`` seeded with the
run's seed, in two calls (one normal, one uniform draw for every leaf at once),
in the distributions the port's initializers use (``nn/init.py``): normal and
truncated normal (folded into [-2σ, 2σ] by ``fmod``) at σ = 0.02, glorot
uniform for the 1-D convs, zero biases, unit norm scales.  The names and shapes
are the reference's (``reference.model.param_spec``), which the port's state
dict must match.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

BOX = 600.0
FEAT_MAX = 120.0


def _connect(adj: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Link the nearest pair across components until the graph is connected."""
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


def waxman_graph(n: int, rng: np.random.Generator, spread: float, density: float,
                 feat_level: float, spatial_dim: int) -> Tuple[np.ndarray, ...]:
    center = BOX / 2 + (rng.random(spatial_dim) - 0.5) * BOX * (1 - spread) * 0.5
    coords = np.clip(center + (rng.random((n, spatial_dim)) - 0.5) * BOX * spread, 0, BOX)
    d = np.linalg.norm(coords[:, None] - coords[None], axis=-1)
    p = density * np.exp(-d / (0.25 * max(d.max(), 1e-9)))
    upper = np.triu(rng.random((n, n)) < p, k=1)
    adj = _connect((upper | upper.T).astype(np.float64), coords)
    np.fill_diagonal(adj, 0.0)
    feats = np.clip(feat_level + rng.normal(0, FEAT_MAX * 0.05, size=(n, 1)), 0, FEAT_MAX)
    return adj, coords, feats


def random_tree(adj: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One random spanning tree of ``adj`` (Kruskal on a random edge order)."""
    n = adj.shape[0]
    x, y = np.nonzero(adj)
    e = np.stack([x, y], axis=1)
    e = e[e[:, 0] < e[:, 1]]
    parent = np.arange(n)

    def find(v: int) -> int:
        root = v
        while parent[root] != root:
            root = parent[root]
        while parent[v] != root:
            parent[v], v = root, parent[v]
        return root

    out = np.zeros_like(adj)
    taken = 0
    for idx in rng.permutation(len(e)):
        u, v = int(e[idx, 0]), int(e[idx, 1])
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[ru] = rv
            out[u, v] = out[v, u] = 1
            taken += 1
            if taken == n - 1:
                break
    return out


def make_split(cfg: dict, num_graphs: int, seed: int, split: str) -> Dict[str, np.ndarray]:
    """``num_graphs`` graphs of ``cfg``'s generator with S spanning trees each,
    as float32 host arrays: adj [G,N,N], features [G,N,F], coords [G,N,D],
    rel [G,N,N,1] (pairwise distances), adj_samples [G,S,N,N]."""
    N, D, S = cfg["num_nodes"], cfg["spatial_dim"], cfg["sampling_num"]
    rng = np.random.default_rng([seed, {"train": 0, "test": 1}[split]])
    adjs, coords, feats = [], [], []
    for _ in range(num_graphs):
        if cfg["generator"] == "waxman":
            spread, density = rng.uniform(0.3, 1.0), rng.uniform(0.15, 0.7)
            level = rng.uniform(0.2, 0.8) * FEAT_MAX
            a, c, f = waxman_graph(N, rng, spread, density, level, D)
            c, f = c / BOX, f / FEAT_MAX
        elif cfg["generator"] == "waxman3d":
            a, c, _ = waxman_graph(N, rng, 0.8, 0.3, 1.0, D)
            c, f = c / BOX * 20.0, np.ones((N, 1))
        else:
            raise ValueError(f"unknown generator {cfg['generator']!r}")
        adjs.append(a)
        coords.append(c)
        feats.append(f)
    adj, coords = np.stack(adjs), np.stack(coords)
    trees = np.stack([np.stack([random_tree(a, rng) for _ in range(S)]) for a in adj])
    rel = np.linalg.norm(coords[:, :, None] - coords[:, None, :], axis=-1)[..., None]
    f32 = lambda t: np.ascontiguousarray(t, dtype=np.float32)
    return {"adj": f32(adj), "features": f32(np.stack(feats)), "coords": f32(coords),
            "rel": f32(rel), "adj_samples": f32(trees)}


def make_weights(spec: List[Tuple[str, tuple, str]], seed: int,
                 device) -> Dict[str, "torch.Tensor"]:
    """The model's initial f32 weights from ``seed``, on ``device``: one normal
    and one uniform draw for all leaves, split and scaled per leaf."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {kind: sum(math.prod(shape) for _, shape, k in spec if k == kind)
             for kind in ("normal", "truncated", "glorot")}
    normal = torch.randn(sizes["normal"] + sizes["truncated"], generator=gen, device=device)
    uniform = torch.rand(sizes["glorot"], generator=gen, device=device)
    out, o_n, o_u = {}, 0, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        if kind in ("normal", "truncated"):
            w = normal[o_n:o_n + n]
            o_n += n
            w = (w.fmod(2.0) if kind == "truncated" else w) * 0.02
        elif kind == "glorot":
            out_c, in_c, k = shape            # [out, in, k]: flax's fans of [k, in, out]
            limit = math.sqrt(6.0 / ((in_c + out_c) * k))
            w = (uniform[o_u:o_u + n] * 2.0 - 1.0) * limit
            o_u += n
        elif kind == "zeros":
            w = torch.zeros(n, device=device)
        elif kind == "ones":
            w = torch.ones(n, device=device)
        else:
            raise ValueError(f"unknown init {kind!r}")
        out[name] = w.reshape(shape).contiguous()
    return out
