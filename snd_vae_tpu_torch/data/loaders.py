"""Dataset loading — the port of ``snd_vae_tpu/data/loaders.py``: the
synthetic datasets (``:58-99``), protein (``:102-141``), mnist's mesh point
clouds (``:144-203``), scene (``:206-275``) and the config-driven entry
point (``:282-384``).

Reads the reference's on-disk layouts when present (the synthetic ``.npy``
files, protein's ``edge_<split>.npy`` / ``node_<split>.npy``, mnist's mesh
pickle, CLEVR's ``CLEVR_<split>_scenes.json``) and generates the data from
the seed otherwise, exactly as the JAX loader does with its numpy
spanning-tree sampler: for the same cfg and seed, every array is bit-equal.
Scene has no spanning trees and a directed adjacency of relation codes;
mnist's adjacency is the convex hull's edges (interior points isolated)
and it has no factors.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Optional, Tuple

import numpy as np

from ..config import Config
from ..device import DeviceLike, resolve_device
from . import synthetic as syn
from .graphbatch import GraphBatch, from_numpy
from .spanning_tree import sample_spanning_trees

TRAIN_SPLITS = ("train",)
SYNTHETIC_SUBDIRS = {
    "synthetic1": "spatial_network_correlated1/25",
    "synthetic2": "spatial_network_correlated2/25",
    "synthetic3": "spatial_network_correlated3/25",
}


def _clean_adj(adj: np.ndarray) -> np.ndarray:
    """Densify, zero the diagonal, check symmetry (input_data.py:61-67)."""
    out = []
    for a in adj:
        a = a.toarray() if hasattr(a, "toarray") else np.asarray(a)
        a = a.astype(np.float64).copy()
        np.fill_diagonal(a, 0)
        if not np.allclose(a, a.T):
            raise ValueError("adjacency must be symmetric")
        out.append(a)
    return np.stack(out)


def _shuffle_all(rng: np.random.Generator, *arrays):
    """Joint shuffle (input_data.py:85-92) with a keyed generator."""
    index = rng.permutation(len(arrays[0]))
    return tuple(None if a is None else a[index] for a in arrays)


def load_data_syn(
    type_: str,
    path: str,
    sampling_num: int = 10,
    seed: int = 1,
    num_graphs_fallback: int = 200,
    num_nodes_fallback: int = 25,
) -> Tuple[np.ndarray, ...]:
    """Synthetic 2D spatial networks (input_data.py:54-142): returns
    (node, spatial, adj_samples, rel, factor, adj_truth), node/spatial/rel
    normalized by 120/600/600, adj_samples [G,S,N,N] spanning trees."""
    split = "train" if type_ in TRAIN_SPLITS else "test"
    d = os.path.join(path, split)
    if os.path.exists(os.path.join(d, "2D_adj.npy")):
        adj = np.load(os.path.join(d, "2D_adj.npy"), allow_pickle=True)
        node = np.load(os.path.join(d, "2D_node.npy"), allow_pickle=True) / syn.FEAT_MAX
        spatial = np.load(os.path.join(d, "2D_geometry.npy"), allow_pickle=True) / syn.BOX
        rel = np.load(os.path.join(d, "2D_rel.npy"), allow_pickle=True) / syn.BOX
        # the reference reads factors from train/ for both splits (input_data.py:103)
        factor = np.load(os.path.join(path, "train", "2D_prop.npy"), allow_pickle=True)
        adj_truth = _clean_adj(adj)
    else:
        data = syn.generate_synthetic(
            num_graphs_fallback,
            num_nodes_fallback,
            seed=seed + (0 if split == "train" else 10_000),
        )
        adj_truth = data["adj"]
        node = data["node"] / syn.FEAT_MAX
        spatial = data["geometry"] / syn.BOX
        rel = data["rel"] / syn.BOX
        factor = data["prop"]

    adj_samples = sample_spanning_trees(adj_truth, sampling_num, seed=seed)
    rng = np.random.default_rng(seed)
    return _shuffle_all(rng, node, spatial, adj_samples, rel, factor, adj_truth)


def load_data_protein(type_: str, path: str, sampling_num: int = 10, seed: int = 1,
                      num_graphs_fallback: int = 64,
                      num_nodes_fallback: int = 50) -> Tuple[np.ndarray, ...]:
    """Protein contact graphs with 3-D coordinates (input_data.py:153-222):
    returns (node, spatial, adj_samples, rel, factor, adj_truth) with
    all-ones node features, rel the pairwise distances and factor 1..G.
    Without ``edge_<split>.npy``, seeded 3-D Waxman graphs stand in, their
    coordinates scaled to protein's range (/ BOX · 20)."""
    split = "train" if type_ in TRAIN_SPLITS else "test"
    edge_f = os.path.join(path, f"edge_{split}.npy")
    if os.path.exists(edge_f):
        adj_truth = np.asarray(np.load(edge_f, allow_pickle=True), dtype=np.float64)
        spatial = np.asarray(np.load(os.path.join(path, f"node_{split}.npy"), allow_pickle=True))
    else:
        rng = np.random.default_rng(seed + (0 if split == "train" else 10_000))
        adjs, coords = [], []
        for _ in range(num_graphs_fallback):
            a, c, _ = syn.waxman_graph(num_nodes_fallback, rng, spread=0.8, density=0.3,
                                       feat_level=1.0, spatial_dim=3)
            adjs.append(a)
            coords.append(c / syn.BOX * 20.0)
        adj_truth, spatial = np.stack(adjs), np.stack(coords)
    G, N = spatial.shape[0], spatial.shape[1]
    node = np.ones((G, N), dtype=np.float64)
    rel = np.linalg.norm(spatial[:, :, None] - spatial[:, None, :], axis=-1)
    factor = np.arange(1, G + 1, dtype=np.float64)[:, None]
    adj_samples = sample_spanning_trees(adj_truth, sampling_num, seed=seed)
    rng = np.random.default_rng(seed)
    return _shuffle_all(rng, node, spatial, adj_samples, rel, factor, adj_truth)


def _convex_hull_adj(points: np.ndarray) -> np.ndarray:
    """Adjacency of the convex hull's triangle edges (input_data.py:235-246,
    through scipy.spatial as the JAX loader does); points inside the hull
    have no edges."""
    from scipy.spatial import ConvexHull

    n = points.shape[0]
    adj = np.zeros((n, n), dtype=np.float64)
    for a, b, c in ConvexHull(points).simplices:
        adj[a, b] = adj[b, a] = 1
        adj[b, c] = adj[c, b] = 1
        adj[a, c] = adj[c, a] = 1
    return adj


def load_data_mnist(type_: str, path: str, seed: int = 1, num_points: int = 50,
                    num_graphs_fallback: int = 64) -> Tuple[np.ndarray, ...]:
    """3-D mesh point clouds (input_data.py:224-300): ``num_points`` per
    mesh, the convex hull's adjacency, coordinates shifted by +10; returns
    (node, spatial, adj, rel), no spanning trees and no factors.  Without
    the mesh pickle, seeded noisy 3-D curves stand in."""
    split = "train" if type_ in TRAIN_SPLITS else "test"
    f = os.path.join(path, f"mnist-combined-{split}-tasp_meshes.pickle")
    clouds = []
    if os.path.exists(f):
        with open(f, "rb") as fh:
            data = pickle.load(fh)
        clouds = [np.asarray(mesh.sample_points(npoints=num_points)) for mesh in data.data]
    else:
        rng = np.random.default_rng(seed + (0 if split == "train" else 10_000))
        for _ in range(num_graphs_fallback):
            t = np.sort(rng.random(num_points)) * 2 * np.pi
            clouds.append(np.stack(
                [np.cos(t) + rng.normal(0, 0.15, num_points),
                 np.sin(2 * t) * 0.5 + rng.normal(0, 0.15, num_points),
                 t / (2 * np.pi) + rng.normal(0, 0.15, num_points)], axis=-1))
    spatial = np.stack(clouds)
    adj = _clean_adj(np.stack([_convex_hull_adj(c) for c in clouds]))
    G, N = spatial.shape[:2]
    node = np.ones((G, N), dtype=np.float64)
    rel = np.linalg.norm(spatial[:, :, None] - spatial[:, None, :], axis=-1)
    adj, node, spatial, rel = _shuffle_all(np.random.default_rng(seed), adj, node, spatial, rel)
    return node, spatial + 10.0, adj, rel


def tile_skew_pairing(node: np.ndarray, rel: np.ndarray,
                      num_samples: int) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's sample/graph pairing skew as per-sample arrays
    (stream index m of the tree-major sample stream is fed graph m % G)."""
    G = node.shape[0]
    m = np.arange(G * num_samples)
    skew = (m % G).reshape(G, num_samples)
    return node[skew], rel[skew]


def load_data_scene(type_: str, path: str, seed: int = 1,
                    num_graphs_fallback: int = 64) -> Tuple[np.ndarray, ...]:
    """CLEVR scenes with exactly 10 objects (input_data.py:309-415):
    returns (node, spatial, adj, rel) with one-hot shapes [G,10,3], 3D
    coordinates, a directed adjacency of relation codes 0..4 (none, then
    the merged right-left / behind-front pairs) and pairwise distances.
    The eval split is ``val``.  Without the JSON file, a seeded generator
    (codes 1 and 2 from the x order) stands in."""
    split = "train" if type_ in TRAIN_SPLITS else "val"
    size = 10
    f = os.path.join(path, f"CLEVR_{split}_scenes.json")
    shapes = ["sphere", "cylinder", "cube"]
    rel_feature = ["right", "behind", "front", "left"]
    rel_pairs = [{"12", "21"}, {"13", "31"}, {"24", "42"}, {"34", "43"}]
    node, spatial, adj = [], [], []
    if os.path.exists(f):
        with open(f) as fh:
            data = json.load(fh)
        for scene in data["scenes"]:
            objs = scene["objects"]
            if len(objs) != size:
                continue
            spatial.append([o["3d_coords"] for o in objs])
            oh = np.zeros((size, len(shapes)))
            for j, o in enumerate(objs):
                oh[j, shapes.index(o["shape"])] = 1
            node.append(oh)
            a = np.zeros((size, size), dtype=np.int64)
            merged = np.full((size, size), "", dtype=object)
            for direction, rels in scene["relationships"].items():
                code = rel_feature.index(direction) + 1
                for k, members in enumerate(rels):
                    for m in members:
                        merged[m][k] += str(code)
                        a[m][k] = code
            for i in range(size):
                for k in range(size):
                    for pi, pair in enumerate(rel_pairs):
                        if merged[i][k] in pair:
                            a[i][k] = pi + 1
            adj.append(a)
    else:
        rng = np.random.default_rng(seed + (0 if split == "train" else 10_000))
        for _ in range(num_graphs_fallback):
            pts = rng.uniform(-3, 3, (size, 3))
            oh = np.zeros((size, len(shapes)))
            oh[np.arange(size), rng.integers(0, len(shapes), size)] = 1
            a = np.where(pts[:, None, 0] > pts[None, :, 0], 1, 2)
            np.fill_diagonal(a, 0)
            node.append(oh)
            spatial.append(pts)
            adj.append(a)
    node = np.asarray(node, dtype=np.float64).reshape(-1, size, len(shapes))
    spatial = np.asarray(spatial, dtype=np.float64)
    adj = np.asarray(adj, dtype=np.float64)
    rel = np.linalg.norm(spatial[:, :, None] - spatial[:, None, :], axis=-1)
    adj, node, spatial, rel = _shuffle_all(np.random.default_rng(seed), adj, node, spatial, rel)
    return node, spatial, adj, rel


def _load_raw(cfg: Config, split: str, num_graphs: Optional[int]):
    """(adj, node, spatial, rel, adj_samples, factor, feat_samples,
    rel_samples) of ``cfg``'s dataset as numpy arrays (JAX
    ``_load_raw_dataset``, ``loaders.py:339-385``)."""
    n_fallback, seed = num_graphs or 200, cfg.train.seed
    if cfg.dataset == "scene":
        node, spatial, adj, rel = load_data_scene(split, cfg.dataset_path, seed=seed,
                                                  num_graphs_fallback=n_fallback)
        return adj, node, spatial, rel, None, None, None, None
    factor = None
    if cfg.dataset == "mnist":
        node, spatial, adj_truth, rel = load_data_mnist(
            split, os.path.join(cfg.dataset_path, "3D_mesh"), seed=seed,
            num_points=cfg.num_nodes, num_graphs_fallback=n_fallback)
        adj_s = sample_spanning_trees(adj_truth, cfg.sampling_num, seed=seed)
    elif cfg.dataset == "protein":
        node, spatial, adj_s, rel, factor, adj_truth = load_data_protein(
            split, os.path.join(cfg.dataset_path, "protein"), cfg.sampling_num, seed=seed,
            num_graphs_fallback=n_fallback, num_nodes_fallback=cfg.num_nodes)
    else:
        node, spatial, adj_s, rel, factor, adj_truth = load_data_syn(
            split, os.path.join(cfg.dataset_path, SYNTHETIC_SUBDIRS[cfg.dataset]),
            cfg.sampling_num, seed=seed, num_graphs_fallback=n_fallback,
            num_nodes_fallback=cfg.num_nodes)
    feat_s = rel_s = None
    if cfg.reproduce_pairing_skew:
        feat_s, rel_s = tile_skew_pairing(
            node if node.ndim == 3 else node[..., None],
            rel if rel.ndim == 4 else rel[..., None],
            adj_s.shape[1],
        )
    return adj_truth, node, spatial, rel, adj_s, factor, feat_s, rel_s


def train_coord_bounds(cfg: Config) -> Tuple[float, float]:
    """Scalar (lo, hi) bounds of the train split's raw coordinates, the
    affine map of ``Config.normalize_coords``."""
    spatial = _load_raw(cfg, "train", None)[2]
    c = spatial.astype(np.float32)
    return float(c.min()), float(c.max())


def load_dataset(cfg: Config, split: str = "train", num_graphs: Optional[int] = None,
                 device: DeviceLike = None) -> GraphBatch:
    """The configured dataset as a float32 GraphBatch on ``device`` (CUDA
    unless named).  Spanning-tree samples (none for scene) pair with their
    own graph unless ``cfg.reproduce_pairing_skew``; ``cfg.normalize_coords`` maps
    coordinates and rel distances by the train split's bounds."""
    dev = resolve_device(device)
    adj, node, spatial, rel, adj_s, factor, feat_s, rel_s = _load_raw(cfg, split, num_graphs)
    batch = from_numpy(adj, node, spatial, rel, adj_samples=adj_s, factors=factor,
                       feat_samples=feat_s, rel_samples=rel_s)
    if cfg.normalize_coords:
        lo, hi = train_coord_bounds(cfg)
        scale = max(hi - lo, 1e-9)
        batch.coords = (batch.coords - lo) / scale
        batch.rel = batch.rel / scale
        if batch.rel_samples is not None:
            batch.rel_samples = batch.rel_samples / scale
    return batch.to(dev)
