"""Spatial-graph figures — the port of ``snd_vae_tpu/visualize.py`` without
matplotlib.  The six functions keep the JAX module's names, signatures and
defaults, and draw the same scene: each builds a ``Figure`` of panels
holding what matplotlib's axes would hold (line segments, scatter points
with their RGBA, titles, axis-off cells, colourbar ranges), renders it
with the numpy raster of ``utils/raster.py`` at the pixel size
matplotlib's ``savefig(dpi=150)`` gives the same figsize, and writes it as
PNG where ``save_path`` is given.  Each returns its ``Figure``: ``pixels``
[H, W, 3] uint8 and ``panels``, a grid of ``Panel``.

Colours follow matplotlib's: node colour is the first feature channel
through ``Normalize`` (the panel's min and max) and viridis; points
without a colour take C0.  Fonts and anti-aliasing are the raster's own,
so the pixels differ from matplotlib's; the scene does not.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .utils import raster

DPI = 150
PX_PER_PT = DPI / 72
GRAY = (0.6, 0.6, 0.6, 1.0)      # matplotlib's color="0.6"
MARGIN = 0.05                    # matplotlib's axes.xmargin / ymargin
ELEV, AZIM = 30.0, -60.0         # matplotlib's default 3D view


class Panel:
    """One axes: its line segments [E, 2, D] (D = 2, or 3 for a 3D
    panel), its scatter points [n, D] with their RGBA [n, 4], its title
    and axis labels, whether its axis is off, and its colourbar's (vmin,
    vmax) or None."""

    def __init__(self, projection: Optional[str] = None):
        dim = 3 if projection == "3d" else 2
        self.projection = projection
        self.segments = np.zeros((0, 2, dim))
        self.points = np.zeros((0, dim))
        self.rgba = np.zeros((0, 4))
        self.line_color, self.line_width = GRAY, 0.8     # points
        self.point_size = 20.0                           # points²
        self.title = self.xlabel = self.ylabel = ""
        self.axis_off = False
        self.equal = False
        self.colorbar: Optional[Tuple[float, float]] = None

    def plot(self, segments: np.ndarray, color=GRAY, linewidth: float = 0.8) -> None:
        self.segments = np.concatenate([self.segments, np.asarray(segments, np.float64)])
        self.line_color, self.line_width = color, linewidth

    def scatter(self, points: np.ndarray, rgba: np.ndarray, s: float) -> None:
        self.points = np.concatenate([self.points, np.asarray(points, np.float64)])
        self.rgba = np.concatenate([self.rgba, rgba])
        self.point_size = s

    def draw(self, canvas: raster.Canvas, x0: float, y0: float, x1: float, y1: float) -> None:
        """Render into the cell [x0, x1) x [y0, y1) of the canvas."""
        if self.axis_off and not len(self.points) and not len(self.segments):
            return
        pad, gap = 6, 4
        x0, y0, x1, y1 = x0 + pad, y0 + pad, x1 - pad, y1 - pad
        if self.title:
            canvas.text((x0 + x1) / 2, y0, self.title, va="top")
            y0 += raster.LINE_HEIGHT + gap
        if self.xlabel:
            canvas.text((x0 + x1) / 2, y1, self.xlabel, va="bottom")
            y1 -= raster.LINE_HEIGHT + gap
        if self.ylabel:
            canvas.text(x0, (y0 + y1) / 2, self.ylabel, ha="left", rotate=True)
            x0 += raster.LINE_HEIGHT + gap
        if self.colorbar is not None:
            x1 = self._draw_colorbar(canvas, x0, y0, x1, y1)
        if x1 - x0 < 4 or y1 - y0 < 4:
            return
        segs, pts, box = self.segments, self.points, None
        if self.projection == "3d":
            segs, pts, box = _project(segs, pts)
        elif not self.axis_off:
            canvas.frame(x0, y0, x1, y1)
        extent = [segs.reshape(-1, 2), pts] + ([] if box is None else [box.reshape(-1, 2)])
        to_px = _data_to_pixels(np.concatenate(extent), x0, y0, x1, y1,
                                self.equal or box is not None)
        if box is not None:     # the 3D axes' box, light
            canvas.segments(to_px(box.reshape(-1, 2)).reshape(-1, 2, 2), 1.0,
                            (0.85, 0.85, 0.85, 1.0))
        if len(segs):
            canvas.segments(to_px(segs.reshape(-1, 2)).reshape(-1, 2, 2),
                            self.line_width * PX_PER_PT, self.line_color)
        if len(pts):
            canvas.discs(to_px(pts), np.sqrt(self.point_size) / 2 * PX_PER_PT, self.rgba)

    def _draw_colorbar(self, canvas, x0, y0, x1, y1) -> float:
        """A vertical viridis strip with its range's ends as labels, at
        80% of the panel's height on its right; returns the panel's new
        right edge."""
        vmin, vmax = self.colorbar
        labels = [f"{vmax:.3g}", f"{vmin:.3g}"]
        label_w = max(raster.text_width(s) for s in labels)
        bar_w = max(6, int(0.06 * (x1 - x0)))
        right = int(x1) - label_w - 4
        left = right - bar_w
        h = 0.8 * (y1 - y0)
        top = int(round(y0 + 0.1 * (y1 - y0)))
        n = max(int(h), 2)
        colors = raster.viridis(np.linspace(1.0, 0.0, n))[:, :3]
        canvas.image(left, top, np.repeat(colors[:, None], bar_w, axis=1))
        canvas.frame(left, top, left + bar_w, top + n)
        canvas.text(right + 4, top, labels[0], ha="left", va="top")
        canvas.text(right + 4, top + n, labels[1], ha="left", va="bottom")
        return left - 12


def _data_to_pixels(data: np.ndarray, x0, y0, x1, y1, equal: bool):
    """The map from data (x, y) to pixels inside the box, with
    matplotlib's 5% margins; ``equal`` keeps one unit the same length on
    both axes, the box fixed and the limits widened (``adjustable="datalim"``)."""
    if len(data):
        lo, hi = data.min(0), data.max(0)
    else:
        lo, hi = np.zeros(2), np.ones(2)
    span = hi - lo
    span = np.where(span > 0, span, 1.0)
    lo, span = lo - MARGIN * span, span * (1 + 2 * MARGIN)
    w, h = x1 - x0, y1 - y0
    sx, sy = w / span[0], h / span[1]
    if equal:
        sx = sy = min(sx, sy)
    cx, cy = lo + span / 2

    def to_px(p: np.ndarray) -> np.ndarray:
        p = np.asarray(p, np.float64).reshape(-1, 2)
        return np.stack([(x0 + x1) / 2 + (p[:, 0] - cx) * sx,
                         (y0 + y1) / 2 - (p[:, 1] - cy) * sy], axis=1)

    return to_px


def _project(segs: np.ndarray, pts: np.ndarray):
    """3D data -> 2D by the default view (elev 30, azim -60), orthographic,
    each axis scaled to the box (4, 4, 3) as matplotlib's 3D axes scale
    it; also the box's twelve edges, projected."""
    allp = np.concatenate([segs.reshape(-1, 3), pts]) if len(segs) + len(pts) else np.zeros((1, 3))
    lo, hi = allp.min(0), allp.max(0)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    aspect = np.array([4.0, 4.0, 3.0]) / 4.0
    el, az = np.radians(ELEV), np.radians(AZIM)
    right = np.array([-np.sin(az), np.cos(az), 0.0])
    up = np.array([-np.sin(el) * np.cos(az), -np.sin(el) * np.sin(az), np.cos(el)])

    def proj(p):
        q = ((np.asarray(p, np.float64).reshape(-1, 3) - lo) / span - 0.5) * aspect
        return np.stack([q @ right, q @ up], axis=1)

    corners = np.array([[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)], np.float64)
    edges = [(a, b) for a in range(8) for b in range(a + 1, 8)
             if np.abs(corners[a] - corners[b]).sum() == 1]
    box = np.stack([corners[[a for a, _ in edges]], corners[[b for _, b in edges]]], axis=1)
    box = lo + box * span
    return (proj(segs).reshape(-1, 2, 2), proj(pts),
            proj(box).reshape(-1, 2, 2))


class Figure:
    """A grid of ``Panel`` at ``figsize`` inches and ``DPI`` pixels per
    inch (``int(inches · DPI)`` pixels a side, as matplotlib's Agg canvas
    sizes it), an optional suptitle, and ``pixels`` once rendered."""

    def __init__(self, figsize: Tuple[float, float], nrows: int = 1, ncols: int = 1,
                 projection: Optional[str] = None):
        self.figsize = figsize
        self.width, self.height = int(figsize[0] * DPI), int(figsize[1] * DPI)
        self.panels: List[List[Panel]] = [[Panel(projection) for _ in range(ncols)]
                                          for _ in range(nrows)]
        self.suptitle = ""
        self.pixels: Optional[np.ndarray] = None

    @property
    def axes(self) -> List[Panel]:
        """The panels, row by row."""
        return [p for row in self.panels for p in row]

    def render(self) -> np.ndarray:
        canvas = raster.Canvas(self.width, self.height)
        top = 0.0
        if self.suptitle:
            canvas.text(self.width / 2, 6, self.suptitle, va="top")
            top = raster.LINE_HEIGHT + 10
        rows, cols = len(self.panels), len(self.panels[0])
        cw, ch = self.width / cols, (self.height - top) / rows
        for r, row in enumerate(self.panels):
            for c, panel in enumerate(row):
                panel.draw(canvas, c * cw, top + r * ch, (c + 1) * cw, top + (r + 1) * ch)
        self.pixels = canvas.rgb
        return self.pixels

    def savefig(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        raster.write_png(path, self.pixels if self.pixels is not None else self.render())


def _finish(fig: Figure, save_path: Optional[str]) -> Figure:
    fig.render()
    if save_path:
        fig.savefig(save_path)
    return fig


def _nonsingular(vmin: float, vmax: float, expander: float = 0.1) -> Tuple[float, float]:
    """A colourbar's range where the values are constant, widened as
    matplotlib's ``transforms.nonsingular`` widens it."""
    if vmin != vmax:
        return vmin, vmax
    if vmin == 0:
        return -expander, expander
    return vmin - expander * abs(vmin), vmax + expander * abs(vmax)


def plot_spatial_graph(ax: Panel, adj: np.ndarray, coords: np.ndarray,
                       features: Optional[np.ndarray] = None, node_size: float = 30.0):
    """Draw one spatial network into ``ax``: nodes at their coordinates
    (first two dims), edges as line segments (directed edges too, once),
    node colour = the first feature channel."""
    adj = np.asarray(adj)
    xy = np.asarray(coords)[:, :2].astype(np.float64)
    a = adj > 0.5
    i, j = np.nonzero(np.triu(a | a.T, 1))
    ax.plot(np.stack([xy[i], xy[j]], axis=1), color=GRAY, linewidth=0.8)
    c = None
    if features is not None:
        c = np.asarray(features).reshape(len(xy), -1)[:, 0]
    ax.scatter(xy, raster.map_colors(c, len(xy)), node_size)
    ax.equal = True


def visualize_reconstruct(
    n: int,
    adj: np.ndarray,
    feat: np.ndarray,
    coords: np.ndarray,
    gen_adj: np.ndarray,
    gen_feat: np.ndarray,
    gen_coords: np.ndarray,
    save_path: Optional[str] = None,
):
    """n original/reconstruction pairs side by side, originals on top."""
    n = min(n, len(adj), len(gen_adj))
    fig = Figure((2.2 * n, 4.6), 2, n)
    for k in range(n):
        plot_spatial_graph(fig.panels[0][k], adj[k], coords[k], feat[k])
        plot_spatial_graph(fig.panels[1][k], gen_adj[k], gen_coords[k], gen_feat[k])
        fig.panels[0][k].title = f"orig {k}"
        fig.panels[1][k].title = f"recon {k}"
    return _finish(fig, save_path)


def visualize_traverse(
    gen_adj: np.ndarray,
    gen_feat: np.ndarray,
    gen_coords: np.ndarray,
    rows: int,
    visualize_length: int,
    dataset: str = "",
    save_path: Optional[str] = None,
):
    """Latent-traversal grid: one row per traversed group,
    ``visualize_length`` steps per row; cells past the decoded graphs are
    left blank with their axis off."""
    total = len(gen_adj)
    rows = max(rows, total // max(visualize_length, 1))
    fig = Figure((2.0 * visualize_length, 2.0 * rows), rows, visualize_length)
    for r in range(rows):
        for c in range(visualize_length):
            idx = r * visualize_length + c
            if idx < total:
                plot_spatial_graph(fig.panels[r][c], gen_adj[idx], gen_coords[idx],
                                   gen_feat[idx])
            else:
                fig.panels[r][c].axis_off = True
    fig.suptitle = f"latent traversal — {dataset}"
    return _finish(fig, save_path)


def find_latent(z: np.ndarray, target: np.ndarray) -> int:
    """Index of the latent row closest to ``target`` in L2."""
    z = np.asarray(z).reshape(len(z), -1)
    d = np.linalg.norm(z - np.asarray(target).reshape(1, -1), axis=1)
    return int(np.argmin(d))


def pca2(z: np.ndarray) -> np.ndarray:
    """[n, 2] rank-2 PCA coordinates of the codes: the centred codes on the
    first two right singular vectors, a zero PC2 padded for 1-d codes or a
    single sample."""
    z = np.asarray(z, dtype=np.float64).reshape(len(z), -1)
    zc = z - z.mean(0)
    _, _, vt = np.linalg.svd(zc, full_matrices=False)
    xy = zc @ vt[:2].T
    if xy.shape[1] < 2:
        xy = np.concatenate([xy, np.zeros((len(xy), 2 - xy.shape[1]))], axis=1)
    return xy


def visualize_latent_embedding(
    z: np.ndarray,
    factors: Optional[np.ndarray] = None,
    save_path: Optional[str] = None,
    labels: Optional[Sequence[str]] = None,
):
    """2D PCA embedding of the latent codes, one panel per ground-truth
    factor (points coloured by that factor's value, with a colourbar), or
    a single uncoloured panel without factors."""
    xy = pca2(z)
    f = None
    if factors is not None:
        f = np.asarray(factors, dtype=np.float64)
        if f.ndim == 1:
            f = f[:, None]
        f = f[: len(xy)]
    k = 1 if f is None else f.shape[1]
    fig = Figure((3.2 * k, 3.0), 1, k)
    for j in range(k):
        ax = fig.panels[0][j]
        if f is None:
            ax.scatter(xy, raster.map_colors(None, len(xy)), 14)
        else:
            vmin, vmax = _nonsingular(float(f[:, j].min()), float(f[:, j].max()))
            ax.scatter(xy, raster.viridis((f[:, j] - vmin) / (vmax - vmin)), 14)
            ax.colorbar = (vmin, vmax)
        name = labels[j] if labels and j < len(labels) else f"factor {j}"
        ax.title = name if f is not None else "latents"
        ax.xlabel, ax.ylabel = "PC1", "PC2"
    return _finish(fig, save_path)


def visualize_mesh(coords: np.ndarray, adj: np.ndarray, save_path: Optional[str] = None):
    """3D wireframe of a mesh graph: the edges of triu(adj > 0.5) and the
    nodes, in matplotlib's default 3D view."""
    fig = Figure((5, 5), projection="3d")
    ax = fig.panels[0][0]
    coords = np.asarray(coords).astype(np.float64)
    i, j = np.nonzero(np.triu(np.asarray(adj) > 0.5, 1))
    ax.plot(np.stack([coords[i, :3], coords[j, :3]], axis=1), color=GRAY, linewidth=0.6)
    ax.scatter(coords[:, :3], raster.map_colors(None, len(coords)), 12)
    return _finish(fig, save_path)
