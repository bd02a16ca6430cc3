"""The port's figures (``snd_vae_tpu_torch/visualize.py``, drawn by the numpy
raster ``utils/raster.py``) against the JAX package's matplotlib figures
(``snd_vae_tpu/visualize.py``) for the same inputs: the same scene (line
segments and node positions exactly in float64, node RGBA within 1e-6,
titles, grid shape, axis-off cells, colourbar ranges, the mesh's 3D data)
and a PNG of the pixel size matplotlib's ``savefig(dpi=150)`` writes.
Pixels are not compared: fonts and anti-aliasing differ."""

import struct
import zlib

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")
import matplotlib.image  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402

from snd_vae_tpu import visualize as jv  # noqa: E402
from snd_vae_tpu_torch import visualize as tv  # noqa: E402
from snd_vae_tpu_torch.utils import raster  # noqa: E402


def _graphs(rng, G, N, p=0.2, F=3, dtype=np.float32, directed=False):
    adj = (rng.random((G, N, N)) < p).astype(dtype)
    if not directed:
        adj = np.triu(adj, 1)
        adj = adj + np.swapaxes(adj, 1, 2)
    return (adj, rng.uniform(0, 120, (G, N, F)).astype(dtype),
            rng.uniform(0, 600, (G, N, 2)).astype(dtype))


def _mpl_scene(ax):
    """The segments, points and their RGBA matplotlib's axes hold."""
    lines = [np.column_stack(ln.get_data_3d()) if hasattr(ln, "get_data_3d")
             else ln.get_xydata() for ln in ax.lines]
    coll = ax.collections[0]
    if hasattr(coll, "_offsets3d"):
        points = np.column_stack([np.asarray(v, np.float64) for v in coll._offsets3d])
        # the colour before the depth shading a draw applies
        rgba = np.broadcast_to(matplotlib.colors.to_rgba_array(coll._original_facecolor),
                               (len(points), 4))
    else:
        points = np.asarray(coll.get_offsets())
        arr = coll.get_array()
        rgba = (coll.to_rgba(arr) if arr is not None
                else np.broadcast_to(coll.get_facecolors(), (len(points), 4)))
    return np.asarray(lines, np.float64).reshape((-1, 2, points.shape[1])), points, rgba


def _assert_same_panel(panel, ax):
    segs, points, rgba = _mpl_scene(ax)
    assert panel.segments.dtype == panel.points.dtype == np.float64
    np.testing.assert_array_equal(panel.segments, segs)
    np.testing.assert_array_equal(panel.points, points)
    np.testing.assert_allclose(panel.rgba, rgba, rtol=0, atol=1e-6)
    assert panel.title == ax.get_title()
    # a 3D axes keeps its 2D axis off and draws its own (``_axis3don``)
    assert panel.axis_off == (not getattr(ax, "_axis3don", ax.axison))


def _png_size(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    return struct.unpack(">II", data[16:24])


def _assert_png(path, fig, want_path):
    """The port's PNG: matplotlib's pixel size, decodes (by Pillow, through
    matplotlib) to the figure's pixels, and holds more than the
    background."""
    assert _png_size(path) == _png_size(want_path) == (fig.width, fig.height)
    img = matplotlib.image.imread(path)
    assert img.shape == (fig.height, fig.width, 3)
    np.testing.assert_array_equal(np.round(img * 255).astype(np.uint8), fig.pixels)
    assert (fig.pixels != 255).any(axis=-1).mean() > 0.01


@pytest.mark.parametrize("case", ["float32", "no_features", "constant_features", "directed"])
def test_plot_spatial_graph_scene_matches_jax(case, recwarn):
    rng = np.random.default_rng(1)
    adj, feat, coords = _graphs(rng, 1, 12, directed=case == "directed")
    adj, feat, coords = adj[0], feat[0], coords[0]
    if case == "no_features":
        feat = None
    elif case == "constant_features":
        feat = np.full_like(feat, 7.0)
    fig, ax = plt.subplots()
    jv.plot_spatial_graph(ax, adj, coords, feat)
    panel = tv.Panel()
    tv.plot_spatial_graph(panel, adj, coords, feat)
    _assert_same_panel(panel, ax)
    assert len(panel.segments) == np.count_nonzero(np.triu((adj > 0.5) | (adj > 0.5).T, 1))
    if case == "constant_features":   # a constant channel maps to viridis' first entry
        np.testing.assert_array_equal(panel.rgba[:, :3], np.tile(raster.VIRIDIS[0], (12, 1)))
    plt.close(fig)


@pytest.mark.parametrize("n,G", [(5, 6), (7, 3)])
def test_visualize_reconstruct_matches_jax(tmp_path, n, G):
    rng = np.random.default_rng(n)
    adj, feat, coords = _graphs(rng, G, 10)
    gadj, gfeat, gcoords = _graphs(rng, G, 10, p=0.4)
    args = (n, adj, feat, coords, gadj, gfeat, gcoords)
    want = jv.visualize_reconstruct(*args, save_path=str(tmp_path / "jax.png"))
    got = tv.visualize_reconstruct(*args, save_path=str(tmp_path / "port" / "rec.png"))
    k = min(n, G)
    assert [len(row) for row in got.panels] == [k, k] and len(want.axes) == 2 * k
    for p, ax in zip(got.axes, want.axes):
        _assert_same_panel(p, ax)
    assert [p.title for p in got.axes] == [f"orig {i}" for i in range(k)] + [
        f"recon {i}" for i in range(k)]
    _assert_png(tmp_path / "port" / "rec.png", got, tmp_path / "jax.png")
    if k == 5:
        assert (got.width, got.height) == (1650, 690)


@pytest.mark.parametrize("rows,V,total", [(3, 5, 13), (1, 5, 10), (3, 4, 12)])
def test_visualize_traverse_matches_jax(tmp_path, rows, V, total):
    adj, feat, coords = _graphs(np.random.default_rng(total), total, 8)
    want = jv.visualize_traverse(adj, feat, coords, rows, V, "synthetic2",
                                 save_path=str(tmp_path / "jax.png"))
    got = tv.visualize_traverse(adj, feat, coords, rows, V, "synthetic2",
                                save_path=str(tmp_path / "t.png"))
    n_rows = max(rows, total // V)
    assert [len(r) for r in got.panels] == [V] * n_rows and len(want.axes) == n_rows * V
    for p, ax in zip(got.axes, want.axes):
        if ax.axison:
            _assert_same_panel(p, ax)
        else:
            assert p.axis_off and not len(p.points) and not len(p.segments)
    assert sum(p.axis_off for p in got.axes) == n_rows * V - total
    assert got.suptitle == want._suptitle.get_text() == "latent traversal — synthetic2"
    _assert_png(tmp_path / "t.png", got, tmp_path / "jax.png")
    if (rows, V) == (3, 5):
        assert (got.width, got.height) == (1500, 900)


@pytest.mark.parametrize("case", ["three_factors", "no_factors", "one_d_factor", "rank_one",
                                  "constant_factor"])
def test_visualize_latent_embedding_matches_jax(tmp_path, case):
    rng = np.random.default_rng(4)
    z, factors, labels = rng.standard_normal((40, 6)), rng.random((40, 3)), ["size"]
    if case == "no_factors":
        factors = None
    elif case == "one_d_factor":
        factors = factors[:, 0]
    elif case == "rank_one":
        z = z[:, :1]
    elif case == "constant_factor":
        factors[:, 1] = 2.5
    want = jv.visualize_latent_embedding(z, factors, save_path=str(tmp_path / "jax.png"),
                                         labels=labels)
    got = tv.visualize_latent_embedding(z, factors, save_path=str(tmp_path / "l.png"),
                                        labels=labels)
    k = 1 if factors is None else np.atleast_2d(factors.T).shape[0]
    assert [len(r) for r in got.panels] == [k]
    for p, ax in zip(got.axes, want.axes[:k]):     # the colourbars' axes follow
        _assert_same_panel(p, ax)
        assert (p.xlabel, p.ylabel) == (ax.get_xlabel(), ax.get_ylabel()) == ("PC1", "PC2")
        cb = ax.collections[0].colorbar
        assert (p.colorbar is None) == (cb is None)
        if cb is not None:
            assert p.colorbar == (cb.norm.vmin, cb.norm.vmax)
    assert [p.title for p in got.axes] == (["latents"] if factors is None else
                                           ["size"] + [f"factor {j}" for j in range(1, k)])
    _assert_png(tmp_path / "l.png", got, tmp_path / "jax.png")
    if case == "three_factors":
        assert (got.width, got.height) == (1440, 450)


def test_pca_coordinates_match_jax():
    z = np.random.default_rng(7).standard_normal((30, 9)) * np.arange(1, 10)
    want = jv.visualize_latent_embedding(z, None).axes[0].collections[0].get_offsets()
    np.testing.assert_allclose(tv.pca2(z), want, rtol=0, atol=1e-10)
    zc = z - z.mean(0)
    cov_axes = np.linalg.eigh(zc.T @ zc)[1][:, ::-1][:, :2]
    np.testing.assert_allclose(np.abs(tv.pca2(z)), np.abs(zc @ cov_axes), atol=1e-10)


def test_visualize_mesh_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    coords = rng.standard_normal((20, 3))
    adj = (rng.random((20, 20)) < 0.2).astype(np.float64)
    want = jv.visualize_mesh(coords, adj, save_path=str(tmp_path / "jax.png"))
    got = tv.visualize_mesh(coords, adj, save_path=str(tmp_path / "m.png"))
    assert [len(r) for r in got.panels] == [1] and got.axes[0].projection == "3d"
    _assert_same_panel(got.axes[0], want.axes[0])
    assert got.axes[0].segments.shape[1:] == (2, 3)
    _assert_png(tmp_path / "m.png", got, tmp_path / "jax.png")
    assert (got.width, got.height) == (750, 750)


def test_find_latent_matches_jax():
    rng = np.random.default_rng(6)
    z = rng.standard_normal((25, 2, 3))
    for target in (z[7], rng.standard_normal(6), z[0] + 1e-3):
        assert tv.find_latent(z, target) == jv.find_latent(z, target)


def test_png_writer_roundtrip():
    """An image through ``raster.png_bytes``: valid chunks (CRC32), and
    zlib decodes the rows back, each unfiltered."""
    pixels = np.random.default_rng(0).integers(0, 256, (7, 5, 3), dtype=np.uint8)
    data = raster.png_bytes(pixels)
    pos, chunks = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(kind + body)
        chunks.append((kind, body))
        pos += 12 + n
    assert [k for k, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    rows = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8).reshape(7, 16)
    assert not rows[:, 0].any()
    np.testing.assert_array_equal(rows[:, 1:].reshape(7, 5, 3), pixels)


@pytest.mark.parametrize("antialias", [True, False])
def test_raster_lines_and_discs(antialias):
    """A segment and a disc on a white canvas: anti-aliased, their edges
    blend into the background; without, every pixel is either colour."""
    c = raster.Canvas(40, 30)
    c.segments(np.array([[[3.2, 4.7], [35.9, 24.1]]]), 2.0, (0.0, 0.0, 1.0), antialias)
    c.discs(np.array([[10.3, 20.6]]), 4.5, np.array([[1.0, 0.0, 0.0, 1.0]]), antialias)
    colours = {tuple(p) for p in c.rgb.reshape(-1, 3)}
    assert {(255, 255, 255), (0, 0, 255), (255, 0, 0)} <= colours
    assert (len(colours) > 3) == antialias
    assert tuple(c.rgb[20, 10]) == (255, 0, 0) and tuple(c.rgb[0, 39]) == (255, 255, 255)


def test_viridis_and_normalize_match_matplotlib():
    cmap = matplotlib.colormaps["viridis"]
    x = np.concatenate([np.linspace(0, 1, 1001), [-0.5, 1.5, np.nan, 1 - 1e-12, 1 / 256]])
    np.testing.assert_array_equal(raster.viridis(x), cmap(x))
    c = np.random.default_rng(0).uniform(-3, 9, 50)
    norm = matplotlib.colors.Normalize()
    np.testing.assert_array_equal(raster.normalize(c), norm(c))
    assert raster.text_mask("latent traversal — x").any()
