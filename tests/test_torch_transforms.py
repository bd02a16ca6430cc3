"""The port's graph transforms (``data/transforms.py``) and
``save_synthetic_npy`` against the JAX package's: the torch transforms in
float64 to 1e-12, the numpy-seeded ones (``split_edges``,
``edge_dropout``) and ``pad_graph`` bit-equal, the written files byte-equal;
``dropout_edges`` (a torch generator where JAX takes a key) by its
properties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import one_thread  # noqa: F401  (fixture)

import snd_vae_tpu.data as jdata
import snd_vae_tpu_torch.data as tdata

pytestmark = pytest.mark.usefixtures("one_thread")


def _adj(rng, shape, density=0.3):
    a = np.triu((rng.random(shape) < density).astype(np.float64), 1)
    return a + np.swapaxes(a, -1, -2)


CASES = {
    "gcn_normalize": lambda rng: ((_adj(rng, (3, 7, 7)),), {}),
    "gcn_normalize_no_loops": lambda rng: ((_adj(rng, (7, 7)),), {"add_self_loops": False}),
    "pairwise_distances": lambda rng: ((rng.standard_normal((2, 6, 3)),), {}),
    "zscore": lambda rng: ((rng.standard_normal((4, 5)), rng.standard_normal(5),
                            1.0 + rng.random(5)), {}),
    "zero_diagonal": lambda rng: ((rng.standard_normal((2, 5, 5)),), {}),
    "motif_adj_3d": lambda rng: ((_adj(rng, (2, 6, 6)),), {}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_transform_matches_jax_f64(name):
    args, kw = CASES[name](np.random.default_rng(list(CASES).index(name)))
    fn = name.replace("_no_loops", "")
    with jax.enable_x64():
        want = getattr(jdata, fn)(*map(jnp.asarray, args), **kw)
    got = getattr(tdata, fn)(*map(torch.from_numpy, args), **kw)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_edge_logit_mask_matches_jax():
    with jax.enable_x64():
        want = jdata.edge_logit_mask(5, (2, 3), dtype=jnp.float64)
    got = tdata.edge_logit_mask(5, (2, 3), dtype=torch.float64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_numpy_seeded_transforms_are_bit_equal(seed):
    adj = _adj(np.random.default_rng(10 + seed), (12, 12))
    want = jdata.split_edges(adj, np.random.default_rng(seed), 0.2, 0.1)
    got = tdata.split_edges(adj, np.random.default_rng(seed), 0.2, 0.1)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(tdata.edge_dropout(adj, 0.3, np.random.default_rng(seed)),
                                  jdata.edge_dropout(adj, 0.3, np.random.default_rng(seed)))


def test_pad_graph_is_bit_equal():
    rng = np.random.default_rng(3)
    args = (_adj(rng, (5, 5)), rng.standard_normal((5, 2)), rng.standard_normal((5, 2)), 8)
    for got, want in zip(tdata.pad_graph(*args), jdata.pad_graph(*args)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tdata.pad_graph(*args[:3], 4)


def test_dropout_edges_keeps_a_symmetric_scaled_subset():
    """Symmetric for a symmetric A, kept entries A / keep, the rest 0, the
    same draw from the same generator seed, about keep of the edges."""
    adj = torch.from_numpy(_adj(np.random.default_rng(4), (4, 40, 40), 0.5))
    draw = lambda seed: tdata.dropout_edges(adj, 0.7, torch.Generator().manual_seed(seed))
    out = draw(0)
    assert torch.equal(out, out.transpose(-1, -2)) and torch.equal(out, draw(0))
    kept = out != 0
    torch.testing.assert_close(out[kept], adj[kept] / 0.7, rtol=0, atol=0)
    assert 0.6 < kept.sum().item() / (adj != 0).sum().item() < 0.8
    assert not torch.equal(out, draw(1))


def test_save_synthetic_npy_files_are_byte_equal(tmp_path):
    data = tdata.generate_synthetic(4, 10, seed=2)
    tdata.save_synthetic_npy(data, str(tmp_path / "port"), prefix="2D")
    jdata.save_synthetic_npy(jdata.generate_synthetic(4, 10, seed=2), str(tmp_path / "jax"),
                             prefix="2D")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and len(names) == 5
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n
