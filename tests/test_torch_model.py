"""The port's DisentangledSNDVAE against the JAX package's, with the flax
parameters carried across by ``params.state_dict_from_flax``: the full
synthetic2 model (B=2 graphs x S=10 trees) and a small-width config.

float64 comparisons run under ``exact_f64`` (``torch_parity.py``): JAX's
Dense and GraphConv ask for ``preferred_element_type=float32`` even on
float64 operands, and the fixture lifts that to float64 for float64
operands so that the comparison is free of f32 rounding (the JAX package
itself is unchanged).  The f32 comparison runs JAX as it is."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict
from torch_parity import configs as _configs
from torch_parity import exact_f64, one_thread  # noqa: F401  (fixtures)
from torch_parity import random_params as _random_params

from snd_vae_tpu.data.graphbatch import from_numpy as jax_batch
from snd_vae_tpu.models import DisentangledSNDVAE as JaxModel
from snd_vae_tpu.models import build_model as jax_build_model
from snd_vae_tpu.models.outputs import Latents as JaxLatents
from snd_vae_tpu_torch import config as tcfg
from snd_vae_tpu_torch.data.graphbatch import from_numpy as torch_batch
from snd_vae_tpu_torch.data.loaders import load_dataset
from snd_vae_tpu_torch.models import build_model
from snd_vae_tpu_torch.models.outputs import Latents
from snd_vae_tpu_torch.params import state_dict_from_flax

pytestmark = pytest.mark.usefixtures("one_thread")


def _setup(case, np_dtype):
    """Data (the port's loader), flax params for the JAX model (names and
    shapes from its own init, traced only), and the port model carrying the
    same params, all in ``np_dtype``."""
    jc, tc = _configs(case)
    data = load_dataset(tc, "test", num_graphs=2, device="cpu")
    arrays = {k: v.numpy().astype(np_dtype) for k, v in vars(data).items()
              if v is not None}
    jm = jax_build_model(jc)
    with jax.enable_x64(False):   # the f32 init the JAX package runs
        shapes = jax.eval_shape(lambda k: jm.init(k, jax_batch(**arrays), key=k),
                                jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(1)
    flat = {k: v.astype(np_dtype) for k, v in _random_params(shapes, rng).items()}
    tm = build_model(tc, device="cpu").to(torch.from_numpy(np.zeros(0, np_dtype)).dtype)
    result = tm.load_state_dict(state_dict_from_flax(flat))
    assert not result.missing_keys and not result.unexpected_keys
    p = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    enc = jc.encoder
    lat = {"z_sg": rng.standard_normal((2, jc.sampling_num, enc.sg_latent_size)),
           "z_s": rng.standard_normal((2, enc.s_latent_size)),
           "z_g": rng.standard_normal((2, enc.g_latent_size))}
    lat = {k: v.astype(np_dtype) for k, v in lat.items()}
    return jc, jm, p, tm, arrays, lat


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _check(jm, p, tm, arrays, lat, rtol, atol, np_dtype):
    jb = jax_batch(**arrays, dtype=np_dtype)
    tb = torch_batch(**arrays, dtype=tm.dtype)
    apply = lambda method, **kw: jax.jit(
        lambda p, *a: jm.apply({"params": p}, *a, method=method, **kw))

    js = apply(JaxModel.encode)(p, jb)
    ts = tm.encode(tb)
    for f in ("mean_sg", "logstd_sg", "mean_s", "logstd_s", "mean_g", "logstd_g"):
        _close(getattr(ts, f), getattr(js, f), rtol, atol)

    jd = apply(JaxModel.decode)(p, JaxLatents(**{k: jnp.asarray(v) for k, v in lat.items()}))
    td = tm.decode(Latents(**{k: torch.from_numpy(v) for k, v in lat.items()}))
    for f in ("adj_prob", "coords", "node_feat"):
        _close(getattr(td, f), getattr(jd, f), rtol, atol)
    # adj is an argmax: compare it wherever the two logits are apart
    logits = np.asarray(jd.adj_prob)
    decided = np.abs(logits[..., 1] - logits[..., 0]) > 1e-6
    np.testing.assert_array_equal(td.adj.numpy()[decided], np.asarray(jd.adj)[decided])

    # reparameterize with JAX's own noise (its split order is s, sg, g)
    key = jax.random.PRNGKey(3)
    jz = apply(JaxModel.reparameterize)(p, js, key)
    k_s, k_sg, k_g = jax.random.split(key, 3)
    noise = lambda k, t: torch.from_numpy(np.array(jax.random.normal(k, t.shape, t.dtype)))
    eps = Latents(z_sg=noise(k_sg, js.mean_sg), z_s=noise(k_s, js.mean_s),
                  z_g=noise(k_g, js.mean_g))
    tz = tm.reparameterize(ts, eps=eps)
    for f in ("z_sg", "z_s", "z_g"):
        _close(getattr(tz, f), getattr(jz, f), rtol, atol)

    # the served path: encode, posterior means, decode in one call
    jo = apply(None, deterministic_z=True)(p, jb)
    to = tm(tb, deterministic_z=True)
    for f in ("adj_prob", "coords", "node_feat"):
        _close(getattr(to.decoded, f), getattr(jo.decoded, f), rtol, atol)


@pytest.mark.parametrize("case", ["synthetic2", "small"])
def test_model_matches_jax_f64(case, exact_f64):
    """float64 at rtol 1e-8."""
    _, jm, p, tm, arrays, lat = _setup(case, np.float64)
    with torch.no_grad():
        _check(jm, p, tm, arrays, lat, 1e-8, 1e-10, np.float64)


@pytest.mark.parametrize("case", ["synthetic2", "small"])
def test_model_matches_jax_f32(case):
    """f32 at rtol 1e-4 / atol 1e-5: sums taken in another order."""
    _, jm, p, tm, arrays, lat = _setup(case, np.float32)
    with torch.no_grad():
        _check(jm, p, tm, arrays, lat, 1e-4, 1e-5, np.float32)


def test_generate_and_prior_shapes():
    _, tc = _configs("synthetic2")
    tm = build_model(tc, device="cpu")
    with torch.no_grad():
        d = tm.generate(torch.Generator().manual_seed(0), 3)
        z = tm.reparameterize(tm.encode(load_dataset(tc, "test", 2, device="cpu")),
                              generator=torch.Generator().manual_seed(0))
    assert d.adj.shape == (3, 25, 25) and d.adj_prob.shape == (3, 25, 25, 2)
    assert d.coords.shape == (3, 25, 2) and d.node_feat.shape == (3, 25, 1)
    assert z.z_sg.shape == (2, 10, 100)
    for t in (d.adj_prob, d.coords, d.node_feat, z.z_sg, z.z_s, z.z_g):
        assert torch.isfinite(t).all()
    # the same seed gives the same weights, on any device
    tm2 = build_model(tc, device="cpu")
    for (k, a), (_, b) in zip(tm.state_dict().items(), tm2.state_dict().items()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("model_type", ["disentangled_C", "NED-VAE-IP", "beta-TCVAE"])
def test_disentangled_family_shares_one_model(model_type):
    """The family differs only in its loss: same modules, same weights."""
    ref = build_model(tcfg.synthetic2_preset(), device="cpu").state_dict()
    got = build_model(tcfg.synthetic2_preset(model_type=model_type), device="cpu").state_dict()
    assert list(got) == list(ref)
    assert all(torch.equal(got[k], ref[k]) for k in ref)


@pytest.mark.parametrize("over", [dict(remat=True), dict(model_type="base", remat=True)])
def test_remat_configs_build_and_match(over):
    """remat, which raised before it was ported, builds both families at
    full synthetic2 width with the seed's weights, and reconstructs as the
    model without it does (remat changes only the backward;
    tests/test_torch_remat.py holds its gradients)."""
    cfg = tcfg.synthetic2_preset(**over)
    plain = build_model(cfg.with_(remat=False), device="cpu")
    model = build_model(cfg, device="cpu")
    assert model.cfg.remat and list(model.state_dict()) == list(plain.state_dict())
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 plain.state_dict().values()))
    batch = load_dataset(cfg, "test", 2, device="cpu")
    with torch.no_grad():
        got, want = model(batch, deterministic_z=True), plain(batch, deterministic_z=True)
    assert torch.equal(got.decoded.adj_prob, want.decoded.adj_prob)
    assert torch.equal(got.decoded.coords, want.decoded.coords)


@pytest.mark.parametrize("run_type", ["sample", "test_reconstruct"])
def test_cli_serves_on_cpu(tmp_path, run_type):
    from snd_vae_tpu_torch import cli

    out = cli.main(["--type", run_type, "--device", "cpu", "--num-generate", "3",
                    "--workdir", str(tmp_path)])
    n = 3 if run_type == "sample" else 200
    assert out["adj_shape"] == [n, 25, 25] and out["device"] == "cpu"
    adj = np.load(tmp_path / out["dir"] / "adj.npy")
    coords = np.load(tmp_path / out["dir"] / "coords.npy")
    assert adj.shape == (n, 25, 25) and coords.shape == (n, 25, 2)
    assert np.isin(adj, (0.0, 1.0)).all() and np.isfinite(coords).all()
