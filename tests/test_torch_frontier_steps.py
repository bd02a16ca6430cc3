"""The frontier configuration's first three Adam steps, port against JAX
(``benchmarks/frontier_2048.py:43-47``: the synthetic2 preset at
``num_nodes`` N, ``sampling_num=2`` and a TrainConfig of its defaults but
batches of 2 graphs: "adam" at lr 1e-3, as the card's frontier phase
trains it), on the CPU.

Each case takes three train steps on the train split's first 4 graphs in
the order ``Trainer.run`` takes them (graphs 0-1 and 2-3 at global_iter 0,
then 0-1 at global_iter 1; parity mode neither reshuffles nor resamples),
with the same ε in both packages (the lockstep noise stream of
``tests/test_torch_train.py``).  JAX's side is its lockstep train step
(``snd_vae_tpu.compat.lockstep._make_jax_lockstep_step`` with
``snd_vae_tpu.train.make_optimizer``), compiled without XLA's ``algsimp``
as the other parity tests compile it.

  * N = 128 (tier 1): ``init_like`` weights; each step's loss and, after
    step 3, every parameter, float64 (``exact_f64``) at rtol 1e-8 and f32
    at the tolerances ``test_three_steps_match_jax_f32`` states.
  * N = 512 and 1024 (``slow``): the port's seed weights (``build_model``,
    as the card's frontier phase trains from them), carried into JAX's
    flax tree by ``torch_parity.flax_params_from_state_dict``, f32, E2E on
    its Toeplitz lowering in both (``toeplitz_e2e``).  These answer
    whether the blow-up the card reads at N = 1024 after the first Adam
    step (loss 19.12 -> 5.1e15 -> 1.8e6 -> 1.2e13) is the model's: JAX's
    loss blows up the same way (the losses and seconds read are in
    ``test_three_steps_at_large_n``).  Run them alone, in the background
    (~8 minutes together)::

        python -m pytest tests/test_torch_frontier_steps.py -m slow -s
"""

import functools
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from test_torch_frontier import _frontier
from torch_parity import exact_f64, one_thread  # noqa: F401  (fixtures)
from torch_parity import flax_params_from_state_dict, init_like, setup_models

from snd_vae_tpu import config as jcfg
from snd_vae_tpu import train as jtrain
from snd_vae_tpu.compat.lockstep import _make_jax_lockstep_step, make_noise_stream
from snd_vae_tpu.data.graphbatch import from_numpy as jax_batch
from snd_vae_tpu.models import build_model as jax_build_model
from snd_vae_tpu_torch import config as tcfg
from snd_vae_tpu_torch import train as ttrain
from snd_vae_tpu_torch.data.graphbatch import from_numpy as torch_batch
from snd_vae_tpu_torch.data.loaders import load_dataset
from snd_vae_tpu_torch.models import Latents, build_model
from snd_vae_tpu_torch.params import state_dict_from_flax, torch_layout, torch_name

STEPS = 3
# (first graph, global_iter) of each step: Trainer.run over 4 graphs in
# batches of 2, two epochs
PLAN = [(0, 0.0), (2, 0.0), (0, 1.0)]


def _noise(jc):
    B, S, enc = jc.train.batch_size, jc.sampling_num, jc.encoder
    return make_noise_stream(7, STEPS, {"s": (B, enc.s_latent_size),
                                        "sg": (B * S, enc.sg_latent_size),
                                        "g": (B, enc.g_latent_size)})


def _jax_steps(jc, jm, params, arrays, noise, np_dtype):
    """JAX's three steps: (the loss of each, the flat parameters after)."""
    opt = jtrain.make_optimizer(jc)
    step = _make_jax_lockstep_step(jc, jm, opt)
    state, losses, compiled = opt.init(params), [], None
    for (lo, it), eps in zip(PLAN, noise):
        jb = jax_batch(**{k: v[lo:lo + 2] for k, v in arrays.items()}, dtype=np_dtype)
        args = (params, state, jb, *[jnp.asarray(eps[k], np_dtype) for k in ("s", "sg", "g")],
                jnp.asarray(it, np_dtype))
        if compiled is None:
            compiled = step.lower(*args).compile(
                compiler_options={"xla_disable_hlo_passes": "algsimp"})
        params, state, total = compiled(*args)
        losses.append(float(total))
    return losses, {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}


def _port_steps(tc, model, arrays, noise, dtype):
    """The port's three steps: (the loss of each, the parameters after)."""
    state = ttrain.TrainState(cfg=tc, model=model.train(),
                              optimizer=ttrain.make_optimizer(tc, model.parameters()),
                              generator=torch.Generator().manual_seed(0))
    losses = []
    for (lo, it), eps in zip(PLAN, noise):
        batch = torch_batch(**{k: v[lo:lo + 2] for k, v in arrays.items()}, dtype=dtype)
        t = lambda k: torch.from_numpy(eps[k]).to(dtype)
        aux = ttrain.train_step(state, batch, torch.tensor(it, dtype=dtype),
                                eps=Latents(z_sg=t("sg"), z_s=t("s"), z_g=t("g")))
        losses.append(aux["loss"].item())
    return losses, {k: p.detach() for k, p in model.named_parameters()}


def _three_steps_128(np_dtype):
    jc, tc, jm, params, tm, arrays = setup_models(
        "synthetic2", np_dtype, "synthetic2", num_graphs=4, split="train", init=init_like,
        num_nodes=128, sampling_num=2)
    jc, tc = (c.with_(train=c.train.__class__(batch_size=2)) for c in (jc, tc))
    assert tc.train == _frontier(tcfg, 128).train and tc.train.optimizer == "adam"
    assert tc.adj_factored_engaged
    noise = _noise(jc)
    dt = torch.float64 if np_dtype == np.float64 else torch.float32
    return (_jax_steps(jc, jm, params, arrays, noise, np_dtype),
            _port_steps(tc, tm, arrays, noise, dt))


@pytest.mark.usefixtures("one_thread")
def test_three_steps_match_jax_f64(exact_f64):
    """Float64: each step's loss and every parameter after step 3 at rtol
    1e-8 (atol 1e-10 of each parameter's largest magnitude)."""
    (j_losses, j_params), (losses, params) = _three_steps_128(np.float64)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-8)
    assert len(j_params) == len(params)
    for path, want in j_params.items():
        want = torch_layout(path, want)
        np.testing.assert_allclose(params[torch_name(path)].numpy(), want, rtol=1e-8,
                                   atol=1e-10 * np.abs(want).max(), err_msg=path)


@pytest.mark.usefixtures("one_thread")
def test_three_steps_match_jax_f32():
    """F32: each step's loss at rtol 1e-4 (the largest gap read 4.0e-6 on
    one thread, 8.1e-6 on four) and the parameters after step 3: no
    element farther from JAX's than 6 learning rates (three Adam steps of
    at most ~lr each, in opposite directions) and at most 1e-4 of all
    elements farther than lr / 10.  Adam's first steps move each weight by
    ~lr whatever its gradient's size, so a weight whose gradient lies
    within the two packages' f32 rounding (the adjacency head's gradient
    summed over the N² pairs; one step's gradients already differ by up
    to 1.7e-4 of their largest magnitude, ``tests/test_torch_frontier.py``)
    may step the other way: on one thread the largest gap read 1.68e-3 (at
    d_g_lin1's bias) and 91 of 2,688,067 elements lay past lr / 10; on four
    threads 1.94e-4 and 7."""
    (j_losses, j_params), (losses, params) = _three_steps_128(np.float32)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    lr = _frontier(tcfg, 128).train.learning_rate
    assert len(j_params) == len(params)
    gaps = np.concatenate([np.abs(params[torch_name(path)].numpy() - torch_layout(path, want))
                           .ravel() for path, want in j_params.items()])
    assert gaps.max() <= 6 * lr, gaps.max()
    assert (gaps > 0.1 * lr).mean() <= 1e-4, (gaps > 0.1 * lr).sum()


@pytest.mark.usefixtures("one_thread")
def test_flax_params_from_state_dict_inverts_state_dict_from_flax():
    """The bridge back: the port's seed weights carried into JAX's flax
    tree, every leaf of the tree's shape and in memory of its own (a view
    of a parameter would follow the port's updates), come back bit for
    bit."""
    jc, tc = _frontier(jcfg, 128), _frontier(tcfg, 128)
    arrays = {k: v.numpy() for k, v in vars(load_dataset(tc, "train", num_graphs=2,
                                                         device="cpu")).items()
              if v is not None}
    shapes = _flax_shapes(jc, arrays)
    sd = build_model(tc, device="cpu").state_dict()
    flat = flax_params_from_state_dict(sd, shapes)
    assert {k: v.shape for k, v in flat.items()} == {
        k: v.shape for k, v in flatten_dict(shapes, sep="/").items()}
    params = dict(build_model(tc, device="cpu").named_parameters())
    assert not any(np.shares_memory(v, sd[torch_name(k)].numpy()) for k, v in flat.items())
    back = state_dict_from_flax(flat)
    assert back.keys() == params.keys()
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k


def _flax_shapes(jc, arrays):
    jm = jax_build_model(jc)
    small = {k: v[:2] for k, v in arrays.items()}
    with jax.enable_x64(False):
        return jax.eval_shape(lambda k: jm.init(k, jax_batch(**small), key=k),
                              jax.random.PRNGKey(0))["params"]


@pytest.fixture
def toeplitz_e2e(monkeypatch):
    """E2E's Toeplitz lowering in both packages' models up to 8 GiB of
    banded weights (the auto rule's bound is 2 GiB, past which both take
    the conv lowering): the same function, whose f32 conv lowering on an
    8-core CPU host took the port alone over 83 minutes for the three
    steps at N = 1024, where the Toeplitz lowering runs as matrix
    products.  At N = 512 both packages take the Toeplitz lowering anyway
    (1 GiB)."""
    import snd_vae_tpu.models.disentangled as jax_disentangled
    import snd_vae_tpu_torch.models.disentangled as disentangled

    monkeypatch.setattr(jax_disentangled.ops, "E2E", functools.partial(
        jax_disentangled.ops.E2E, matmul_max_bytes=8 << 30))
    monkeypatch.setattr(disentangled, "E2E", functools.partial(
        disentangled.E2E, matmul_max_bytes=8 << 30))


@pytest.mark.slow
@pytest.mark.parametrize("n,rtol", [(512, 1e-4), (1024, 1e-3)])
def test_three_steps_at_large_n(tmp_path, toeplitz_e2e, n, rtol):
    """The port's seed weights in both packages, f32, three steps on the
    frontier's graphs at N: both packages' losses (printed as one JSON
    line with each package's seconds), each step's within ``rtol``.

    Read on an 8-core x86 CPU host (62 GiB; both packages on every core;
    the seconds of each package's three steps, JAX's with its compile):

      * N = 512: the port 0.925564, 3.163519, 0.981024 (26.6 s); JAX
        0.925564, 3.163458, 0.981026 (39.8 s): step 2 jumps 3.4x in both,
        the largest gap 2.0e-5 of the loss;
      * N = 1024: the port 19.03062, 4.483752e15, 1.985174e6 (140.2 s);
        JAX 19.03061, 4.482673e15, 1.985049e6 (210.0 s): the first Adam
        step blows the loss up in both packages alike (``chip_smoke.py``'s
        frontier phase on an H100 read 19.12 -> 5.1e15 -> 1.8e6 on its own
        ε), so the blow-up is the model's.  The gaps, 2.4e-4 and 6.3e-5 of the loss, are f32's
        rounding of the first step's gradients carried through a step that
        multiplies the loss by 2e14: rtol 1e-3 here, 1e-4 at N = 512."""
    jc = _frontier(jcfg, n, dataset_path=str(tmp_path))
    tc = _frontier(tcfg, n, dataset_path=str(tmp_path))
    data = load_dataset(tc, "train", num_graphs=4, device="cpu")
    arrays = {k: v.numpy() for k, v in vars(data).items() if v is not None}
    model = build_model(tc, device="cpu")
    assert all(m.matmul_max_bytes == 8 << 30 for m in model.e_deconvs)
    flat = flax_params_from_state_dict(model.state_dict(), _flax_shapes(jc, arrays))
    params = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    noise = _noise(jc)
    t0 = time.perf_counter()
    losses, _ = _port_steps(tc, model, arrays, noise, torch.float32)
    t1 = time.perf_counter()
    j_losses, _ = _jax_steps(jc, jax_build_model(jc), params, arrays, noise, np.float32)
    t2 = time.perf_counter()
    print(json.dumps({"n": n, "port_losses": losses, "jax_losses": j_losses,
                      "port_seconds": t1 - t0, "jax_seconds": t2 - t1}), flush=True)
    np.testing.assert_allclose(losses, j_losses, rtol=rtol)
