"""The port's parallel layer (``snd_vae_tpu_torch.parallel``) against the
JAX package's ``snd_vae_tpu.parallel``: the mesh and its shapes,
``param_shardings`` on the port's state_dict against JAX's specs of the
flax tree, ``shard_graphbatch``'s blocks, the hints, ``shard_params``
(the broadcast, and the model axis's slices) and the global-batch
reductions, in four gloo processes (``tests/torch_dist_workers.py``); the
single-process surface of ``parallel.distributed`` here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from flax.traverse_util import flatten_dict
from torch_parity import configs, one_thread  # noqa: F401  (fixture)
from torch_dist_workers import run_many

from snd_vae_tpu.data.graphbatch import from_numpy as jax_batch
from snd_vae_tpu.models import build_model as jax_build_model
from snd_vae_tpu.parallel import make_mesh as jax_make_mesh
from snd_vae_tpu.parallel import param_shardings as jax_param_shardings
from snd_vae_tpu_torch.data.loaders import load_dataset
from snd_vae_tpu_torch.params import torch_layout, torch_name
from snd_vae_tpu_torch.parallel import is_primary
from snd_vae_tpu_torch.parallel.distributed import backend_for, initialize_distributed
from snd_vae_tpu_torch.parallel.mesh import node_block

pytestmark = pytest.mark.usefixtures("one_thread")
WORLD = 4


def _synthetic2_tree():
    """The flax parameter tree of the synthetic2 preset, shapes only."""
    jc, tc = configs("synthetic2")
    data = load_dataset(tc, "test", num_graphs=2, device="cpu")
    arrays = {k: v.numpy() for k, v in vars(data).items() if v is not None}
    jm = jax_build_model(jc)
    shapes = jax.eval_shape(lambda k: jm.init(k, jax_batch(**arrays), key=k),
                            jax.random.PRNGKey(0))["params"]
    return {k: tuple(v.shape) for k, v in flatten_dict(shapes, sep="/").items()}


def _perm_of(path, ndim):
    """The flax axis of each axis of the port's tensor for ``path``
    (``params.torch_layout``'s permutation)."""
    probe = np.empty(tuple(range(2, 2 + ndim)))
    return tuple(probe.shape.index(s) for s in torch_layout(path, probe).shape)


def _as_port(tree):
    """A flax tree of shapes as the port's state_dict: torch names and
    layouts."""
    return {torch_name(p): tuple(s[a] for a in _perm_of(p, len(s))) for p, s in tree.items()}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    trees = {"case": {"big": (64, 512), "small": (3,)},
             "synthetic2": _as_port(_synthetic2_tree())}
    cases = [("case", "1x4", 1024), ("synthetic2", "1x4", 1 << 14),
             ("synthetic2", "2x2", 1 << 14), ("synthetic2", "2x2", 128)]
    rng = np.random.default_rng(0)
    batch = {"adj": rng.random((8, 5, 5)), "features": rng.random((8, 5, 2)),
             "coords": rng.random((8, 5, 2)), "rel": rng.random((8, 5, 5))}
    inputs = {"trees": trees, "sharding_cases": cases, "batch": batch}
    (outs,) = run_many([("parallel", WORLD, tmp_path_factory.mktemp("parallel"), inputs)])
    return inputs, outs


def _jax_specs(tree, data, model, min_size):
    """JAX's specs of a tree of zeros of these shapes on a data x model
    mesh of the 8 virtual devices, padded with None to each leaf's rank."""
    params = {n: jnp.zeros(s, jnp.float32) for n, s in tree.items()}
    sh = jax_param_shardings(params, jax_make_mesh(data, model), min_size)
    return {n: tuple(sh[n].spec) + (None,) * (len(tree[n]) - len(sh[n].spec)) for n in tree}


def _jax_specs_in_port_layout(tree_name, data, model, min_size):
    """JAX's specs of the flax tree, each moved to the port's name and
    axis order: the axis JAX shards, where the port's tensor holds it."""
    if tree_name == "case":
        return _jax_specs({"big": (64, 512), "small": (3,)}, data, model, min_size)
    flax = _synthetic2_tree()
    specs = _jax_specs(flax, data, model, min_size)
    return {torch_name(p): tuple(spec[a] for a in _perm_of(p, len(spec)))
            for p, spec in specs.items()}


def test_make_mesh_shapes_and_size_check(world4):
    _, outs = world4
    for r, o in enumerate(outs):
        assert o["shapes"] == {"4x1": (4, 1), "2x2": (2, 2), "1x4": (1, 4)}
        assert "needs 8 processes" in o["too_big"]
        assert o["rank_again"] == r and o["primary"] == (r == 0)


def test_param_shardings_match_jax(world4):
    """JAX's ``test_param_shardings_assigns_model_axis`` case, and the port's
    synthetic2 state_dict (torch names and layouts: E2E's ``w1`` is [O, C,
    1, k_h] where flax holds [1, k_h, C, O]) against JAX's specs of the same
    model's flax tree, at model 4 and 2: each tensor is sharded on the axis
    that holds the element JAX shards (at model 2, ``e_deconvs.0.w1``
    [50, 80, 1, 25] on O = 50, its flax last axis, not on C = 80)."""
    inputs, outs = world4
    sharded = 0
    for tree, mesh_name, min_size in inputs["sharding_cases"]:
        model = int(mesh_name.split("x")[1])
        want = _jax_specs_in_port_layout(tree, 2, model, min_size)
        for o in outs:
            assert o["shardings"][(tree, mesh_name, min_size)] == want, (tree, mesh_name)
        sharded += sum("model" in s for s in want.values())
    assert outs[0]["shardings"][("case", "1x4", 1024)] == {"big": (None, "model"),
                                                           "small": (None,)}
    assert outs[0]["shardings"][("synthetic2", "2x2", 1 << 14)]["e_deconvs.0.w1"] == (
        "model", None, None, None)
    assert sharded > 2


def test_shard_graphbatch_blocks(world4):
    inputs, outs = world4
    adj = torch.from_numpy(inputs["batch"]["adj"])
    for r, o in enumerate(outs):
        torch.testing.assert_close(o["blocks"]["4x1"], adj[2 * r:2 * r + 2], rtol=0, atol=0)
        torch.testing.assert_close(o["blocks"]["2x2"], adj[4 * (r // 2):4 * (r // 2) + 4],
                                   rtol=0, atol=0)
        torch.testing.assert_close(o["blocks"]["1x4"], adj, rtol=0, atol=0)
        assert "does not split over 4" in o["uneven"]


def test_hints_are_identity_without_a_model_axis_and_raise_with_one(world4):
    """Without a model axis above 1 both hints are the identity.  With one
    (2x2 and 1x4) they no longer raise: ``shard_nodes`` and ``constrain``
    return this rank's rows of the node axis in ``node_block``'s uneven
    split (5 over 2: 3, 2; over 4: 2, 2, 1, 0), rows pass through again,
    and ``gather_nodes`` puts the whole axis back."""
    _, outs = world4
    nodes = torch.arange(2 * 5 * 3).reshape(2, 5, 3)
    for r, o in enumerate(outs):
        assert o["identity"] == [True] * 5
        for name, m, idx in (("2x2", 2, r % 2), ("1x4", 4, r)):
            got = o["hint_rows"][name]
            start, size = node_block(5, m, idx)
            assert got["block"] == (start, size)
            assert torch.equal(got["shard_nodes"], nodes[:, start:start + size])
            assert torch.equal(got["constrain"], nodes[:, start:start + size])
            assert got["again"] and torch.equal(got["whole"], nodes)


def test_shard_params_broadcasts_rank0(world4):
    """Rank 0's values everywhere; on the 2x2 mesh a mapping comes back with
    each model rank's slice of the tensors JAX's rule shards (``big``
    [64, 8] on its last axis), the rest whole."""
    _, outs = world4
    big = torch.arange(64 * 8, dtype=torch.float64).reshape(64, 8)
    for r, o in enumerate(outs):
        assert torch.equal(o["broadcast"]["a"], torch.zeros(3))
        assert torch.equal(o["broadcast"]["b"], torch.zeros(2, 2, dtype=torch.float64))
        assert torch.equal(o["model_slices"]["small"], torch.zeros(3))
        assert torch.equal(o["model_slices"]["big"], big[:, 4 * (r % 2):4 * (r % 2) + 4])


def test_global_batch_reductions(world4):
    """Under the 4x1 mesh: each rank's draw is its rows of the global
    draw; sums, means of equal blocks and gathered rows are the global
    batch's."""
    _, outs = world4
    g = torch.Generator().manual_seed(3)
    full = torch.randn((2 * WORLD, 3), generator=g, dtype=torch.float64)
    local = [torch.arange(6, dtype=torch.float64).reshape(2, 3) + 10.0 * r for r in range(WORLD)]
    cat = torch.cat(local)
    for r, o in enumerate(outs):
        torch.testing.assert_close(o["local_draw"], full[2 * r:2 * r + 2], rtol=0, atol=0)
        torch.testing.assert_close(o["global_sum"], cat.sum(), rtol=1e-15, atol=0)
        torch.testing.assert_close(o["global_mean"][0], cat.mean(0), rtol=1e-15, atol=0)
        torch.testing.assert_close(o["global_mean"][1], cat.mean(), rtol=1e-15, atol=0)
        torch.testing.assert_close(o["global_rows"], cat, rtol=0, atol=0)


def test_distributed_surface_single_process(tmp_path):
    """Without a group: rank 0 is primary; the backend follows the device
    and a CUDA request without the card raises; one process joins a gloo
    group of one through a file, a second call returns its rank."""
    assert not dist.is_initialized() and is_primary()
    assert backend_for("cpu") == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            backend_for(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            initialize_distributed(f"file://{tmp_path}/rdv", 1, 0)
    assert initialize_distributed(f"file://{tmp_path}/rdv", 1, 0, "cpu") == 0
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert initialize_distributed() == 0 and is_primary()
    finally:
        dist.destroy_process_group()


def test_parallel_package_imports_no_jax():
    """``snd_vae_tpu_torch.parallel`` and its modules import neither JAX nor
    the JAX package (checked in a fresh interpreter)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = ("import snd_vae_tpu_torch.parallel, snd_vae_tpu_torch.parallel.large_graph, "
            "snd_vae_tpu_torch.parallel.batch, sys; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'snd_vae_tpu')];"
            " assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=str(root)))
