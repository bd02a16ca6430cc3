"""The port stands alone: no module of ``snd_vae_tpu_torch`` (the
``parallel`` subpackage and ``data/transforms.py`` included), nor
``chip_smoke.py``, nor the test helpers that run where JAX is absent
(``tests/torch_dist_workers.py``, the ranks of the multi-process tests, and
``tests/test_torch_cuda.py``, the card's tests) imports JAX, flax, optax,
sklearn, matplotlib (the card's machine has none: the figures draw on a
numpy raster) or the JAX package, and its entry points refuse to run on a missing
card instead of falling back."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "snd_vae_tpu", "sklearn", "matplotlib")


def _port_files():
    files = sorted((ROOT / "snd_vae_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist_workers.py",
                    ROOT / "tests" / "test_torch_cuda.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_files_import_no_jax():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"snd_vae_tpu_torch/parallel/large_graph.py", "snd_vae_tpu_torch/parallel/batch.py",
            "snd_vae_tpu_torch/data/transforms.py", "snd_vae_tpu_torch/visualize.py",
            "snd_vae_tpu_torch/utils/raster.py", "snd_vae_tpu_torch/utils/native.py"} <= names
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imported_roots(f)
           if m in FORBIDDEN]
    assert not bad, bad


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import snd_vae_tpu_torch, snd_vae_tpu_torch.models, snd_vae_tpu_torch.serve, "
            "snd_vae_tpu_torch.cli, snd_vae_tpu_torch.params, snd_vae_tpu_torch.data, "
            "snd_vae_tpu_torch.train, snd_vae_tpu_torch.losses, snd_vae_tpu_torch.checkpoint, "
            "snd_vae_tpu_torch.models.joint, snd_vae_tpu_torch.nn.geometric, "
            "snd_vae_tpu_torch.nn.decoders, snd_vae_tpu_torch.evaluate, "
            "snd_vae_tpu_torch.models.traversal, snd_vae_tpu_torch.nn.ckpt, "
            "snd_vae_tpu_torch.parallel, snd_vae_tpu_torch.parallel.large_graph, "
            "snd_vae_tpu_torch.data.transforms, snd_vae_tpu_torch.visualize, "
            "snd_vae_tpu_torch.utils.native, torch_dist_workers, test_torch_cuda, sys; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'snd_vae_tpu', 'sklearn', 'matplotlib')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
                   timeout=120)


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from snd_vae_tpu_torch.config import synthetic2_preset
    from snd_vae_tpu_torch.data.loaders import load_dataset
    from snd_vae_tpu_torch.models import build_model
    from snd_vae_tpu_torch.train import Trainer

    cfg = synthetic2_preset()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_dataset(cfg, "test", num_graphs=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, load_dataset(cfg, "train", num_graphs=10, device="cpu"))
    for run_type in ("sample", "test_generation"):
        proc = subprocess.run([sys.executable, "-m", "snd_vae_tpu_torch.cli", "--type", run_type],
                              cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0 and "CUDA" in proc.stderr, run_type


def test_chip_smoke_refuses_a_missing_card(tmp_path):
    """Without a card, and alone in a directory, the smoke script exits
    non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    for cwd in (ROOT, tmp_path):
        script = ROOT / "chip_smoke.py"
        if cwd == tmp_path:
            script = tmp_path / "chip_smoke.py"
            script.write_text((ROOT / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                              text=True, timeout=120, env=dict(os.environ, PYTHONPATH=""))
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
