"""Nothing of the benchmark loads JAX or the JAX package, the reference loads
nothing of the program, and the harness reads no other file of the repo."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from conftest import ROOT

BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "snd_vae_tpu"}
# files of the repo that later PRs may change: the yardstick reads none
OUTSIDE = ("chip_smoke", "benchmarks_torch", "benchmarks", "bench")


def imported(path: Path) -> set:
    """The top-level names of every module a file imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def sources():
    return sorted(BENCH.rglob("*.py"))


def test_no_file_imports_jax_or_the_jax_package():
    assert sources()
    for path in sources():
        assert not imported(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert "snd_vae_tpu_torch" not in imported(path), path
        assert "portbench" not in imported(path) or path.name == "__init__.py", path


def test_the_harness_reads_no_other_file_of_the_repo():
    for path in sources():
        names = imported(path)
        assert not names & set(OUTSIDE), path
        text = path.read_text()
        for other in ("chip_smoke.py", "benchmarks_torch/", "bench.py", "BENCH_r0"):
            assert other not in text or path.parent.name == "tests", (path, other)


def test_a_run_holds_no_jax_module():
    """A whole run of a cell (on the CPU, tiny), then the process's modules."""
    code = (
        "import sys, time; sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('portbench_run', sys.argv[3])\n"
        "run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)\n"
        "import torch; torch.set_num_threads(1)\n"
        "from conftest import tiny, tiny_traffic\n"
        "from portbench.drive import Context, drive\n"
        "drive(Context('s2_train', tiny('synthetic2'), tiny_traffic('train'), 1, 0.2, True,\n"
        "              torch.device('cpu'), time.perf_counter()))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(run.held_modules())\n")
    p = subprocess.run([sys.executable, "-c", code, str(ROOT), str(BENCH / "tests"),
                        str(BENCH / "run.py")], capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    *_, modules, held = p.stdout.strip().splitlines()
    assert not set(eval(modules)) & FORBIDDEN
    assert "snd_vae_tpu_torch" in modules and held == "[]"
