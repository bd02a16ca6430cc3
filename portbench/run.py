"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is the ``workloads`` entry of ``BENCHMARK.json`` named ``<name>``;
its configuration is ``portbench/configs/<config>.json``, its traffic mix
``portbench/traffic/<traffic>.json`` (parameters, and the ``mode`` whose
module ``portbench/modes/<mode>.py`` drives it), and each per-layer metric
``portbench/metrics/<metric>.py`` (a ``read(run)`` that returns a number or
None).  With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer ones.  The last line of standard
output is the result as one JSON object; the numbers that decide ``correct``
are the last lines of standard error and the result's last key, ``check``.

Exit codes: 0 a result; 2 no CUDA card, or fewer than the cell asks for;
3 the traced run's trace lacks device records of launches it made; 4 the
process holds JAX or the JAX package; 1 any other failure.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "snd_vae_tpu")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str, root: Path = HERE) -> dict:
    with open(root / kind / f"{name}.json") as f:
        return json.load(f)


def limits(config: str, mode: str, root: Path = HERE) -> dict:
    """The limit of each number that decides ``correct`` for a configuration
    under a traffic mode: ``limits/<config>.<mode>.json``."""
    return load_json("limits", f"{config}.{mode}", root)


def metric_reader(name: str, root: Path = HERE):
    """``read`` of ``metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric with ``workloads`` is the listed cells'; one without is every
    cell's that reports what it moves (an end-to-end metric without it: every
    cell's)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def end_to_end_metrics(bench: dict, cell: str) -> list:
    return [m for m in bench["end_to_end"] if applies(m, cell, set())]


def per_layer_metrics(bench: dict, cell: str) -> list:
    reported = {m["name"] for m in end_to_end_metrics(bench, cell)}
    return [m for m in bench["per_layer"] if applies(m, cell, reported)]


def held_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, patch_program=None):
    """Set up, drive and judge one run of cell ``name``; returns (the result
    dict, the checked numbers)."""
    import torch

    from portbench import check
    from portbench.drive import Context, drive

    cell = find_cell(bench, name)
    cfg = load_json("configs", cell["config"])
    traffic = load_json("traffic", cell["traffic"])
    ctx = Context(name, cfg, traffic, seed % (1 << 63), seconds, trace, torch.device(device),
                  t_start)
    if patch_program is not None:
        ctx.patch_program = patch_program
    out = drive(ctx)
    checked = check.judge(out.numbers, limits(cell["config"], traffic["mode"]))
    correct = check.passes(checked) and out.failed == 0
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if trace:
        for m in per_layer_metrics(bench, name):
            value = metric_reader(m["name"])(out.run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        for m in end_to_end_metrics(bench, name):
            metrics[m["name"]] = {"value": out.e2e[m["name"]], "unit": units[m["name"]]}
    dev = ctx.device
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": out.peak_bytes}
    result = {"correct": bool(correct), "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = out.run.busy_s
        device_info["window_s"] = out.run.window_s
        result["breakdown"] = out.run.trace.breakdown(out.run.window)
    result["check"] = checked
    return result, checked


def prepare_process() -> None:
    """Before torch loads: the kernel caches at fixed paths inside the
    checkout (the port builds its own under build/kernels), one thread per
    numeric library, libraries that could load JAX told not to, and the
    checkout's root, not this folder, at the head of the import path."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    for key in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(key, "1")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() not in (HERE, ROOT)]


def main(argv=None) -> int:
    prepare_process()
    args = parse(argv)
    bench = load_benchmark()
    cell = find_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    from portbench.drive import TraceRefused

    try:
        result, checked = run_cell(bench, args.workload, args.seed, args.seconds,
                                   bool(args.trace), "cuda", T_START)
    except TraceRefused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    held = held_modules()
    if held:
        print(f"portbench: the process holds {held}: no result", file=sys.stderr)
        return 4
    for k, c in checked.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
