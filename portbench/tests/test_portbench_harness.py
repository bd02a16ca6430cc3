"""The benchmark's file against its contract, cells found by name, a cell,
configuration, traffic mix, traffic mode, limits and metric taken up as new
files alone, and the command's refusal without a card."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_to_its_contract():
    b = bench()
    assert set(b) == KEYS
    assert os.path.getsize(ROOT / "BENCHMARK.json") <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert len(b["command"]) <= 32 and all(line(w) for w in b["command"])
    assert not any(w.startswith("/") or ".." in w for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith(b["paths"][0] + "/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    configs = {c["name"] for c in b["configs"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    assert configs == {w["config"] for w in b["workloads"]}
    cells = {w["name"] for w in b["workloads"]}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names) and len(cells) == len(b["workloads"])
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    for cell in cells:
        assert sum(cell in m.get("workloads", cells) for m in b["end_to_end"]) >= 2
        assert any(cell in m["workloads"] for m in b["per_layer"])


def test_every_cells_files_are_found_by_name():
    from portbench import run
    from portbench.drive import mode_module

    b = bench()
    for w in b["workloads"]:
        cfg = run.load_json("configs", w["config"])
        tr = run.load_json("traffic", w["traffic"])
        assert cfg["name"] == w["config"] and callable(mode_module(tr["mode"]).drive)
        assert set(run.limits(w["config"], tr["mode"]))
        for m in run.per_layer_metrics(b, w["name"]):
            assert callable(run.metric_reader(m["name"]))
    for c in b["configs"]:
        assert run.load_json("configs", c["name"])["source"] == c["source"]


def test_a_new_cell_config_traffic_mode_and_metric_need_only_new_files(tmp_path):
    """A copy of the benchmark, to which only files and entries are added,
    runs the new cell (here on the CPU, at a tiny size) under a new traffic
    mode and reports the new metric."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    os.symlink(ROOT / "snd_vae_tpu_torch", tmp_path / "snd_vae_tpu_torch")
    from conftest import tiny

    cfg = tiny("synthetic2")
    cfg["name"] = "tiny_s2"
    (tmp_path / "portbench" / "configs" / "tiny_s2.json").write_text(json.dumps(cfg))
    tr = json.loads((ROOT / "portbench" / "traffic" / "train.json").read_text())
    tr.update(mode="train_chunked", chunk=2)
    (tmp_path / "portbench" / "traffic" / "train_chunk2.json").write_text(json.dumps(tr))
    # a new mode: training in chunks of ``chunk`` epochs, one host sync a chunk
    (tmp_path / "portbench" / "modes" / "train_chunked.py").write_text(textwrap.dedent("""
        from portbench.drive import mode_module

        def drive(ctx):
            ctx.traffic = {**ctx.traffic, "epoch_chunk": ctx.traffic["chunk"]}
            return mode_module("train").drive(ctx)
    """))
    limits = json.loads((ROOT / "portbench" / "limits" / "synthetic2.train.json").read_text())
    (tmp_path / "portbench" / "limits" / "tiny_s2.train_chunked.json").write_text(
        json.dumps(limits))
    (tmp_path / "portbench" / "metrics" / "test.steps_traced.py").write_text(
        "def read(run):\n    return run.units or None\n")
    b = bench()
    b["configs"].append({"name": "tiny_s2", "source": "https://github.com/xguo7/SND-VAE",
                         "file": "portbench/configs/tiny_s2.json", "reduced": ["num_nodes"],
                         "why": "a test"})
    b["workloads"].append({"name": "tiny_s2.train", "config": "tiny_s2",
                           "traffic": "train_chunk2", "chips": 1, "why": "a test"})
    b["end_to_end"][0]["workloads"].append("tiny_s2.train")
    b["per_layer"].append({"name": "test.steps_traced", "unit": "steps", "better": "higher",
                           "source": "program_counter", "layer": "entry: dispatch",
                           "moves": "trained_graphs_per_s", "workloads": ["tiny_s2.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = textwrap.dedent("""
        import json, sys, time
        sys.path.insert(0, sys.argv[1])
        import torch
        torch.set_num_threads(1)
        from portbench import run
        out = {}
        for trace in (False, True):
            res, _ = run.run_cell(run.load_benchmark(), "tiny_s2.train", 7, 0.5, trace, "cpu",
                                  time.perf_counter())
            out[trace] = res
        print(json.dumps([out[False], out[True]]))
    """)
    p = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                       text=True, timeout=600, cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    plain, traced = json.loads(p.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"trained_graphs_per_s", "setup_s"}
    assert traced["metrics"]["test.steps_traced"]["value"] == 3     # 6 graphs, 2 a batch
    assert list(traced)[-1] == "check"


def test_the_command_refuses_without_a_card():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "s2_train", "--seed",
                        "3000000001", "--seconds", "1", "--trace", "0"], capture_output=True,
                       text=True, timeout=300, cwd=ROOT, env={**os.environ,
                                                              "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA card" in p.stderr


def test_the_command_fails_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files
    a run stops before any result."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys, time; sys.path.insert(0, sys.argv[1]); from portbench import run; "
            "run.run_cell(run.load_benchmark(), 's2_train', 1, 1, False, 'cpu', time.time())")
    p = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path)
    assert p.returncode != 0 and p.stdout == ""
    assert "snd_vae_tpu_torch" in p.stderr


@pytest.mark.parametrize("config,traffic", [("synthetic2", "train"), ("protein", "train"),
                                            ("protein", "reconstruct")])
def test_each_mode_runs_correct_on_the_cpu_at_a_tiny_size(config, traffic):
    """The whole run of each configuration's modes, traced, at a tiny size on
    the CPU: the port against the reference within the limits."""
    import time

    import torch

    from conftest import tiny, tiny_traffic
    from portbench import check
    from portbench.drive import Context, drive
    from portbench.run import limits

    cfg, tr = tiny(config), tiny_traffic(traffic)
    out = drive(Context(f"{config}.{traffic}", cfg, tr, 2**31 + 5, 0.3, True,
                        torch.device("cpu"), time.perf_counter()))
    checked = check.judge(out.numbers, limits(config, tr["mode"]))
    assert check.passes(checked) and out.failed == 0, checked
    assert out.attempted >= 1 and out.run.units >= 1 and out.run.window_s > 0
