"""On the card: the control (the reference in TF32, the precision below the
configurations' f32 with TF32 off, put in the program's place) comes out not
correct in every cell, at the cell's own size, on three seeds.  Run on the
card's machine:

    python3 -m pytest -m cuda -q portbench/tests/test_portbench_control.py
"""

from __future__ import annotations

import json

import pytest

from conftest import ROOT


def cells():
    with open(ROOT / "BENCHMARK.json") as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_the_tf32_control_is_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import check, control
    from portbench.run import find_cell, limits, load_benchmark, load_json

    w = find_cell(load_benchmark(), cell)
    mode = load_json("traffic", w["traffic"])["mode"]
    held = limits(w["config"], mode)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        (reading,) = control.readings(cell, seed, ["tf32"])
        numbers = {k: v for k, v in reading.items() if k != "variant"}
        assert not check.passes(check.judge(numbers, held)), (seed, numbers, held)
