"""Shared pieces of the benchmark's CPU tests: the checkout on the import path,
one torch thread, and tiny copies of the configurations."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny(name: str) -> dict:
    """``configs/<name>.json`` at 6 nodes, 2 trees a graph, 2 graphs a batch."""
    with open(ROOT / "portbench" / "configs" / f"{name}.json") as f:
        cfg = copy.deepcopy(json.load(f))
    cfg.update(num_nodes=6, sampling_num=2, splits={"train": 6, "test": 4})
    cfg["train"]["batch_size"] = 2
    return cfg


def tiny_traffic(name: str) -> dict:
    with open(ROOT / "portbench" / "traffic" / f"{name}.json") as f:
        tr = json.load(f)
    if tr["mode"] != "train":
        tr.update(graphs_per_request=2, warmup_requests=1, traced_requests=3)
    return tr


@pytest.fixture(autouse=True)
def one_thread():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
