"""The numbers that decide ``correct``: what the program produced on the timed
path against the plain reference, each held to its limit
(``limits/<config>.<mode>.json``); a number that has a limit and was not
produced fails.

Training (the trainer's first ``Trainer.run``, one epoch of ``nb`` steps,
against the reference's ``nb`` steps on the same batches):
  * ``loss_gap``: |L - L_ref| / |L_ref| of the epoch's mean loss;
  * ``moment_gap``: by the worst leaf, the gap between the norms of the
    optimizer's bias-corrected first moment after the epoch (the running
    mean of the gradients, from its ``state_dict``) and the reference's, over
    the larger of the reference leaf's norm and the median leaf's;
  * ``change_gap``: the same of each parameter's change over the epoch, by
    the worst leaf whose reference first gradient is at least
    ``MOVING_LEAF`` of the median leaf's (a leaf with a gradient nought to
    rounding moves under Adam by round-off alone);
  * ``change_gap_median``: the median of those leaves' change gaps, which
    catches a state left unchanged or a step taken on part of the batch
    where a few leaves' round-off sets the worst one.
Serving (the requests of the window sampled from the seed, and its last):
  * ``adj_logit_gap``, ``mean_gap``: the largest |x - x_ref| over the
    largest |x_ref| of the edge logits and of the posterior means.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

MOVING_LEAF = 1e-3
SERVE_FIELDS = {"adj_logit_gap": ("adj_prob",), "mean_gap": ("mean_sg", "mean_s", "mean_g")}


def _median(values: Sequence[float]) -> float:
    v = sorted(values)
    n = len(v)
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: Sequence[str]) -> Dict[str, float]:
    """Each leaf's | |prog| - |ref| | / max(|ref|, median |ref|)."""
    pn = {k: float(prog[k].double().norm()) for k in leaves}
    rn = {k: float(ref[k].double().norm()) for k in leaves}
    med = _median(list(rn.values()))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in leaves}


def train_numbers(prog: dict, ref: dict, p0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``prog``: {"loss": mean, "moments": {name: m̂}, "params": {name: after}};
    ``ref``: the same and "grads", the first step's; ``p0`` the initial
    weights."""
    a, b = prog["loss"], ref["loss"]
    names = list(ref["grads"])
    gnorm = {k: float(ref["grads"][k].double().norm()) for k in names}
    med = _median(list(gnorm.values()))
    moving = [k for k in names if gnorm[k] >= MOVING_LEAF * med]
    change = lambda P: {k: P[k] - p0[k] for k in names}
    changes = leaf_gaps(change(prog["params"]), change(ref["params"]), moving)
    moments = leaf_gaps(prog["moments"], ref["moments"], names)
    return {"loss_gap": abs(a - b) / abs(b) if math.isfinite(a) else math.inf,
            "moment_gap": max(moments.values()),
            "moment_gap_median": _median(list(moments.values())),
            "change_gap": max(changes.values()),
            "change_gap_median": _median(list(changes.values()))}


def worst_change(prog: dict, ref: dict, p0: Dict[str, torch.Tensor]) -> dict:
    """The leaf whose change gaps most: its name and size, how many of its
    elements moved differently (by more than a tenth of the learning rate's
    order, 1e-5), and how many of those have a first gradient under 1e-7 in
    the reference (where Adam's step is round-off's: m̂/(√v̂ + 1e-8))."""
    names = list(ref["grads"])
    d = {k: ((prog["params"][k] - p0[k]) - (ref["params"][k] - p0[k])).abs() for k in names}
    gaps = leaf_gaps({k: prog["params"][k] - p0[k] for k in names},
                     {k: ref["params"][k] - p0[k] for k in names}, names)
    k = max(gaps, key=gaps.get)
    moved = d[k] > 1e-5
    return {"worst_leaf": k, "worst_leaf_size": d[k].numel(),
            "moved_differently": int(moved.sum()),
            "of_them_tiny_gradient": int((moved & (ref["grads"][k].abs() < 1e-7)).sum())}


def serve_numbers(pairs: List[tuple]) -> Dict[str, float]:
    """``pairs``: (program's fields, reference's fields) of each compared
    request, each a dict of tensors."""
    out = {}
    for number, fields in SERVE_FIELDS.items():
        worst = 0.0
        for prog, ref in pairs:
            for f in fields:
                if f not in ref:
                    continue
                scale = float(ref[f].abs().max())
                gap = float((prog[f].to(ref[f].device).double() - ref[f].double()).abs().max())
                worst = max(worst, gap / scale if math.isfinite(gap) else math.inf)
        if any(f in ref for _, ref in pairs[:1] for f in fields):
            out[number] = worst
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number that has a limit, beside it."""
    return {k: {"value": numbers.get(k, math.inf), "limit": limits[k]} for k in limits}


def passes(checked: Dict[str, dict]) -> bool:
    return bool(checked) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                 for c in checked.values())
