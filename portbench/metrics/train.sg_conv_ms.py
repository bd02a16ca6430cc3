"""Device ms of the joint branch's motif-conv stack in one replay of the
train step, its forward and its backward: the program's ``sg_conv.forward``
plus ``sg_conv.backward`` spans (each the median over the traced epoch's
replays), from ``spans`` in its ``trace_rank0.launches.json``."""


def read(run):
    ms = ((run.launches or {}).get("spans") or {}).get("ms") or {}
    parts = [ms.get("sg_conv.forward"), ms.get("sg_conv.backward")]
    if run.mode != "train" or None in parts:
        return None
    return sum(parts)
