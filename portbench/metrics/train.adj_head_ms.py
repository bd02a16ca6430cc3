"""Device ms of the adjacency head in one replay of the train step, its
forward and its backward: the program's ``adj_head.forward`` plus
``adj_head.backward`` spans (each the median over the traced epoch's
replays), from ``spans`` in its ``trace_rank0.launches.json``."""


def read(run):
    ms = ((run.launches or {}).get("spans") or {}).get("ms") or {}
    parts = [ms.get("adj_head.forward"), ms.get("adj_head.backward")]
    if run.mode != "train" or None in parts:
        return None
    return sum(parts)
