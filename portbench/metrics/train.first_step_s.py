"""Seconds of the window's first train step: the eager step and the capture
of the replayed step (the program's counter ``run.first_step``, from
``counters`` in its ``trace_rank0.launches.json``)."""


def read(run):
    counters = (run.launches or {}).get("counters") or {}
    first = counters.get("run.first_step")
    if run.mode != "train" or not first or not first["count"]:
        return None
    return first["total_s"]
