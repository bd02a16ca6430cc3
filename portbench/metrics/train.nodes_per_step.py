"""Kernel plus copy nodes that one replay of the captured train step runs,
as the program counts them in its trace's ``trace_rank0.launches.json``."""


def read(run):
    launches = run.launches
    if not launches or not launches.get("graph_replays"):
        return None
    return launches["kernels_per_replay"] + launches["copies_per_replay"]
