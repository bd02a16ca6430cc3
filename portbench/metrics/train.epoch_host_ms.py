"""Host ms an epoch of the window's ``Trainer.run`` outside the launches and
the sync: the program's counters ``epoch.load``, ``epoch.log``,
``epoch.checkpoint``, ``epoch.eval`` and ``epoch.resample`` (their total
seconds over the run) over its epochs (``epoch.load``'s count), from
``counters`` in its ``trace_rank0.launches.json``."""

SPANS = ("epoch.load", "epoch.log", "epoch.checkpoint", "epoch.eval", "epoch.resample")


def read(run):
    counters = (run.launches or {}).get("counters") or {}
    if run.mode != "train" or not all(n in counters for n in SPANS):
        return None
    epochs = counters["epoch.load"]["count"]
    if not epochs:
        return None
    return 1e3 * sum(counters[n]["total_s"] for n in SPANS) / epochs
