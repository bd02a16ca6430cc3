"""Share of the traced training window in which the card sat idle inside a
replay: from each replay's first to its last record of the program's stamp
kernel (``spans.kernel`` in its ``trace_rank0.launches.json``; a replay's
records share its launch's correlation), the time no record ran.
``device.idle_pct.train`` less this is the idle between replays."""


def replays(run, kernel):
    """Each replay's records (start, end) of ``kernel`` in the traced window,
    grouped by their launch's correlation, in time order."""
    by_corr = {}
    for s, e, name, corr in run.trace.records(run.window):
        if kernel in name:
            by_corr.setdefault(corr, []).append((s, e))
    return sorted((sorted(r) for r in by_corr.values()), key=lambda r: r[0][0])


def read(run):
    if run.trace is None or run.mode != "train" or not run.window:
        return None
    kernel = ((run.launches or {}).get("spans") or {}).get("kernel")
    if not kernel:
        return None
    recs = replays(run, kernel)
    if not recs:
        return None
    idle = 0.0
    for r in recs:
        a, b = r[0][0], max(e for _, e in r)
        idle += (b - a) - run.trace.busy_us((a, b))
    return 100.0 * idle / (run.window[1] - run.window[0])
