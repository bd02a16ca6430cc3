"""Share of the traced training window in which no kernel, copy or set ran
on the card (the union of their records)."""


def read(run):
    if run.trace is None or run.mode != "train" or not run.window:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
