"""Median host ms from a serving call to its return, before the outputs are
synchronized: the window's untraced requests, timed by the benchmark."""

import statistics


def read(run):
    if not run.enqueue_ms:
        return None
    return statistics.median(run.enqueue_ms)
