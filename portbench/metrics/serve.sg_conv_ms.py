"""Device ms a request under the benchmark's ``sg_conv.<i>`` ranges (both
motif convs of the joint branch together)."""


def read(run):
    if run.trace is None or not run.units:
        return None
    by_range = run.trace.range_device_us(run.window, "sg_conv.")
    if not by_range:
        return None
    return sum(by_range.values()) / 1e3 / run.units
