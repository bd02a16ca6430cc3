"""Device ms a request of the records launched under the program's own
``model.encode`` ranges (``model.encode`` and the motif convs'
``model.encode.sg_conv.<i>`` inside it)."""


def read(run):
    if run.trace is None or run.mode != "reconstruct" or not run.units:
        return None
    by_range = run.trace.range_device_us(run.window, "model.encode")
    if not by_range:
        return None
    return sum(by_range.values()) / 1e3 / run.units
