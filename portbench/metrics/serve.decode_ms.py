"""Device ms a request of the records launched under the program's own
``model.decode`` ranges (``model.decode`` and the adjacency head's
``model.decode.adj_head`` inside it)."""


def read(run):
    if run.trace is None or run.mode != "reconstruct" or not run.units:
        return None
    by_range = run.trace.range_device_us(run.window, "model.decode")
    if not by_range:
        return None
    return sum(by_range.values()) / 1e3 / run.units
