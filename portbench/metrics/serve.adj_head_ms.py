"""Device ms a request under the benchmark's ``adj_head`` range (the
adjacency head: the pair map, the E2E stack, the edge logits)."""


def read(run):
    if run.trace is None or not run.units:
        return None
    us = run.trace.range_device_us(run.window, "adj_head").get("adj_head")
    return None if not us else us / 1e3 / run.units
