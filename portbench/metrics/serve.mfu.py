"""The traced reconstructions' model FLOP/s as a share of the card's peak in
the configuration's precision: a request's forward products (encode and
decode), over the traced window's wall."""

from portbench import counts


def read(run):
    if run.trace is None or run.window is None or not run.units or run.mode != "reconstruct":
        return None
    cfg, G, S = run.cfg, run.graphs_per_unit, run.cfg["sampling_num"]
    per = counts.forward_flops(cfg, G, S)
    return 100.0 * per * run.units / run.window_s / counts.PEAK_FLOPS[cfg["compute_dtype"]]
