"""The traced epoch's model FLOP/s as a share of the card's peak in the
configuration's precision: the step's products (``counts.train_step_flops``,
nothing recomputed) times its steps, over the traced window's wall."""

from portbench import counts


def read(run):
    if run.trace is None or run.window is None or not run.units:
        return None
    cfg = run.cfg
    flops = counts.train_step_flops(cfg, run.graphs_per_unit, cfg["sampling_num"]) * run.units
    return 100.0 * flops / run.window_s / counts.PEAK_FLOPS[cfg["compute_dtype"]]
