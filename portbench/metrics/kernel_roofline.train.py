"""The port's kernels in the traced epoch of training (K1 ``motif_level3``,
K2 its backward, K3 ``adj_matmul`` and K3's backward): the sum of their
roofline bounds on the epoch's inputs (``counts.step_kernel_bound``) over the
sum of their device time in the trace."""

from portbench import counts


def read(run):
    if run.trace is None or run.mode != "train" or not run.trees:
        return None
    us = run.trace.device_us(run.window, tuple(counts.KERNEL_NAMES.values()))
    if not us:
        return None
    bound = sum(counts.step_kernel_bound(run.cfg, t, train=True) for t in run.trees)
    return 100.0 * bound / (us / 1e6)
