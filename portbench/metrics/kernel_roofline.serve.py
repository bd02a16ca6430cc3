"""The port's forward kernels in the traced reconstructions (K1
``motif_level3`` where the configuration has third-order motif convs, K3
``adj_matmul``): the sum of their roofline bounds on the requests' inputs
over the sum of their device time in the trace."""

from portbench import counts


def read(run):
    if run.trace is None or run.mode != "reconstruct" or not run.trees:
        return None
    names = (counts.KERNEL_NAMES["motif_level3"], counts.KERNEL_NAMES["adj_matmul"])
    us = run.trace.device_us(run.window, names)
    if not us:
        return None
    bound = sum(counts.step_kernel_bound(run.cfg, t, train=False) for t in run.trees)
    return 100.0 * bound / (us / 1e6)
