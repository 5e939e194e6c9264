"""The bytes the queries need (``roofline.needed_bytes``: distinct leaf
streams read once, answers written once) at the HBM peak, over the
device kernels' time in the window, in percent."""

from h100_bench.roofline import share_percent


def read(run):
    if run.trace is None:
        return None
    return share_percent(run.needed_bytes, run.trace.kernel_s)
