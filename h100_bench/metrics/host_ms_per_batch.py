"""A batch's wall time less its device-busy time, in ms, averaged over the
traced batches: the host side of the backend and the entry point."""

from h100_bench.stats import per_batch_host_s


def read(run):
    host = per_batch_host_s(run)
    if not host or not any(run.trace.batch_busy_s):
        return None
    return 1e3 * sum(host) / len(host)
