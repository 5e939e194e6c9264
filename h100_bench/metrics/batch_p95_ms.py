"""95th percentile of a batch's time from submission to its last answer
on the host, over the window's batches, in ms.  Kept beside the
end-to-end metrics: a window holds too few batches for a bound on a
tail."""

from h100_bench.stats import p95_ms


def read(run):
    return p95_ms(run.latencies_s)
