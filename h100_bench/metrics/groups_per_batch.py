"""Device programs a batch: plan groups (one root, capacity bucket and
row count each), the program's ``backend.groups`` counter."""

from h100_bench.totals import counter


def read(run):
    n = counter("backend.groups")
    if n is None or not run.latencies_s:
        return None
    return n / len(run.latencies_s)
