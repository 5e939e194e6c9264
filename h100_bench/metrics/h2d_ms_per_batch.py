"""Device ms of host-to-device copies a batch (the profiler's
``Memcpy HtoD`` records)."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or not run.latencies_s:
        return None
    return 1e3 * run.trace.h2d_s / len(run.latencies_s)
