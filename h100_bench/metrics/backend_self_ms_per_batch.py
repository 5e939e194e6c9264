"""Host ms a batch inside the backend's call that no named span covers:
the self time of the program's ``backend.call`` span."""

from h100_bench.totals import span_ms


def read(run):
    return span_ms(run, "backend.call", key="self_s")
