"""Host ms a batch from enqueueing the device program to its words or
streams on the host: the program's ``backend.device`` spans."""

from h100_bench.totals import span_ms


def read(run):
    return span_ms(run, "backend.device")
