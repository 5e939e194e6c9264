"""Host ms a batch of grouping the plans and padding each group's
leaf streams into one batch: the program's ``backend.pad`` spans."""

from h100_bench.totals import span_ms


def read(run):
    return span_ms(run, "backend.pad")
