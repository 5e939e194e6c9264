"""Host ms a batch blocked in the host-to-device copies of the padded
leaves (pageable memory): the program's ``backend.h2d`` spans."""

from h100_bench.totals import span_ms


def read(run):
    return span_ms(run, "backend.h2d")
