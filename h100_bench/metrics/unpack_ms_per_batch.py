"""Host ms a batch of turning answer words into row ids
(``unpack_bits``, ``flatnonzero``): the program's ``backend.unpack`` spans."""

from h100_bench.totals import span_ms


def read(run):
    return span_ms(run, "backend.unpack")
