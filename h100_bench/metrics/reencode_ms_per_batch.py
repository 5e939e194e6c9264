"""Host ms a batch of re-encoding answers past ``MAX_DIRTY`` words on the
host (``ewah.compress``): the program's ``backend.reencode`` spans."""

from h100_bench.totals import span_ms


def read(run):
    return span_ms(run, "backend.reencode")
