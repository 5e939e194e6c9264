"""Leaf planes padded, copied and decoded a query: the program's
``backend.planes`` counter (each distinct leaf stream of a plan once,
however many leaves reference it) over the window's queries.  None where
the program has no such counter."""

from h100_bench.totals import counter


def read(run):
    n = counter("backend.planes")
    if not n or not run.queries:
        return None
    return n / run.queries
