"""Host ms a query in the per-stage device program: the program's
``backend.stages`` spans (the decode, every ``wordops`` / ``slicefold``
stage and the root encode enqueued, and any wait for the launch queue)
over the window's queries.  None where the window never entered the span:
a program without it, or plans that all ran fused."""

from h100_bench.totals import span_ms, totals

SPAN = "backend.stages"


def read(run):
    snap = totals()
    if snap is None or SPAN not in snap["spans"]:
        return None
    return span_ms(run, SPAN, per="query")
