"""Host ms of ``compile_plan`` a predicate, from the program's own
``query.plan`` span: every call in the window, the rows entry's too."""

from h100_bench.totals import span_ms


def read(run):
    return span_ms(run, "query.plan", per="query")
