"""Host ms of ``compile_plan`` a predicate, where the benchmark calls it
(the ``compressed`` entry)."""


def read(run):
    plan_s = run.spans_s.get("plan")
    if plan_s is None or not run.queries:
        return None
    return 1e3 * plan_s / run.queries
