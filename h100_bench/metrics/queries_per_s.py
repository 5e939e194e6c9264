"""Predicates answered in the window over its seconds (closed loop; a
batch counts once its last answer is on the host)."""


def read(run):
    return run.queries / run.window_s if run.window_s > 0 else None
