"""Device kernels in the traced window over the predicates answered."""


def read(run):
    t = run.trace
    if t is None or not t.n_kernels or not run.queries:
        return None
    return t.n_kernels / run.queries
