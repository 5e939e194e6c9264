"""The compressed index's bytes over its rows: the paper's result, which a
worse row order or encoding would raise."""


def read(run):
    return 4.0 * run.index_words / run.n_rows if run.n_rows else None
