"""Dense evaluation of the benchmark's neutral predicate tuples.

A predicate is a tuple over column positions of the generated table::

    ("eq", col, value)          ("in", col, [values])
    ("range", col, lo, hi)      rows with lo <= value <= hi
    ("and", [p, ...])  ("or", [p, ...])  ("not", p)

:func:`mask` returns one boolean a row.  Given the columns in the index's
row order it answers in that order.
"""

from __future__ import annotations

import numpy as np


def mask(pred, cols) -> np.ndarray:
    kind = pred[0]
    if kind == "eq":
        return cols[pred[1]] == pred[2]
    if kind == "in":
        return np.isin(cols[pred[1]], np.asarray(pred[2], dtype=np.int64))
    if kind == "range":
        c = cols[pred[1]]
        return (c >= pred[2]) & (c <= pred[3])
    if kind == "not":
        return ~mask(pred[1], cols)
    if kind in ("and", "or"):
        parts = [mask(p, cols) for p in pred[1]]
        out = parts[0].copy()
        for p in parts[1:]:
            if kind == "and":
                out &= p
            else:
                out |= p
        return out
    raise ValueError(f"unknown predicate kind {kind!r}")
