"""Attribute-value histograms (the 'histogram-aware' in the paper's title)."""

from __future__ import annotations

import numpy as np


def column_histogram(col: np.ndarray, n_values: int | None = None) -> np.ndarray:
    """Frequency f(v) of each attribute value id in a column."""
    col = np.asarray(col)
    if n_values is None:
        # col.max() raises on zero-length input; an empty column simply has
        # no observed values, i.e. a zero-length histogram
        n_values = int(col.max()) + 1 if col.size else 0
    return np.bincount(col, minlength=n_values)


def value_order(hist: np.ndarray, policy: str = "alpha") -> np.ndarray:
    """Order in which attribute values are assigned bitmap codes.

    'alpha': by value id (Alpha-Lex / Gray-Lex).
    'freq' : by descending frequency, value id tie-break (Gray-Frequency).
    Returns an array ``order`` with order[rank] = value id.
    """
    n = len(hist)
    if policy == "alpha":
        return np.arange(n)
    if policy == "freq":
        return np.lexsort((np.arange(n), -hist.astype(np.int64)))
    raise ValueError(f"unknown value-order policy: {policy}")


def freq_rank_keys(col: np.ndarray, hist: np.ndarray) -> np.ndarray:
    """Per-row sort key for Gray-Frequency: rank of the row's value when
    values are ordered by (descending frequency, value id).  Rows with equal
    keys are exactly rows whose values share a frequency class and id."""
    order = value_order(hist, "freq")
    rank = np.empty(len(hist), dtype=np.int64)
    rank[order] = np.arange(len(hist))
    return rank[np.asarray(col)]
