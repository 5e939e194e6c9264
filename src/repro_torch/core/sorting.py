"""Row-reordering heuristics (paper §4.1, §4.2, §4.4).

All functions return a permutation ``perm`` such that ``col[perm]`` is the
reordered column.  Column order matters: ``columns[0]`` is the primary sort
key (the paper's d_1).
"""

from __future__ import annotations

from functools import cmp_to_key

import numpy as np

from .encoding import gray_less
from .histogram import column_histogram, freq_rank_keys


def order_unsorted(columns) -> np.ndarray:
    return np.arange(len(columns[0]))


def order_lex(columns) -> np.ndarray:
    """Lexicographic row sort; columns[0] is the primary key.

    This is the row order of both Alpha-Lex and Gray-Lex (they differ only
    in how bitmap codes are allocated to attribute values, §4.2).
    """
    # np.lexsort's *last* key is primary
    return np.lexsort(tuple(np.asarray(c) for c in reversed(columns)))


def order_gray_frequency(columns, hists=None) -> np.ndarray:
    """Gray-Frequency (§4.2): lexicographically sort the extended rows
    f(a_1), a_1, f(a_2), a_2, ... — i.e. within each column, cluster values
    of equal frequency, ordering value classes by descending frequency."""
    columns = [np.asarray(c) for c in columns]
    if hists is None:
        hists = [column_histogram(c) for c in columns]
    keys = []
    for col, hist in zip(columns, hists):
        keys.append(freq_rank_keys(col, hist))
    return np.lexsort(tuple(reversed(keys)))


def order_frequent_component(columns, hists=None) -> np.ndarray:
    """Frequent-Component (§4.4): compare rows by their i-th most frequent
    attribute-value frequency, regardless of which column it came from;
    ties broken by the row values themselves."""
    columns = [np.asarray(c) for c in columns]
    if hists is None:
        hists = [column_histogram(c) for c in columns]
    n = len(columns[0])
    freqs = np.stack([h[c] for c, h in zip(columns, hists)], axis=1)  # (n, c)
    freqs = -np.sort(-freqs, axis=1)  # descending per row
    keys = [freqs[:, i] for i in range(freqs.shape[1])]
    # negative so the most-frequent-first rows compare adjacently in
    # descending frequency order, then tie-break on raw values
    keys = [-k for k in keys] + [np.asarray(c) for c in columns]
    return np.lexsort(tuple(reversed(keys)))


def order_gray_code(columns, codes_per_col) -> np.ndarray:
    """True Gray-code row sort over the concatenated k-of-N codes
    (Algorithm 2 comparator).  O(n log n) comparisons, python speed — the
    paper found this 2 orders of magnitude slower than lexicographic sort;
    provided for validation on small inputs."""
    columns = [np.asarray(c) for c in columns]
    n = len(columns[0])
    # build per-row sparse positions of ones across the concatenated bitmaps
    pos_rows = []
    offset = 0
    per_col_pos = []
    for col, codes in zip(columns, codes_per_col):
        per_col_pos.append(np.sort(codes[col], axis=1) + offset)
        offset += int(codes.max()) + 1
    allpos = np.concatenate(per_col_pos, axis=1)
    allpos.sort(axis=1)

    def cmp(i, j):
        if gray_less(allpos[i], allpos[j]):
            return -1
        if gray_less(allpos[j], allpos[i]):
            return 1
        return 0

    return np.asarray(sorted(range(n), key=cmp_to_key(cmp)), dtype=np.int64)


ORDERINGS = {
    "unsorted": order_unsorted,
    "lex": order_lex,
    "grayfreq": order_gray_frequency,
    "freqcomp": order_frequent_component,
}


def order_rows(columns, method: str = "lex", hists=None) -> np.ndarray:
    """Row permutation by strategy name; unknown names raise ValueError
    listing the registered row-order strategies."""
    from .strategies import get_strategy  # function-level: no import cycle

    return get_strategy("row_order", method)(columns, hists)
