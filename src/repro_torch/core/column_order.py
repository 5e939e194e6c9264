"""Column-ordering gain model and heuristic (paper §4.3, Figs. 3-4)."""

from __future__ import annotations

import numpy as np

from .ewah import WORD_BITS


def expected_dirty_words(r: float, L: float, n: float, w: int = WORD_BITS) -> float:
    """delta(r, L, n): expected dirty words of L bitmaps x n rows holding r
    randomly scattered 1-bits (paper §4.3)."""
    return (1.0 - (1.0 - r / (L * n)) ** w) * (L * n) / w


def sorted_column_cost(n_i: int, k: int) -> float:
    """Storage cost of a sorted column (Prop. 2 bound): 4*n_i + ceil(k*n_i^(1/k))."""
    return 4.0 * n_i + np.ceil(k * n_i ** (1.0 / k))


def shuffled_column_cost(n: int, n_i: int, k: int, w: int = WORD_BITS) -> float:
    """Approximate storage cost of a randomly shuffled column: 2*delta + L."""
    L = np.ceil(k * n_i ** (1.0 / k))
    return 2.0 * expected_dirty_words(k * n, L, n, w) + L


def column_gain(n: int, n_i: int, k: int, w: int = WORD_BITS) -> float:
    """Expected words saved by sorting one column (Fig. 3):
    2*delta(kn, ceil(k*n_i^(1/k)), n) - 4*n_i."""
    L = np.ceil(k * n_i ** (1.0 / k))
    return 2.0 * expected_dirty_words(k * n, L, n, w) - 4.0 * n_i


def heuristic_score(n_i: int, k: int, w: int = WORD_BITS) -> float:
    """Paper §4.3 ordering score: min(n_i^(-1/k), (1 - n_i^(-1/k)) / (4w - 1)).

    Maximal at density n_i^(-1/k) = 1/(4w); decays to 0 as density -> 1
    (too dense: sorting can't help) and as density -> 0 (too sparse: the
    column is almost all clean anyway)."""
    d = float(n_i) ** (-1.0 / k)
    return min(d, (1.0 - d) / (4.0 * w - 1.0))


def order_columns(cardinalities, k: int, w: int = WORD_BITS) -> np.ndarray:
    """Column order: decreasing heuristic score (first column = primary key)."""
    scores = np.asarray([heuristic_score(c, k, w) for c in cardinalities])
    return np.argsort(-scores, kind="stable")
