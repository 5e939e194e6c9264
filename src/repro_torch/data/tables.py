"""Synthetic tables mirroring the paper's data sets (Table 2 profiles).

The four originals (Census-Income, DBGEN, Netflix, KJV-4grams) are not
redistributable offline; these generators match their published shape
statistics — row counts (scaled), column cardinalities and skew — so the
paper's qualitative claims can be validated (DESIGN.md §8).
"""

from __future__ import annotations

import numpy as np


def zipf_column(n: int, card: int, skew: float, rng) -> np.ndarray:
    """Zipf-distributed value ids (0-based, dense)."""
    ranks = np.arange(1, card + 1, dtype=np.float64)
    probs = ranks ** -skew
    probs /= probs.sum()
    return rng.choice(card, size=n, p=probs).astype(np.int64)


def uniform_column(n: int, card: int, rng) -> np.ndarray:
    return rng.integers(0, card, size=n).astype(np.int64)


def make_uniform_table(n: int, cards, seed=0):
    rng = np.random.default_rng(seed)
    return [uniform_column(n, c, rng) for c in cards]


def make_zipf_table(n: int, cards, skews, seed=0):
    rng = np.random.default_rng(seed)
    return [zipf_column(n, c, s, rng) for c, s in zip(cards, skews)]


def make_census_like(n: int = 199_523, seed=0):
    """Census-Income 4-d projection: cardinalities 91, 1240, 1478, 99800;
    real census columns are moderately skewed."""
    rng = np.random.default_rng(seed)
    cards = [91, 1240, 1478, min(99_800, n // 2)]
    skews = [1.0, 1.1, 1.3, 0.4]
    return [zipf_column(n, c, s, rng) for c, s in zip(cards, skews)]


def make_dbgen_like(n: int = 1_000_000, seed=1):
    """DBGEN 4-d projection: cardinalities 7, 11, 2526, 400000 (scaled);
    TPC-H columns are near-uniform."""
    rng = np.random.default_rng(seed)
    cards = [7, 11, 2526, min(400_000, max(1000, n // 35))]
    return [uniform_column(n, c, rng) for c in cards]


def make_netflix_like(n: int = 2_000_000, seed=2):
    """Netflix: Rating(5), MovieID(17770), Date(2182), UserID(480189 scaled).

    Ratings and movie popularity are skewed; user activity long-tailed."""
    rng = np.random.default_rng(seed)
    cards = [5, 2182, 17_770, min(480_189, max(10_000, n // 20))]
    skews = [0.7, 0.9, 1.1, 0.8]
    return [zipf_column(n, c, s, rng) for c, s in zip(cards, skews)]


def make_kjv4grams_like(n: int = 4_000_000, seed=3, pool: int = 200_000):
    """KJV-4grams: 4 word columns (~8k stems each) with HEAVY row
    duplication — rows drawn from a zipf-weighted pool of distinct 4-tuples
    (the bible text repeats n-grams), which is what makes sorting pay off
    ~9x on this data set."""
    rng = np.random.default_rng(seed)
    cols = 4
    card = 8_000
    pool_rows = np.stack(
        [zipf_column(pool, card, 1.1, rng) for _ in range(cols)], axis=1)
    pick = zipf_column(n, pool, 1.05, rng)
    rows = pool_rows[pick]
    return [rows[:, j].copy() for j in range(cols)]


DATASETS = {
    "census": make_census_like,
    "dbgen": make_dbgen_like,
    "netflix": make_netflix_like,
    "kjv4grams": make_kjv4grams_like,
}
