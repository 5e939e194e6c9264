"""Seeded synthetic tables with the shape statistics of the paper's data
sets: row count, column cardinalities and skew (uniform for DBGEN's
near-uniform TPC-H columns, Zipf for Census-Income's skewed ones).

The column generators are copies of ``repro_torch.data.tables``
(``zipf_column``, ``uniform_column``), frozen here.
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


def make_table(config: dict, rng) -> list:
    """The columns of ``config["columns"]`` (``card``, ``dist`` of
    ``uniform`` or ``zipf`` with its ``skew``) over ``config["rows"]``
    rows, in one pass of ``rng``."""
    n = int(config["rows"])
    cols = []
    for c in config["columns"]:
        if c["dist"] == "uniform":
            cols.append(uniform_column(n, int(c["card"]), rng))
        elif c["dist"] == "zipf":
            cols.append(zipf_column(n, int(c["card"]), float(c["skew"]), rng))
        else:
            raise ValueError(f"unknown column distribution {c['dist']!r}")
    return cols
