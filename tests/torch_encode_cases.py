"""Rows for the EWAH encoder (``ops.ewah_encode``), shared by
``test_torch_ewah.py`` (the plain version against ``ewah.compress``) and
``test_torch_cuda.py`` (the kernel against the plain version).  Imports
only numpy and the port.

``CASES`` maps a name to a function that makes a (B, n) uint32 batch:
runs on both sides of each marker limit (clean runs of either type at ``MAX_CLEAN``,
dirty runs at ``MAX_DIRTY``, leading a row or after a clean run), a clean
run right before one of the other type, the lengths 1, ``MAX_DIRTY``,
``MAX_DIRTY`` + 1 and a DBGEN bitmap's 436,812 words, a batch whose rows
would merge runs if a run crossed rows, and all-dirty rows that fill the
capacity ``ewah_torch.stream_capacity(n)`` to within a word.
"""

import numpy as np

from repro_torch.core import ewah

MC, MD = ewah.MAX_CLEAN, ewah.MAX_DIRTY
DBGEN_WORDS = 436_812     # a bitmap of the DBGEN projection's 13,977,980 rows


def dirty(n, rng):
    """n words none of which is clean (0 or all ones)."""
    return rng.integers(1, 0xFFFFFFFF, size=n, dtype=np.uint32)


def clean(n, ctype):
    return np.full(n, 0xFFFFFFFF if ctype else 0, dtype=np.uint32)


def density(n, p, rng):
    return ewah.pack_bits(rng.random(n * ewah.WORD_BITS) < p)


def _clean_run(ctype, n):
    # the run closing a row, then opening one before a dirty word
    return lambda rng: [np.concatenate([dirty(1, rng), clean(n, ctype)]),
                        np.concatenate([clean(n, ctype), dirty(1, rng)])]


def _dirty_run(lead, n):
    if lead:   # the run opens the row, then a clean tail
        return lambda rng: [np.concatenate([dirty(n, rng), clean(3, 0)])]
    return lambda rng: [np.concatenate([clean(5, 1), dirty(n, rng),
                                        clean(MC - 1, 0)]),
                        np.concatenate([clean(MC + 2, 0), dirty(n, rng),
                                        clean(2, 1)])]


def _mixed(n):
    def rows(rng):
        out = density(n, 0.5, rng)
        cut = n // 3
        out[:cut] = density(cut, 0.004, rng)
        return [out]
    return rows


def _rows_apart(rng):
    """Rows that end and begin with the same class: a run crossing rows
    would merge them."""
    n = 2 * MD + 50
    a = np.concatenate([dirty(MD + 7, rng), clean(n - MD - 7, 0)])
    b = np.concatenate([clean(40, 0), dirty(n - 41, rng), clean(1, 1)])
    c = np.concatenate([clean(n - 9, 1), dirty(9, rng)])
    d = np.concatenate([dirty(n - MD, rng), clean(MD, 0)])
    return [a, b, c, d, a]


CASES = {}
for _ctype in (0, 1):
    for _n in (MC - 1, MC, MC + 1, 2 * MC + 3):
        CASES[f"clean{_ctype}_{_n}"] = _clean_run(_ctype, _n)
for _lead in (True, False):
    for _n in (MD - 1, MD, MD + 1, 2 * MD + 1):
        CASES[f"dirty_{'lead' if _lead else 'after_clean'}_{_n}"] = \
            _dirty_run(_lead, _n)
CASES["clean0_then_clean1"] = lambda rng: [
    np.concatenate([clean(MC + 9, 0), clean(2 * MC, 1), dirty(2, rng)])]
CASES["clean1_then_clean0"] = lambda rng: [
    np.concatenate([dirty(3, rng), clean(MC, 1), clean(MC + 1, 0)])]
for _n in (1, MD, MD + 1, DBGEN_WORDS):
    CASES[f"n_{_n}"] = _mixed(_n)
CASES["rows_apart"] = _rows_apart
CASES["all_dirty_full"] = lambda rng: [dirty(2 * MD + 1, rng)]
CASES["all_dirty_one_short"] = lambda rng: [dirty(2 * MD, rng)]


def batch(name, seed=0):
    """The case's rows as one (B, n) batch."""
    return np.stack(CASES[name](np.random.default_rng(seed)))


def overflows(row):
    """Whether ``ewah.compress`` splits a run of ``row``: a clean run
    longer than ``MAX_CLEAN`` or a dirty run longer than ``MAX_DIRTY``."""
    kind = np.where(row == 0, 0, np.where(row == 0xFFFFFFFF, 1, 2))
    edges = np.flatnonzero(np.diff(kind)) + 1
    starts = np.concatenate([[0], edges])
    lengths = np.diff(np.concatenate([starts, [len(row)]]))
    limit = np.where(kind[starts] < 2, MC, MD)
    return bool((lengths > limit).any())
