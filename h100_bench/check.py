"""Decide ``correct``: the answers the window produced against the plain
reference, once the window has closed.

Every number compared has a limit; a run is correct when each lies within
it.  All comparisons are exact, so every limit is 0 (or, for the count of
answers checked, at least 1):

``missing``        answers the program never returned, of all attempted;
``bad_row_order``  1 where the index's row order is not a permutation of
                   the table's rows;
``wrong``          sampled answers whose rows differ from the reference's,
                   or whose stream does not describe exactly the bitmap's
                   words;
``noncanonical``   sampled EWAH answers with the right rows in a stream
                   that is not the canonical one of the words it
                   describes (``compressed`` entry).

The bits of the last word past the table's last row are padding: they
are no rows, and the format leaves them free (the port's own
``EwahStream.count`` masks them).  An answer is judged by its rows; its
stream must be the canonical one of its own words, padding included.
``checked``        sampled answers compared.
"""

from __future__ import annotations

import numpy as np

from .reference import evaluate, ewah

MAX_NAMED = 3   # failing answers named in the result, for the record

LIMITS = {"missing": ("<=", 0), "bad_row_order": ("<=", 0),
          "wrong": ("<=", 0), "noncanonical": ("<=", 0),
          "checked": (">=", 1)}


def compare(samples, cols, row_perm, n_rows: int, entry: str,
            missing: int) -> dict:
    """``samples``: (predicate tuple, answer) pairs; ``cols``: the generated
    columns in table order; ``row_perm``: the index's row order, checked
    here, not trusted.  Returns ({name: value}, the first failing answers
    named: "<number>: <predicate>")."""
    row_perm = np.asarray(row_perm)
    perm_ok = (len(row_perm) == n_rows and np.array_equal(
        np.sort(row_perm), np.arange(n_rows)))
    out = {"missing": int(missing), "bad_row_order": int(not perm_ok),
           "wrong": 0, "checked": len(samples)}
    if entry == "compressed":
        out["noncanonical"] = 0
    named = []

    def fail(number, pred):
        out[number] += 1
        if len(named) < MAX_NAMED:
            named.append(f"{number}: {pred!r}"[:300])

    if not perm_ok:
        out["wrong"] = len(samples)
        return out, named
    in_index_order = [c[row_perm] for c in cols]
    n_words = (n_rows + 31) // 32
    for pred, answer in samples:
        want = evaluate.mask(pred, in_index_order)
        if entry == "rows":
            got = np.sort(np.asarray(answer, dtype=np.int64))
            if not np.array_equal(got, np.flatnonzero(want)):
                fail("wrong", pred)
            continue
        want_words = ewah.pack(want)
        try:
            got_words = ewah.decode(answer, n_words)
        except ewah.MalformedStream:
            fail("wrong", pred)
            continue
        if not np.array_equal(ewah.rows_only(got_words, n_rows),
                              want_words):
            fail("wrong", pred)
        elif not np.array_equal(np.asarray(answer, dtype=np.uint32),
                                ewah.encode(got_words)):
            fail("noncanonical", pred)
    return out, named


def verdict(numbers: dict) -> tuple:
    """(correct, {name: {"value", "limit", "rule"}}) in a fixed order."""
    table, ok = {}, True
    for name, (rule, limit) in LIMITS.items():
        if name not in numbers:
            continue
        v = numbers[name]
        ok &= v <= limit if rule == "<=" else v >= limit
        table[name] = {"value": v, "rule": rule, "limit": limit}
    return bool(ok), table
