"""Stream pairs for the AND-popcount walk's wide route, shared by
``test_torch_ewah_stream.py`` (CPU, against the reference) and
``test_torch_cuda.py`` (the card).  Imports only numpy and the port.

Each case is ``(sa, la, sb, lb)``: two EWAH streams (uint32) and their
lengths; the array sizes are the streams' own.  All rows are wider than
``SHORT_WIDTH``, so a batch of them takes the two-launch route.
"""

import numpy as np

from repro_torch.core import ewah


def dirty_words(n, rng):
    """n words none of which is clean (0 or all ones)."""
    return rng.integers(1, 0xFFFFFFFF, size=n, dtype=np.uint32)


def equality_words(n_rows, card, value, rng):
    """The equality bitmap of ``value`` over a uniform column: the SF 1
    cross-tab's bitmaps at a smaller scale (mostly dirty, a marker every
    few dozen words)."""
    col = rng.integers(0, card, size=n_rows)
    return ewah.positions_to_words(np.flatnonzero(col == value), n_rows)


def mixed_words(n, rng, p_clean=0.5, longest=40):
    """Runs of zeros, ones and dirty words, 1 to ``longest`` words long."""
    kinds = rng.integers(0, 3, size=n)
    kinds[rng.random(kinds.size) >= p_clean * 1.5] = 2
    reps = rng.integers(1, longest + 1, size=kinds.size)
    kind = np.repeat(kinds, reps)[:n]
    words = dirty_words(n, rng)
    words[kind == 0] = 0
    words[kind == 1] = 0xFFFFFFFF
    return words


def long_pairs():
    """Pairs of 40,000-80,000 words: a dirty run split at MAX_DIRTY, a
    clean run split at MAX_CLEAN, unequal word totals, equality bitmaps,
    mixed runs, a clean run against many markers, and last an empty marker
    (which ends its stream's walk)."""
    rng = np.random.default_rng(19)
    out = []

    def add(a, b):
        sa, sb = ewah.compress(a), ewah.compress(b)
        out.append((sa, len(sa), sb, len(sb)))

    # one dirty run of 50,000 words: markers of 32,767 and 17,233
    add(dirty_words(50_000, rng), mixed_words(50_000, rng))
    # 70,000 clean words (65,535 + 4,465) against ones and dirty words
    a = np.concatenate([np.zeros(70_000, np.uint32), dirty_words(5_000, rng)])
    b = np.concatenate([np.full(66_000, 0xFFFFFFFF, np.uint32),
                        mixed_words(9_000, rng)])
    add(a, b)
    b = np.full(75_000, 0xFFFFFFFF, np.uint32)
    b[1000:1500] = dirty_words(500, rng)
    add(b, a)
    # unequal word totals: the walk stops at the shorter
    add(mixed_words(60_000, rng), mixed_words(45_000, rng))
    add(mixed_words(40_000, rng, 0.9), dirty_words(80_000, rng))
    # equality bitmaps of a 7- and an 11-value column, 1.6M rows
    n_rows = 1_600_000
    add(equality_words(n_rows, 7, 3, rng), equality_words(n_rows, 11, 5, rng))
    # one tile of A's positions spans 70,000 words, over which B has more
    # markers than the tile kernel stages (it searches B's table instead)
    a = np.concatenate([np.zeros(70_000, np.uint32), dirty_words(8_000, rng)])
    add(a, mixed_words(78_000, rng, 0.6, 3))
    # an empty marker inside a stream: the walk ends there
    s = ewah.compress(mixed_words(50_000, rng))
    cut = next(i for i in range(len(s) // 2, len(s))
               if _is_marker(s, i))
    sa = np.concatenate([s[:cut], np.zeros(1, np.uint32), s[cut:]])
    sb = ewah.compress(mixed_words(50_000, rng))
    out.append((sa, len(sa), sb, len(sb)))
    return out


def _is_marker(s, i):
    p = 0
    while p < i:
        p += 1 + int(s[p] & 0x7FFF)
    return p == i


def edge_pairs():
    """Wide pairs that are not well formed, so the wide route walks them
    serially: a length past the array (reads clamp to the array's last
    word), a length that cuts a marker's dirty run, and an empty stream."""
    rng = np.random.default_rng(23)
    a = ewah.compress(mixed_words(1_500, rng))
    b = ewah.compress(mixed_words(1_500, rng))
    d = ewah.compress(dirty_words(1_400, rng))          # one marker
    return [
        (a, len(a) + 3, b, len(b)),                     # length > size
        (d, len(d) - 100, b, len(b)),                   # dirty run cut
        (a, len(a), d, 700),                            # cut on B's side
        (a, 0, b, len(b)),                              # empty stream
        (a, len(a), b, len(b)),                         # well formed
    ]
