"""The port's dual-cursor AND-popcount walk against the reference's.

``repro_torch.core.ewah_stream.and_popcount`` on ``device="cpu"`` (the
kernel's plain version, ``kernels.ref.ewah_and_popcount``) must give the
reference's ``(count, iterations)`` (``repro.core.ewah_stream.
and_popcount``, a ``lax.while_loop`` on the CPU) on every case of
``tests/test_ewah_stream.py`` and on hand-made streams that reach the
walk's edges: a marker with no words, a length below the array size, and
the iteration cap.  The batched wrapper (``ops.ewah_and_popcount`` over
padded rows with per-pair lengths and array sizes) must equal the
per-pair walk.

The wide route's phase plain versions (``ref.ewah_pair_chain`` then
``ref.ewah_pair_tiles``, the sum over stream positions) must give the
reference's pair on the same 25 cases, on long pairs of 40,000-80,000
words (``tests/torch_pair_cases.py``) and on pairs that are not well
formed (walked serially); ``ops.ewah_and_popcount`` must take the step
walk up to ``SHORT_WIDTH`` and the phases past it.  The step walk syncs
with the host every step, so it runs at small sizes only.  Inputs are
made with numpy from fixed seeds; counts and iterations are integers and
must be equal (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import random_words
from repro.core import ewah as R_ewah
from repro.core.ewah_stream import and_popcount as ref_and_popcount
from repro_torch.core import ewah
from repro_torch.core.ewah_stream import (and_popcount, and_popcount_many,
                                          pack_pairs)
from repro_torch.kernels import ewah_and_popcount as launcher
from repro_torch.kernels import ops, ref
from torch_pair_cases import edge_pairs, long_pairs


def reference(sa, la, sb, lb):
    count, iters = ref_and_popcount(jnp.asarray(sa), la, jnp.asarray(sb), lb)
    return int(count), int(iters)


def sparse_pair():
    n = 100_000
    a = np.zeros(n, dtype=np.uint32)
    b = np.zeros(n, dtype=np.uint32)
    a[5000:5010] = 0xDEADBEEF
    b[5005:5020] = 0xFFFFFFFF
    return a, b


def word_pairs():
    """The uncompressed word pairs of tests/test_ewah_stream.py."""
    out = [(random_words(n, seed=s), random_words(n, seed=s + 77))
           for s in range(5) for n in (10, 100, 1000)]
    out.append(sparse_pair())
    ones = np.full(320, 0xFFFFFFFF, dtype=np.uint32)
    out.append((ones, ones.copy()))
    out.append((R_ewah.positions_to_words(np.arange(0, 1000, 2), 1000),
                R_ewah.positions_to_words(np.arange(1, 1000, 2), 1000)))
    return out


PAIRS = word_pairs()


@pytest.mark.parametrize("case", range(len(PAIRS)))
def test_and_popcount_matches_reference(case):
    a, b = PAIRS[case]
    sa, sb = ewah.compress(a), ewah.compress(b)
    np.testing.assert_array_equal(sa, R_ewah.compress(a))
    got = and_popcount(sa, len(sa), sb, len(sb), device="cpu")
    assert got == reference(sa, len(sa), sb, len(sb))
    assert got[0] == int(np.bitwise_count(a & b).sum())
    assert got[1] <= len(sa) + len(sb) + 4


def edge_streams():
    """(sa, la, sb, lb) the walk's edges reach: the reference's cap and
    clamps use each array's own size, and a marker with no clean and no
    dirty word ends its walk."""
    a = ewah.compress(random_words(300, seed=9))
    b = ewah.compress(random_words(300, seed=10))
    zero_marker = np.concatenate([a[:1] * 0, a])        # ends at once
    mid_zero = np.concatenate([a[:2], np.zeros(1, np.uint32), a[2:]])
    capped = np.asarray([ewah.make_marker(1, 60000, 0)], dtype=np.uint32)
    return [
        (a, len(a), b, len(b)),
        (zero_marker, len(zero_marker), b, len(b)),
        (mid_zero, len(mid_zero), b, len(b)),
        (a, len(a) // 2, b, len(b)),                     # length < size
        (a, len(a) + 3, b, len(b)),                      # reads clamp
        (capped, 1, capped, 1),                          # one overlap step
        (a, len(a), capped, 1),
    ]


@pytest.mark.parametrize("case", range(7))
def test_and_popcount_edges_match_reference(case):
    sa, la, sb, lb = edge_streams()[case]
    assert and_popcount(sa, la, sb, lb, device="cpu") == \
        reference(sa, la, sb, lb)


def test_iteration_cap_uses_each_array_size():
    """Dirty counts that promise more words than the arrays hold: the
    walk stops at size(A) + size(B) + 4 steps, as the reference's does,
    and padding the batch to a wider row does not move the cap."""
    sa = np.asarray([ewah.make_marker(0, 0, 0x7FFF)] + [0xF0F0F0F0] * 5,
                    dtype=np.uint32)
    sb = np.asarray([ewah.make_marker(0, 0, 0x7FFF)] + [0xFFFFFFFF] * 9,
                    dtype=np.uint32)
    want = reference(sa, len(sa), sb, len(sb))
    assert want[1] == len(sa) + len(sb) + 4
    wide = np.zeros(64, dtype=np.uint32)
    counts, iters = and_popcount_many(
        [(sa, len(sa), sb, len(sb)), (wide, 0, wide, 0)], device="cpu")
    assert (int(counts[0]), int(iters[0])) == want
    assert (int(counts[1]), int(iters[1])) == (0, 0)


def test_batched_wrapper_equals_per_pair_walks():
    streams = [ewah.compress(a) for pair in PAIRS for a in pair]
    pairs = [(streams[i], len(streams[i]), streams[i + 1],
              len(streams[i + 1])) for i in range(0, len(streams), 2)]
    pairs += edge_streams()
    counts, iters = and_popcount_many(pairs, device="cpu")
    for k, p in enumerate(pairs):
        assert (int(counts[k]), int(iters[k])) == \
            and_popcount(*p, device="cpu")


def test_ops_wrapper_takes_padded_rows_and_sizes():
    """ops.ewah_and_popcount on int32 rows: a pair's own array size sets
    its cap and clamp whatever the row width; sizes past the width are cut
    to it."""
    a = ewah.compress(random_words(500, seed=3))
    b = ewah.compress(random_words(500, seed=4))
    want = and_popcount(a, len(a), b, len(b), device="cpu")
    C = max(len(a), len(b)) + 17
    sa = np.zeros((2, C), dtype=np.uint32)
    sb = np.zeros((2, C), dtype=np.uint32)
    sa[:, : len(a)] = a
    sb[:, : len(b)] = b
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x).view(np.int32))
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)
    count, iters = ops.ewah_and_popcount(
        t(sa), i32(len(a), len(a)), i32(len(a), C + 100),
        t(sb), i32(len(b), len(b)), i32(len(b), C + 100))
    assert (int(count[0]), int(iters[0])) == want
    assert (int(count[1]), int(iters[1])) == reference(
        sa[1], len(a), sb[1], len(b))
    with pytest.raises(ValueError):
        ops.ewah_and_popcount(t(sa), i32(1), i32(1), t(sb), i32(1, 1),
                              i32(1, 1))


def test_and_popcount_needs_a_card_by_default():
    a = ewah.compress(random_words(10, seed=1))
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        and_popcount(a, len(a), a, len(a))


def test_popcount_of_int32_views():
    words = np.asarray([0, 1, 0xFFFFFFFF, 0x80000000, 0xDEADBEEF,
                        0x7FFFFFFF], dtype=np.uint32)
    got = ref.popcount(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.bitwise_count(words))


def phased(pairs):
    """(count, iterations) of ``pairs`` by the wide route's phase plain
    versions, whatever the batch's width."""
    sa, la, na, sb, lb, nb = pack_pairs(pairs, "cpu")
    N, T = launcher.N_WORDS, launcher.TILE
    count, iters = ref.ewah_pair_tiles(
        sa, la, na, sb, lb, nb, ref.ewah_pair_chain(sa, la, N, T),
        ref.ewah_pair_chain(sb, lb, N, T), N)
    return [(int(c), int(i)) for c, i in zip(count, iters)]


def small_cases():
    """The 25 cases above: the word pairs' streams and the edge streams."""
    out = []
    for a, b in PAIRS:
        sa, sb = ewah.compress(a), ewah.compress(b)
        out.append((sa, len(sa), sb, len(sb)))
    return out + edge_streams()


@pytest.mark.parametrize("case", range(25))
def test_phase_plain_versions_match_reference(case):
    pair = small_cases()[case]
    assert phased([pair]) == [reference(*pair)]


LONG = long_pairs()


@pytest.mark.parametrize("case", range(len(LONG)))
def test_phase_plain_versions_on_long_pairs(case):
    """40,000-80,000 words a stream: a dirty run split at MAX_DIRTY, a
    clean run split at MAX_CLEAN, unequal word totals, equality bitmaps,
    an empty marker."""
    pair = LONG[case]
    assert phased([pair]) == [reference(*pair)]
    a, b = ewah.decompress(pair[0]), ewah.decompress(pair[2])
    n = min(len(a), len(b))
    if case != len(LONG) - 1:  # the empty marker ends its walk early
        assert phased([pair])[0][0] == int(np.bitwise_count(a[:n] & b[:n])
                                           .sum()) & 0xFFFFFFFF


def test_long_cases_reach_the_split_runs():
    """The long cases hold what their docstring promises."""
    markers = [ewah.unpack_marker(w) for w in LONG[0][0][:1]]
    assert markers[0][2] == ewah.MAX_DIRTY
    assert ewah.unpack_marker(LONG[1][0][0]) == (0, ewah.MAX_CLEAN, 0)
    totals = [len(ewah.decompress(LONG[3][k])) for k in (0, 2)]
    assert totals == [60_000, 45_000]
    assert 0 in LONG[-1][0].tolist()


EDGES = edge_pairs()


@pytest.mark.parametrize("case", range(len(EDGES)))
def test_wide_route_walks_pairs_that_are_not_well_formed(case):
    """In one batch wider than SHORT_WIDTH: a length past the array, a
    dirty run cut by the length (either side) and an empty stream go to
    the step walk inside the route, and match the reference."""
    args = pack_pairs(EDGES, "cpu")
    assert not launcher.is_short(args[0], args[3])
    count, iters = ops.ewah_and_popcount(*args)
    assert (int(count[case]), int(iters[case])) == reference(*EDGES[case])
    N = launcher.N_WORDS
    meta_a = ref.ewah_pair_chain(args[0], args[1], N, launcher.TILE)[2]
    meta_b = ref.ewah_pair_chain(args[3], args[4], N, launcher.TILE)[2]
    over = bool(meta_a[case, 2]) or bool(meta_b[case, 2])
    assert over == (case in (1, 2))


@pytest.mark.parametrize("extra", [0, 1])
def test_ops_routes_at_the_short_width(extra, monkeypatch):
    """Rows of SHORT_WIDTH words take the step walk, one word more the
    phases; both give the reference's pairs."""
    pairs = small_cases()[:10]
    width = launcher.SHORT_WIDTH + extra
    sa, la, na, sb, lb, nb = pack_pairs(pairs, "cpu")
    pad = lambda s: torch.nn.functional.pad(s, (0, width - s.shape[1]))
    calls = []
    for name in ("ewah_and_popcount", "ewah_pair_chain"):
        fn = getattr(ref, name)
        monkeypatch.setattr(ref, name, lambda *a, fn=fn, name=name: (
            calls.append(name), fn(*a))[1])
    count, iters = ops.ewah_and_popcount(pad(sa), la, na, pad(sb), lb, nb)
    assert calls[0] == ("ewah_pair_chain" if extra else "ewah_and_popcount")
    got = [(int(c), int(i)) for c, i in zip(count, iters)]
    assert got == [reference(*p) for p in pairs]


def serial_chain(s, length, tile):
    """ewah_pair_chain's meta and ptile by a walk over the markers."""
    pos, off, empty, over, spans = 0, 0, None, 0, []
    while pos < length:
        w = int(s[pos])
        t, nc, nd = ewah.unpack_marker(w)
        eff = min(nd, length - pos - 1)
        if nc == 0 and nd == 0 and empty is None:
            empty = off
        over |= nd > length - pos - 1
        spans.append((pos, pos + 1 + eff))
        off += nc + eff
        pos += 1 + nd
    W = off if empty is None else min(empty, off)
    ptile = []
    for start in range(0, len(s), tile):
        hit = [k for k, (a, z) in enumerate(spans) if a <= start < z]
        ptile.append(hit[0] if hit else -1)
    return [len(spans), W, int(over)], ptile


@pytest.mark.parametrize("which", ["long", "edge"])
def test_pair_chain_tables_match_a_marker_walk(which):
    """ref.ewah_pair_chain's count, W, dirty-run flag and tile markers,
    with a small tile, against a plain walk over each stream's markers."""
    pairs = LONG if which == "long" else EDGES
    sa, la, _, sb, lb, _ = pack_pairs(pairs, "cpu")
    for s, lengths in ((sa, la), (sb, lb)):
        tab, wtab, meta, ptile = ref.ewah_pair_chain(s, lengths,
                                                     launcher.N_WORDS, 1024)
        for r in range(s.shape[0]):
            row = s[r].numpy().view(np.uint32)
            want_meta, want_ptile = serial_chain(row, int(lengths[r]), 1024)
            assert meta[r].tolist() == want_meta
            assert ptile[r].tolist() == want_ptile
            k = int(meta[r, 0])
            np.testing.assert_array_equal(
                wtab[r, :k].numpy(), s[r].numpy()[tab[r, :k, 0].numpy()])
