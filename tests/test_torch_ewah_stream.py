"""The port's dual-cursor AND-popcount walk against the reference's.

``repro_torch.core.ewah_stream.and_popcount`` on ``device="cpu"`` (the
kernel's plain version, ``kernels.ref.ewah_and_popcount``) must give the
reference's ``(count, iterations)`` (``repro.core.ewah_stream.
and_popcount``, a ``lax.while_loop`` on the CPU) on every case of
``tests/test_ewah_stream.py`` and on hand-made streams that reach the
walk's edges: a marker with no words, a length below the array size, and
the iteration cap.  The batched wrapper (``ops.ewah_and_popcount`` over
padded rows with per-pair lengths and array sizes) must equal the
per-pair walk.  Inputs are made with numpy from fixed seeds; counts and
iterations are integers and must be equal (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import random_words
from repro.core import ewah as R_ewah
from repro.core.ewah_stream import and_popcount as ref_and_popcount
from repro_torch.core import ewah
from repro_torch.core.ewah_stream import and_popcount, and_popcount_many
from repro_torch.kernels import ops, ref


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
