"""The reference's EWAH codec and dense evaluator against hand-worked
cases, and the roofline's byte count from stream lengths alone."""

import numpy as np
import pytest

from h100_bench.tests import helpers_h100bench  # noqa: F401 (sys.path)
from h100_bench import roofline
from h100_bench.reference import evaluate, ewah

F = 0xFFFFFFFF


def m(ctype, n_clean, n_dirty):
    return (ctype << 31) | (n_clean << 15) | n_dirty


@pytest.mark.parametrize("words, stream", [
    ([0, 0, 0, 5, F, F, 7], [m(0, 3, 1), 5, m(1, 2, 1), 7]),
    ([5, 6], [m(0, 0, 2), 5, 6]),
    ([0, 0, F], [m(0, 2, 0), m(1, 1, 0)]),
    ([F], [m(1, 1, 0)]),
    ([9, 0, 9], [m(0, 0, 1), 9, m(0, 1, 1), 9]),
])
def test_encode_decode_hand_cases(words, stream):
    got = ewah.encode(np.asarray(words, dtype=np.uint32))
    assert got.tolist() == stream
    assert ewah.decode(np.asarray(stream, dtype=np.uint32),
                       len(words)).tolist() == words


def test_counts_overflow_into_further_markers():
    words = np.zeros(ewah.MAX_CLEAN + 10, dtype=np.uint32)
    words[-3:] = 3
    got = ewah.encode(words)
    assert got.tolist() == [m(0, ewah.MAX_CLEAN, 0), m(0, 7, 3), 3, 3, 3]
    dirty = np.full(ewah.MAX_DIRTY + 2, 5, dtype=np.uint32)
    got = ewah.encode(dirty)
    assert got[0] == m(0, 0, ewah.MAX_DIRTY)
    assert got[ewah.MAX_DIRTY + 1] == m(0, 0, 2)
    assert np.array_equal(ewah.decode(got, len(dirty)), dirty)


@pytest.mark.parametrize("stream, n", [
    ([m(0, 3, 0)], 2),            # describes more words
    ([m(0, 1, 0)], 2),            # describes fewer
    ([m(0, 0, 2), 5], 2),         # verbatim words past the stream's end
])
def test_decode_rejects_malformed(stream, n):
    with pytest.raises(ewah.MalformedStream):
        ewah.decode(np.asarray(stream, dtype=np.uint32), n)


def test_block_stream_decodes_alike_but_is_not_canonical():
    words = np.zeros(3000, dtype=np.uint32)
    words[1500] = 1
    blocks = ewah.encode_blocks(words, block=1024)
    assert np.array_equal(ewah.decode(blocks, 3000), words)
    assert not np.array_equal(blocks, ewah.encode(words))


def test_pack_and_rows():
    mask = np.zeros(70, dtype=bool)
    mask[[0, 31, 32, 69]] = True
    words = ewah.pack(mask)
    assert words.tolist() == [1 | (1 << 31), 1, 1 << 5]
    assert ewah.rows_of(words, 70).tolist() == [0, 31, 32, 69]
    assert ewah.rows_of(np.asarray([F, F, F], np.uint32), 70)[-1] == 69


def test_dense_evaluator_hand_table():
    cols = [np.array([0, 1, 2, 1, 0]), np.array([5, 6, 7, 8, 9])]
    assert evaluate.mask(("eq", 0, 1), cols).tolist() == [0, 1, 0, 1, 0]
    assert evaluate.mask(("in", 1, [5, 9]), cols).tolist() == [1, 0, 0, 0, 1]
    assert evaluate.mask(("range", 1, 6, 8), cols).tolist() == [0, 1, 1, 1, 0]
    assert evaluate.mask(("not", ("eq", 0, 0)), cols).tolist() == [
        0, 1, 1, 1, 0]
    p = ("or", [("and", [("eq", 0, 1), ("range", 1, 7, 9)]),
                ("eq", 1, 5)])
    assert evaluate.mask(p, cols).tolist() == [1, 0, 0, 1, 0]
    with pytest.raises(ValueError):
        evaluate.mask(("like", 0, 1), cols)


def test_roofline_counts_stream_lengths_only():
    assert roofline.needed_bytes([3, 5], [2]) == 40
    assert roofline.rowid_answer_words(1_000_000) == 31_250
    assert roofline.rowid_answer_words(33) == 2
    nbytes = roofline.needed_bytes([31_250] * 10, [31_250])
    assert roofline.share_percent(nbytes, nbytes / roofline.HBM_BYTES_PER_S
                                  ) == pytest.approx(100.0)
    assert roofline.share_percent(nbytes, 0.0) is None
