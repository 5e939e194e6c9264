"""Row-id answers: ``ops.rowids`` and the row-id entry of ``TorchBackend``.

* ``ops.rowids`` and its two phases (``rowid_counts``, ``rowid_write``),
  plain versions on the CPU, against ``np.flatnonzero(ewah.unpack_bits(
  words, n_rows))`` answer by answer: empty answers, all ones (the padding
  bits past the last row set too), random words and a batch of three
  answers of different densities, at row counts on both sides of a word
  and of a tile;
* ``TorchBackend(device="cpu").execute_many`` against
  ``NumpyBackend.execute``: empty and full answers, a ``Not`` (whose
  padding bits are set in the answer words), one group of three answers,
  int64 ids in ascending order, and the two counters under tracing.

The kernels themselves run only on the card: ``tests/test_torch_cuda.py``
holds them against these plain versions.
"""

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core import (And, BitmapIndex, Eq, IndexSpec, Not, Or,
                              ewah)
from repro_torch.core.query import NumpyBackend, TorchBackend, compile_plan
from repro_torch.kernels import ops
from repro_torch.kernels import rowids as kr

ROWS = (1, 31, 32, 33, 1_025, 40_003)


def answer_words(kind, n_rows, seed=30):
    """(B, W) uint32 answer words of one kind."""
    W = -(-n_rows // ewah.WORD_BITS)
    r = np.random.default_rng(seed + n_rows)
    if kind == "empty":
        return np.zeros((1, W), dtype=np.uint32)
    if kind == "ones":
        return np.full((1, W), 0xFFFFFFFF, dtype=np.uint32)
    if kind == "random":
        return r.integers(0, 2**32, size=(1, W), dtype=np.uint32)
    # three answers of densities 0.9, 0.3 and 0.01, padding bits set
    bits = r.random((3, W * ewah.WORD_BITS)) < np.array([[0.9], [0.3],
                                                         [0.01]])
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)


def flatnonzero(words, n_rows):
    return [np.flatnonzero(ewah.unpack_bits(w, n_rows)) for w in words]


@pytest.mark.parametrize("kind", ["empty", "ones", "random", "three"])
@pytest.mark.parametrize("n_rows", ROWS)
def test_plain_rowids_match_flatnonzero(kind, n_rows):
    words = answer_words(kind, n_rows)
    want = flatnonzero(words, n_rows)
    ids, totals = ops.rowids(torch.from_numpy(words.view(np.int32)), n_rows)
    assert ids.dtype == torch.int64 and totals.dtype == torch.int64
    assert totals.tolist() == [len(w) for w in want]
    np.testing.assert_array_equal(ids.numpy(), np.concatenate(want))
    for w in want:
        assert np.all(np.diff(w) > 0)
        assert len(w) == 0 or w[-1] < n_rows


@pytest.mark.parametrize("n_rows", ROWS)
def test_plain_offsets_are_each_tiles_start(n_rows):
    """``rowid_counts``' offsets: where each tile's ids start in the flat
    output, answers back to back."""
    words = answer_words("three", n_rows)
    offsets, totals = ops.rowid_counts(
        torch.from_numpy(words.view(np.int32)), n_rows)
    B, W = words.shape
    assert tuple(offsets.shape) == (B, kr.n_tiles(W))
    counts = [len(w) for w in flatnonzero(words, n_rows)]
    base = 0
    for b in range(B):
        rows = flatnonzero(words[b: b + 1], n_rows)[0]
        for t in range(kr.n_tiles(W)):
            first_row = t * kr.TILE * ewah.WORD_BITS
            assert offsets[b, t] == base + np.searchsorted(rows, first_row)
        base += counts[b]
    assert totals.tolist() == counts


def test_rowids_rejects_what_the_kernels_cannot_take():
    words = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.rowids(words, 3 * 32 + 1)
    with pytest.raises(ValueError):
        ops.rowids(words[0], 3)
    with pytest.raises(TypeError):
        ops.rowids(words.to(torch.int64), 3)
    with pytest.raises(ValueError):
        ops.rowid_write(words, 3, torch.zeros(2, 2, dtype=torch.int64), 0)


# -- the backend's row-id entry -------------------------------------------


def index_of(n_rows, seed=31):
    """Two columns: a skewed one of 4 values (densities about 0.7, 0.2,
    0.08 and 0.02) and a uniform one of 5, rows unsorted so that answers
    scatter."""
    r = np.random.default_rng(seed)
    skewed = np.searchsorted([0.7, 0.9, 0.98], r.random(n_rows))
    cols = [skewed, r.integers(0, 5, n_rows)]
    return BitmapIndex.build(cols, IndexSpec(row_order="unsorted",
                                             column_order="given"))


def backend_predicates():
    return {"empty": And(Eq(0, 0), Eq(0, 1)),
            "full": Or(*(Eq(1, v) for v in range(5))),
            "not": Not(Eq(1, 2)),
            "mixed": And(Not(Eq(0, 1)), Or(Eq(1, 0), Eq(1, 4)))}


@pytest.mark.parametrize("n_rows", ROWS)
def test_backend_rows_entry_matches_numpy(n_rows):
    idx = index_of(n_rows)
    preds = backend_predicates()
    plans = [compile_plan(idx, p) for p in preds.values()]
    want = [NumpyBackend().execute(p)[0] for p in plans]
    be = TorchBackend(device="cpu", cache_size=0)
    tracing.enable()
    tracing.reset()
    try:
        got = be.execute_many(plans)
        counters = tracing.snapshot()["counters"]
    finally:
        tracing.enable(False)
        tracing.reset()
    for (rows, scanned), w, p in zip(got, want, plans):
        assert isinstance(rows, np.ndarray) and rows.dtype == np.int64
        np.testing.assert_array_equal(rows, w)
        assert np.all(np.diff(rows) > 0)
        assert scanned == p.leaf_words()
    assert counters["backend.rowid_answers"] == len(plans)
    assert counters["backend.rowid_bytes"] == 8 * sum(len(w) for w in want)
    full = list(preds).index("full")
    assert len(got[full][0]) == n_rows


def test_one_group_of_three_answers_of_different_densities():
    """Three plans of one shape share one device program and one copy of
    ids; each answer is its slice of it."""
    idx = index_of(40_003)
    preds = [Eq(0, 0), Eq(0, 1), Eq(0, 2)]   # about 0.7, 0.2 and 0.08
    plans = [compile_plan(idx, p) for p in preds]
    be = TorchBackend(device="cpu", cache_size=0)
    assert sorted(map(len, be._group(plans).values())) == [3]
    want = [NumpyBackend().execute(p)[0] for p in plans]
    assert len(want[0]) > 5 * len(want[2]) > 0
    tracing.enable()
    tracing.reset()
    try:
        got = be.execute_many(plans)
        snap = tracing.snapshot()
    finally:
        tracing.enable(False)
        tracing.reset()
    for (rows, _), w in zip(got, want):
        np.testing.assert_array_equal(rows, w)
    assert got[0][0].base is got[1][0].base is got[2][0].base
    assert snap["counters"]["backend.rowid_answers"] == 3
    assert snap["counters"]["backend.groups"] == 1
    assert snap["spans"]["backend.unpack"]["n"] == 1


def test_rowid_counters_stay_off_the_compressed_entry():
    """The compressed entry never reaches the row-id kernels."""
    idx = index_of(1_025)
    plans = [compile_plan(idx, p) for p in backend_predicates().values()]
    be = TorchBackend(device="cpu", cache_size=0)
    tracing.enable()
    tracing.reset()
    try:
        be.execute_compressed_many(plans)
        counters = tracing.snapshot()["counters"]
    finally:
        tracing.enable(False)
        tracing.reset()
    assert counters["backend.groups"] == len(plans)
    assert "backend.rowid_answers" not in counters
    assert "backend.rowid_bytes" not in counters
