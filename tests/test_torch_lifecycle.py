"""The port's segmented LSM lifecycle against the reference.

The same appends (with TTLs under an injected clock), seals, deletes by id
and by predicate, TTL expiry and compactions, with the same fixed workload
samples, run through ``repro.core.IndexWriter`` and
``repro_torch.core.IndexWriter``.  Both must give:

* identical encodings per segment (compaction re-encodes toward the
  observed mix, so point-query columns become Roaring);
* identical streams and container sets, tombstones and id spans;
* identical row ids and compressed results from ``SegmentedIndex``: the
  port's torch backend on ``device="cpu"`` (fused and per stage) against
  the reference on ``numpy`` and on ``jax`` with ``interpret=True``;
* an identical ``WorkloadStats.snapshot()`` and ``CostModel.rank``.

Also: ``convert.writer_from_reference`` carries a reference writer across
to a port writer that answers identically and keeps ingesting identically;
``BitmapIndex.build`` goes through a one-segment ``IndexWriter``; the query
surfaces feed ``WORKLOAD_STATS``; the default backend needs a card; and a
``BackgroundCompactor`` under ingest (joined with a timeout) leaves answers
equal to the dense oracle.  Inputs are made with numpy from fixed seeds;
every comparison is bit-identical.
"""

import threading
import time

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
import repro.workload as RW
import repro_torch.workload as TW
from repro_torch.analysis.runtime import sanitized
from repro_torch.convert import writer_from_reference
from test_torch_query import assert_columns_equal

CARDS = (7, 11, 300)


def make_table(n, seed):
    r = np.random.default_rng(seed)
    return [r.integers(0, c, size=n) for c in CARDS]


def predicates(P):
    return [
        P.Eq(0, 3),
        P.In(1, [1, 5, 9]),
        P.Range(2, 20, 180),
        P.And(P.Eq(0, 2), P.Eq(1, 4)),
        P.Or(P.Eq(0, 1), P.Range(2, 0, 30)),
        P.Not(P.Eq(1, 0)),
        P.And(P.In(0, [0, 1, 2]), P.Range(1, 0, 6), P.Not(P.Eq(2, 5))),
    ]


def fixed_stats(P):
    """A point-query mix on the two small columns and a wide-range mix on
    the large one, as tests/test_workload.py records them, so that the
    compaction chooser is deterministic."""
    stats = P.WorkloadStats()
    for i in range(64):
        stats.record(0, "eq", 1, "equality", 1, 40.0 + i % 3)
        stats.record(1, "eq", 1, "equality", 1, 40.0 + i % 3)
        stats.record(2, "range", 160, "equality", 159, 400.0 + i % 3)
    return stats


def lifecycle(P, W, delete_backend):
    """Drive one writer of package P (workload package W) through the
    whole LSM schedule; returns (writer, clock cell, ingest-order columns
    of every id, alive mask at the end)."""
    fake = [1000.0]
    w = P.IndexWriter(P.IndexSpec(k=1, row_order="lex", encoding="auto"),
                      clock=lambda: fake[0], workload_stats=fixed_stats(W))
    cols = make_table(1112, seed=31)
    alive = np.ones(1112, dtype=bool)
    w.append([c[:256] for c in cols], ttl=50.0)          # deadline 1050
    w.seal()
    w.append([c[256:512] for c in cols])
    w.seal()
    w.append([c[512:812] for c in cols])                 # 300 rows: 12 carry
    w.seal()
    w.append([c[812:1100] for c in cols])                # buffer: 12 + 288
    w.seal()                                             # carries 12
    w.append([c[1100:] for c in cols])                   # 24 open rows
    ids = np.array([3, 100, 257, 511, 800, 1090, 1095])
    assert w.delete(row_ids=ids) == len(ids)
    alive[ids] = False
    pred = P.Range(2, 10, 40)
    mask = P.evaluate_mask(pred, cols)
    got = w.delete(pred, backend=delete_backend)
    assert got == int((mask & alive).sum())
    alive &= ~mask
    fake[0] = 1100.0                                     # rows 0..255 expire
    alive[:256] = False
    merged = w.compact(span=(0, 2))
    assert merged.n_rows < 512                           # purged
    return w, fake, cols, alive


@pytest.fixture(scope="module")
def writers():
    rw, rclock, cols, alive = lifecycle(R, RW, "numpy")
    tw, tclock, _, _ = lifecycle(T, TW, "numpy")
    return rw, tw, cols, alive


def assert_segments_equal(tsegs, rsegs):
    assert len(tsegs) == len(rsegs)
    for ts, rs in zip(tsegs, rsegs):
        assert ts.index.encodings() == rs.index.encodings()
        assert (ts.row_start, ts.row_stop, ts.n_rows) == \
            (rs.row_start, rs.row_stop, rs.n_rows)
        np.testing.assert_array_equal(ts.ingest_ids(), rs.ingest_ids())
        np.testing.assert_array_equal(ts.index.row_perm, rs.index.row_perm)
        for ct, cr in zip(ts.index.columns, rs.index.columns):
            assert_columns_equal(ct, cr)
        assert (ts.tombstones is None) == (rs.tombstones is None)
        if ts.tombstones is not None:
            np.testing.assert_array_equal(ts.tombstones.data,
                                          rs.tombstones.data)


def test_segments_and_encodings_match_reference(writers):
    rw, tw, _, _ = writers
    assert_segments_equal(tw.segments, rw.segments)
    # the point-query columns of the compacted segment became Roaring
    enc = tw.segments[0].index.encodings()
    assert enc[0] == enc[1] == "roaring"
    assert tw.index.encodings() == rw.index.encodings()
    assert tw.buffered_rows == rw.buffered_rows == 24
    assert tw.live_rows() == rw.live_rows()


def reference_answers(rw, backend, **opts):
    """Row ids, then compressed results, from a cleared result cache: the
    second call reuses the first one's cached segment results, so both
    packages must take the same steps for words_scanned to agree."""
    R.query.get_backend(backend, **opts).result_cache.clear()
    preds = predicates(R)
    rows = rw.index.query_many(preds, backend=backend, **opts)
    comp = rw.index.execute_compressed_many(preds, backend=backend, **opts)
    return rows, comp


@pytest.fixture(scope="module")
def ref_numpy(writers):
    return reference_answers(writers[0], "numpy")


@pytest.fixture(scope="module")
def ref_jax(writers):
    return reference_answers(writers[0], "jax", interpret=True)


def assert_answers_equal(tw, ref_np, ref_jax, cols, alive, **opts):
    preds = predicates(T)
    T.query.get_backend("torch", **opts).result_cache.clear()
    rows = tw.index.query_many(preds, **opts)
    comp = tw.index.execute_compressed_many(preds, **opts)
    (np_rows, np_comp), (jx_rows, jx_comp) = ref_np, ref_jax
    for i, p in enumerate(preds):
        want = np.flatnonzero(T.evaluate_mask(p, cols) & alive)
        np.testing.assert_array_equal(rows[i][0], want)
        np.testing.assert_array_equal(rows[i][0], np_rows[i][0])
        np.testing.assert_array_equal(rows[i][0], jx_rows[i][0])
        assert rows[i][1] == jx_rows[i][1]
        (per_seg, merged) = comp[i]
        np.testing.assert_array_equal(merged.data, np_comp[i][1].data)
        np.testing.assert_array_equal(merged.data, jx_comp[i][1].data)
        assert merged.words_scanned == jx_comp[i][1].words_scanned
        for s, sn, sj in zip(per_seg, np_comp[i][0], jx_comp[i][0]):
            np.testing.assert_array_equal(s.data, sn.data)
            np.testing.assert_array_equal(s.data, sj.data)


@pytest.mark.parametrize("fuse", [True, False])
def test_segmented_answers_match_reference(writers, ref_numpy, ref_jax, fuse):
    rw, tw, cols, alive = writers
    assert_answers_equal(tw, ref_numpy, ref_jax, cols, alive,
                         device="cpu", fuse=fuse)


def test_segmented_answers_under_sanitizer(writers, ref_numpy, ref_jax):
    rw, tw, cols, alive = writers
    with sanitized():
        assert_answers_equal(tw, ref_numpy, ref_jax, cols, alive,
                             device="cpu")


def test_workload_snapshot_and_rank_match_reference(writers):
    """The planner's workload events of every segment's plans, recorded
    with fixed times, give identical snapshots and cost-model rankings."""
    rw, tw, _, _ = writers
    r_stats, t_stats = fixed_stats(RW), fixed_stats(TW)
    for seg_r, seg_t in zip(rw.segments, tw.segments):
        r_plans = [R.query.compile_plan(seg_r.index, p) for p in predicates(R)]
        t_plans = [T.query.compile_plan(seg_t.index, p) for p in predicates(T)]
        assert [p.workload for p in t_plans] == [p.workload for p in r_plans]
        us = [25.0 + 5 * i for i in range(len(r_plans))]
        r_stats.record_plans(r_plans, us)
        t_stats.record_plans(t_plans, us)
    assert t_stats.snapshot() == r_stats.snapshot()
    r_model = RW.CostModel.fit(r_stats.samples())
    t_model = TW.CostModel.fit(t_stats.samples())
    assert t_model.coef == r_model.coef
    r_mixes = RW.column_mixes(r_stats.samples())
    t_mixes = TW.column_mixes(t_stats.samples())
    assert t_mixes == r_mixes
    for col, mix in t_mixes.items():
        assert t_model.rank(mix, CARDS[col]) == r_model.rank(mix, CARDS[col])
    r_choose = RW.make_compaction_chooser(r_stats)
    t_choose = TW.make_compaction_chooser(t_stats)
    for col, card in enumerate(CARDS):
        hist = np.ones(card)
        assert t_choose(col, hist, 1) == r_choose(col, hist, 1)


def test_writer_from_reference_answers_and_ingests_identically(
        writers, ref_numpy, ref_jax):
    rw, _, cols, alive = writers
    cw = writer_from_reference(rw)
    assert isinstance(cw, T.IndexWriter)
    assert_segments_equal(cw.segments, rw.segments)
    assert cw.workload_stats.snapshot() == rw.workload_stats.snapshot()
    assert_answers_equal(cw, ref_numpy, ref_jax, cols, alive, device="cpu")
    # both keep going identically from the carried state (a fresh
    # reference writer, so the shared fixture's segments stay untouched)
    rw2 = lifecycle(R, RW, "numpy")[0]
    cw = writer_from_reference(rw2)
    more = make_table(200, seed=32)
    for w in (rw2, cw):
        w.append(more)
        w.seal()
        w.delete(row_ids=[1101, 1200])
        w.compact(span=(1, len(w.segments)))
    assert_segments_equal(cw.segments, rw2.segments)
    preds_r, preds_t = predicates(R), predicates(T)
    want = rw2.index.query_many(preds_r, backend="numpy")
    got = cw.index.query_many(preds_t, device="cpu")
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g[0], w_[0])


@pytest.mark.parametrize("encoding", ["auto", "roaring"])
def test_build_goes_through_one_segment_writer(encoding):
    cols = make_table(500, seed=33)
    spec = T.IndexSpec(row_order="lex", encoding=encoding)
    idx = T.BitmapIndex.build(cols, spec)
    assert idx.cache_scope[0] == "segment"        # sealed by a Segment
    w = T.IndexWriter(spec)
    w.append(cols)
    seg = w.close()
    assert seg.index.encodings() == idx.encodings()
    for a, b in zip(seg.index.columns, idx.columns):
        assert_columns_equal(a, b)
    ref = R.BitmapIndex.build(
        cols, R.IndexSpec(row_order="lex", encoding=encoding))
    for a, b in zip(idx.columns, ref.columns):
        assert_columns_equal(a, b)


def test_query_surfaces_feed_workload_stats():
    TW.WORKLOAD_STATS.clear()
    cols = make_table(300, seed=34)
    idx = T.BitmapIndex.build(cols, T.IndexSpec(encoding="roaring"))
    idx.query(T.Eq(0, 1), device="cpu")
    idx.query_compressed(T.In(1, [2, 3]), device="cpu")
    idx.query_many([T.Eq(0, 2), T.Range(2, 5, 50)], device="cpu")
    samples = TW.WORKLOAD_STATS.samples()
    assert len(samples) == 4
    assert {s[3] for s in samples} == {"roaring"}
    w = T.IndexWriter()
    w.append(cols)
    w.seal()
    w.index.query(T.Eq(1, 1), device="cpu")
    assert len(TW.WORKLOAD_STATS) == 5
    TW.WORKLOAD_STATS.clear()


def test_default_backend_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = T.IndexWriter()
    w.append(make_table(64, seed=35))
    w.seal()
    with pytest.raises(RuntimeError, match="CUDA device"):
        w.delete(T.Eq(0, 1))
    with pytest.raises(RuntimeError, match="CUDA device"):
        w.index.query(T.Eq(0, 1))
    assert w.delete(T.Eq(0, 1), backend="numpy") >= 0


def test_background_compactor_under_ingest():
    cols = make_table(2048, seed=36)
    w = T.IndexWriter(T.IndexSpec(k=1, row_order="lex"), seal_rows=64,
                      workload_stats=fixed_stats(TW))
    bc = T.BackgroundCompactor(w, interval=0.003, fanout=4, ratio=8.0)
    try:
        for i in range(0, 2048, 64):
            w.append([c[i : i + 64] for c in cols])
            if i == 1024:
                w.delete(row_ids=np.arange(32))
        time.sleep(0.03)
    finally:
        closer = threading.Thread(target=bc.close, daemon=True)
        closer.start()
        closer.join(timeout=60)
    assert not closer.is_alive(), "BackgroundCompactor.close did not return"
    assert not bc.running
    assert bc.stats["failures"] == 0 and bc.stats["compactions"] >= 1
    assert T.size_tiered_pick(w.segments, fanout=4, ratio=8.0) is None
    alive = np.ones(2048, dtype=bool)
    alive[:32] = False
    got = w.index.query_many(predicates(T), device="cpu")
    for p, (rows, _) in zip(predicates(T), got):
        np.testing.assert_array_equal(
            rows, np.flatnonzero(T.evaluate_mask(p, cols) & alive))
