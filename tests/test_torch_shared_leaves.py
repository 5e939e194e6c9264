"""``TorchBackend`` decodes each distinct leaf stream of a plan once.

A TPC-H Q17-shaped IN-list (hundreds of scattered keys pushed into a
bit-sliced key column) compiles to one equality AND a key, so a few
thousand leaves reference the column's dozen slices.  Here, with
``TorchBackend(device="cpu")``:

* fused and per stage, the IN-list's EWAH streams and row ids are
  ``NumpyBackend``'s and ``evaluate_mask``'s, a short list on the fused
  path (its tape pushes the shared planes) and a long one per stage;
* the decode is handed the distinct planes only (the counters
  ``backend.leaf_refs`` and ``backend.planes``, and the copied batch);
* two plans with one root and different sharing keep apart;
* ``words_scanned`` still counts every leaf reference, as the
  reference's backends do;
* the memo of fused programs stays bounded, and a plan too long for the
  fused kernel is never lowered into it.

Tables are made with numpy from fixed seeds.  Every comparison is
bit-identical.
"""

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.core.query import JaxBackend
from repro_torch import tracing
from repro_torch.convert import index_from_reference
from repro_torch.core import ewah
from repro_torch.core import query as TQ
from repro_torch.core.query import (NumpyBackend, Plan, TorchBackend,
                                    compile_plan, evaluate_mask)
from repro_torch.kernels import planfuse

N_ROWS, CARD = 4_003, 4_000    # 12 slices of the key column


@pytest.fixture(autouse=True)
def clean():
    prev = tracing.enable(False)
    tracing.reset()
    yield
    tracing.enable(prev)
    tracing.reset()


@pytest.fixture(scope="module")
def keyed():
    """(columns, index): a bit-sliced key column of ``CARD`` values beside
    a small equality column."""
    rng = np.random.default_rng(17)
    cols = [rng.integers(0, CARD, N_ROWS), rng.integers(0, 7, N_ROWS)]
    idx = T.BitmapIndex.build(cols, T.IndexSpec(row_order="lex",
                                                encoding="auto"))
    assert idx.columns[list(idx.col_perm).index(0)].encoding.kind == \
        "bitsliced"
    return cols, idx


def q17_keys(n, seed):
    """``n`` scattered keys, as a part filter selects them: no three in a
    row, so each compiles to a 12-slice equality."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(CARD // 3, size=n, replace=False)) * 3
    return [int(k) for k in keys]


def distinct(plan):
    return len({id(s) for s in plan.streams})


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("n_keys", [30, 250])
def test_q17_in_list_answers_like_numpy_and_evaluate_mask(keyed, fuse,
                                                          n_keys):
    cols, idx = keyed
    preds = [T.In(0, q17_keys(n_keys, 5)),
             T.And(T.In(0, q17_keys(n_keys, 6)), T.Eq(1, 3))]
    plans = [compile_plan(idx, p) for p in preds]
    for p in plans:
        assert len(p.streams) >= 12 * n_keys and distinct(p) <= 14
    be = TorchBackend(device="cpu", fuse=fuse, cache_size=0)
    share = TQ._sharing(plans[0])
    fused = be._fused_program(plans[0].root, share) is not None
    assert fused == (fuse and n_keys == 30)
    want = NumpyBackend().execute_compressed_many(plans)
    got = be.execute_compressed_many(plans)
    rows = be.execute_many(plans)
    for p, g, w, (r, scanned), pl in zip(preds, got, want, rows, plans):
        np.testing.assert_array_equal(g.data, w.data)
        assert g.words_scanned == scanned == pl.leaf_words()
        np.testing.assert_array_equal(r, w.to_rows())
        np.testing.assert_array_equal(
            np.sort(idx.row_perm[r]),
            np.flatnonzero(evaluate_mask(p, cols)))


def test_fused_tape_pushes_the_shared_planes(keyed):
    """The fused program reads plane ``share[i]`` where the plan's own
    tape reads leaf i."""
    _, idx = keyed
    plan = compile_plan(idx, T.In(0, q17_keys(30, 5)))
    share = TQ._sharing(plan)
    tape = TorchBackend(device="cpu")._fused_program(plan.root, share).tape
    own, _ = TQ.lower_plan(plan.root)
    assert tape == tuple((op, share[a] if op == TQ.TAPE_PUSH else a)
                         for op, a in own)
    assert max(a for op, a in tape if op == TQ.TAPE_PUSH) < distinct(plan)


@pytest.mark.parametrize("entry", ["execute_compressed_many",
                                   "execute_many"])
def test_decode_is_handed_the_distinct_planes_only(keyed, entry):
    _, idx = keyed
    plans = [compile_plan(idx, T.In(0, q17_keys(n, s)))
             for n, s in ((250, 5), (250, 7), (30, 8))]
    be = TorchBackend(device="cpu", cache_size=0)
    shapes = []
    orig = be._to_device

    def spy(batch, lengths):
        shapes.append(batch.shape)
        return orig(batch, lengths)

    be._to_device = spy
    tracing.enable()
    getattr(be, entry)(plans)
    tracing.enable(False)
    c = tracing.snapshot()["counters"]
    assert c["backend.leaf_refs"] == sum(len(p.streams) for p in plans)
    assert c["backend.planes"] == sum(distinct(p) for p in plans) == \
        sum(b * m for b, m, _ in shapes)
    assert c["backend.planes"] * 100 < c["backend.leaf_refs"]
    assert c["backend.stream_bytes"] == 4 * sum(
        len(s) for p in plans
        for s in {id(s): s for s in p.streams}.values())


def test_plans_with_one_root_and_different_sharing_keep_apart():
    """Leaf 0 AND NOT leaf 1 over one stream twice (empty) and over two
    streams: one root, two groups, both answers right."""
    rng = np.random.default_rng(11)
    n_rows = 3_001
    n_words = -(-n_rows // ewah.WORD_BITS)
    pad = np.uint32((1 << (n_rows % ewah.WORD_BITS)) - 1)
    a, b = (rng.integers(0, 2**32, n_words, dtype=np.uint32)
            for _ in range(2))
    a[-1] &= pad
    b[-1] &= pad
    sa, sb = ewah.compress(a), ewah.compress(b)
    root = ("and", (("leaf", 0), ("not", ("leaf", 1))))
    plans = [Plan(streams=[sa, sa], root=root, n_rows=n_rows),
             Plan(streams=[sa, sb], root=root, n_rows=n_rows),
             Plan(streams=[sb, sb], root=root, n_rows=n_rows)]
    for fuse in (True, False):
        be = TorchBackend(device="cpu", fuse=fuse, cache_size=0)
        groups = be._group(plans)
        assert len(groups) == 2
        assert {k[0] for k in groups} == {root}
        assert sorted(groups.values()) == [[0, 2], [1]]
        want = NumpyBackend().execute_compressed_many(plans)
        got = be.execute_compressed_many(plans)
        rows = be.execute_many(plans)
        for g, w, (r, _) in zip(got, want, rows):
            np.testing.assert_array_equal(g.data, w.data)
            np.testing.assert_array_equal(r, w.to_rows())
        assert len(rows[0][0]) == len(rows[2][0]) == 0
        np.testing.assert_array_equal(
            rows[1][0], np.flatnonzero(ewah.unpack_bits(a & ~b, n_rows)))


def test_words_scanned_counts_every_leaf_reference_like_the_reference():
    """Sharing planes leaves ``words_scanned`` as the reference's
    backends count it, on test_torch_query.py's predicates over
    bit-sliced columns, where ranges read slices twice."""
    from test_torch_query import predicates, ref_index

    ref = ref_index("bitsliced")
    idx = index_from_reference(ref)
    r_plans = [R.query.compile_plan(ref, p) for p in predicates(R)]
    t_plans = [compile_plan(idx, p) for p in predicates(T)]
    assert any(distinct(p) < len(p.streams) for p in t_plans)
    jax = JaxBackend(use_kernel=False).execute_compressed_many(r_plans)
    for fuse in (True, False):
        be = TorchBackend(device="cpu", fuse=fuse, cache_size=0)
        got = be.execute_compressed_many(t_plans)
        rows = be.execute_many(t_plans)
        for g, j, (_, scanned), p in zip(got, jax, rows, t_plans):
            np.testing.assert_array_equal(g.data, j.data)
            assert g.words_scanned == j.words_scanned == scanned == \
                p.leaf_words()


@pytest.mark.parametrize("chunk_bytes", [None, 3 * 12 * 126 * 4])
def test_alike_clauses_fold_together(keyed, monkeypatch, chunk_bytes):
    """Per stage, an IN-list's equalities gather their planes and fold a
    chunk of them at a time (three a chunk at the small size), then the OR
    folds the chunks' answers; the answers stay the numpy backend's."""
    from repro_torch.kernels import ops

    _, idx = keyed
    if chunk_bytes is not None:
        monkeypatch.setattr(TQ, "CLAUSE_CHUNK_BYTES", chunk_bytes)
    folds = []
    fold = ops.wordops_fold
    monkeypatch.setattr(ops, "wordops_fold",
                        lambda x, op: folds.append(x.shape) or fold(x, op))
    plan = compile_plan(idx, T.In(0, q17_keys(250, 5)))
    be = TorchBackend(device="cpu", fuse=False, cache_size=0)
    got = be.execute_compressed_many([plan])[0]
    want = NumpyBackend().execute_compressed(plan)
    np.testing.assert_array_equal(got.data, want.data)
    n_words = -(-N_ROWS // ewah.WORD_BITS)
    per = 250 if chunk_bytes is None else 3
    assert folds[:-1] == [(12, min(per, 250 - c) * n_words)
                          for c in range(0, 250, per)]
    assert folds[-1] == (250, n_words)


def test_program_memo_is_bounded_and_skips_plans_too_long_to_fuse(keyed):
    _, idx = keyed
    be = TorchBackend(device="cpu", cache_size=0)
    plan = compile_plan(idx, T.In(0, q17_keys(250, 5)))
    be.execute_compressed_many([plan])
    assert be._programs.cache_info().currsize == 0
    assert 2 * len(plan.streams) - 1 > planfuse.MAX_TAPE_LEN
    for k in range(2, TQ.TAPE_MEMO_SIZE + 22):   # distinct fusable roots
        assert be._fused_program(
            ("or", tuple(("leaf", j) for j in range(k))),
            tuple(range(k))) is not None
    info = be._programs.cache_info()
    assert info.currsize == TQ.TAPE_MEMO_SIZE == info.maxsize
