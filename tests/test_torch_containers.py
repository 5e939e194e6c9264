"""The port's container kernels, container folds and batched container
lowering against the reference.

* ``repro_torch.kernels.ops.container_pairs`` (and, or, and-not) and
  ``container_gallop`` on the CPU, where they take their plain versions,
  against the reference wrappers ``repro.kernels.ops.container_pairs`` /
  ``container_gallop`` with the Pallas kernels in interpret mode and
  their jnp paths, on the inputs of tests/test_containers.py, padding
  lanes included;
* ``TorchBackend(device="cpu")._container_fold_many`` against
  ``get_backend("jax", interpret=True)._container_fold`` and the numpy
  streaming fold ``containers.fold`` on the four seeded trials of
  tests/test_containers.py, plus "and" folds of array containers with
  bitmap containers (the reference's gallop path), which the port folds
  in one ``container_fold`` call and no ``container_gallop`` call;
* the one-launch fold (``kernels.containers.pack_folds`` and
  ``ops.container_fold``, here their plain versions) against
  ``containers.fold``, ``JaxBackend._container_fold`` and the folded set's
  dense words: "or", "and-not", "and" and mixed folds of 1-12 sets mixing
  array, bitmap and run containers, keys held by one set only (a key only
  a later "and" set holds comes out absent), empty sets, row counts off
  the 65,536-row chunk; every fold of a call, "and" or not, takes one
  ``container_fold`` call;
* ``lower_containers_many`` against the reference's per-plan
  ``lower_containers``: equal roots, streams and cache hits, each distinct
  fold folded once;
* an unknown merge op raises in both packages.

Inputs are made with numpy from fixed seeds; every comparison is
bit-identical (tolerance 0).  test_torch_cuda.py runs the kernels on the
card.
"""

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import containers as RC
from repro.core import ewah
from repro.core.query import get_backend
from repro.kernels import ops as rops
from repro_torch.core import containers as C
from repro_torch.core import query as TQ
from repro_torch.core.query import TorchBackend
from repro_torch.kernels import containers as KC
from repro_torch.kernels import ops

OPS = ["and", "or", "andnot"]


def random_positions(n_rows, density, seed):
    r = np.random.default_rng(seed)
    return np.flatnonzero(r.random(n_rows) < density).astype(np.int64)


def t32(a):
    """uint32 / int32 numpy -> int32 bit-view CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def u32(t):
    return t.numpy().view(np.uint32)


def chunk_word_stacks(seed):
    """Two (3, CHUNK_WORDS) stacks of expanded chunks at the densities of
    test_kernel_gallop_matches_dense_membership (0.1, 0.5, 0.0), so the
    stacks hold dense, sparse and empty rows."""
    r = np.random.default_rng(seed)
    stacks = []
    for _ in range(2):
        rows = [C.chunk_words(*C.make_chunk(
            np.flatnonzero(r.random(C.CHUNK_ROWS) < d)))
            if d else np.zeros(C.CHUNK_WORDS, dtype=np.uint32)
            for d in (0.1, 0.5, 0.0)]
        stacks.append(np.stack(rows).astype(np.uint32))
    return stacks


@pytest.mark.parametrize("op", OPS)
def test_container_pairs_matches_reference(op):
    a, b = chunk_word_stacks(13)
    got = u32(ops.container_pairs(t32(a), t32(b), op))
    for use_kernel in (True, False):
        want = np.asarray(rops.container_pairs(a, b, op, use_kernel=use_kernel,
                                               interpret=True))
        np.testing.assert_array_equal(got, want)
    assert got.shape == a.shape


@pytest.mark.parametrize("op", OPS)
def test_container_pairs_odd_shape_matches_reference(op):
    """A row count and width off every tile: the reference pads to
    (8, 128) tiles, the port takes any shape."""
    r = np.random.default_rng(5)
    a = r.integers(0, 2**32, size=(3, 200), dtype=np.uint32)
    b = r.integers(0, 2**32, size=(3, 200), dtype=np.uint32)
    want = np.asarray(rops.container_pairs(a, b, op, interpret=True))
    np.testing.assert_array_equal(
        u32(ops.container_pairs(t32(a), t32(b), op)), want)


def gallop_inputs():
    """The inputs of test_kernel_gallop_matches_dense_membership."""
    r = np.random.default_rng(13)
    dense = [np.flatnonzero(r.random(C.CHUNK_ROWS) < d)
             for d in (0.1, 0.5, 0.0)]
    words = np.stack([ewah.positions_to_words(d, C.CHUNK_ROWS)
                      for d in dense])
    pos = np.full((3, 64), -1, dtype=np.int32)
    queries = []
    for i in range(3):
        q = np.unique(r.integers(0, C.CHUNK_ROWS, size=40))
        pos[i, : len(q)] = q
        queries.append(q)
    return dense, words, pos, queries


def test_container_gallop_matches_reference_and_dense():
    dense, words, pos, queries = gallop_inputs()
    got = ops.container_gallop(t32(pos), t32(words)).numpy()
    assert got.dtype == np.int32 and got.shape == pos.shape
    for use_kernel in (True, False):
        want = np.asarray(rops.container_gallop(pos, words,
                                                use_kernel=use_kernel,
                                                interpret=True))
        np.testing.assert_array_equal(got.view(np.uint32), want)
    for i, q in enumerate(queries):
        np.testing.assert_array_equal(q[got[i, : len(q)].astype(bool)],
                                      np.intersect1d(q, dense[i]))
    assert not got[pos < 0].any()     # padding lanes never report hits


def test_container_gallop_edge_positions():
    """Bit 0 and bit 31 of the first and last words, on all-ones and
    all-zero rows; a position past the row reports no hit."""
    words = np.zeros((2, C.CHUNK_WORDS), dtype=np.uint32)
    words[0] = 0xFFFFFFFF
    edge = [0, 31, 32, C.CHUNK_ROWS - 32, C.CHUNK_ROWS - 1]
    pos = np.array([edge + [-1], edge + [-1]], dtype=np.int32)
    want = np.asarray(rops.container_gallop(pos, words, interpret=True))
    got = ops.container_gallop(t32(pos), t32(words)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want)
    np.testing.assert_array_equal(got[0], [1, 1, 1, 1, 1, 0])
    assert not got[1].any()
    past = np.array([[C.CHUNK_ROWS, C.CHUNK_ROWS + 40]], dtype=np.int32)
    assert not ops.container_gallop(t32(past), t32(words[:1])).any()


def fold_trials():
    """The four seeded trials of
    test_containers.py::test_jax_container_fold_bit_identical_to_numpy."""
    n = 2 * C.CHUNK_ROWS + 901
    r = np.random.default_rng(11)
    out = []
    for _ in range(4):
        k = int(r.integers(2, 5))
        pos = [random_positions(n, float(r.uniform(0.001, 0.6)),
                                int(r.integers(0, 2**31))) for _ in range(k)]
        fops = tuple(str(o) for o in r.choice(OPS, size=k - 1))
        out.append((n, pos, fops))
    return out


@pytest.mark.parametrize("trial", range(4))
def test_container_fold_matches_jax_and_numpy(trial):
    n, pos, fops = fold_trials()[trial]
    t_sets = [C.from_positions(p, n) for p in pos]
    r_sets = [RC.from_positions(p, n) for p in pos]
    got = TorchBackend(device="cpu")._container_fold_many(
        [(t_sets, fops, n)])[0]
    want_jax = get_backend("jax", interpret=True)._container_fold(
        r_sets, fops, n)
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, RC.fold(r_sets, fops, n))
    np.testing.assert_array_equal(got, C.fold(t_sets, fops, n))


def count_calls(monkeypatch, name):
    """Replace ``ops.<name>`` by a wrapper that records each call's
    arguments."""
    calls = []
    real = getattr(ops, name)
    monkeypatch.setattr(ops, name, lambda *a: calls.append(a) or real(*a))
    return calls


@pytest.mark.parametrize("dens", [(0.002, 0.3), (0.3, 0.002),
                                  (0.002, 0.3, 0.2)])
def test_and_fold_takes_gallop_path(dens, monkeypatch):
    """Array containers (density 0.002, about 131 rows a chunk) ANDed with
    bitmap containers (0.2, 0.3: over 4096 rows a chunk), the pairs the
    reference gallops through its member kernel: the port intersects them
    inside one container_fold call, never calls container_gallop, and
    matches the reference fold."""
    n = 16 * C.CHUNK_ROWS
    pos = [random_positions(n, d, 100 + i) for i, d in enumerate(dens)]
    t_sets = [C.from_positions(p, n) for p in pos]
    r_sets = [RC.from_positions(p, n) for p in pos]
    fops = ("and",) * (len(dens) - 1)
    classes = {int(c) for s in t_sets[:2] for c in s.classes}
    assert classes == {C.ARRAY, C.BITMAP}
    gallops = count_calls(monkeypatch, "container_gallop")
    folds = count_calls(monkeypatch, "container_fold")
    got = TorchBackend(device="cpu")._container_fold_many(
        [(t_sets, fops, n)])[0]
    assert len(folds) == 1 and not gallops
    np.testing.assert_array_equal(got, RC.fold(r_sets, fops, n))
    np.testing.assert_array_equal(
        got, get_backend("jax", interpret=True)._container_fold(
            r_sets, fops, n))


def test_container_sets_match_reference():
    n = 3 * C.CHUNK_ROWS + 17
    for seed, d in enumerate((0.001, 0.05, 0.4, 0.999)):
        p = random_positions(n, d, seed)
        t, r = C.from_positions(p, n), RC.from_positions(p, n)
        np.testing.assert_array_equal(t.keys, r.keys)
        np.testing.assert_array_equal(t.classes, r.classes)
        for a, b in zip(t.payloads, r.payloads):
            np.testing.assert_array_equal(a, b)


def test_unknown_op_raises_in_both():
    n = C.CHUNK_ROWS
    p = [np.arange(10, dtype=np.int64) * i for i in (1, 2)]
    t_sets = [C.from_positions(x, n) for x in p]
    r_sets = [RC.from_positions(x, n) for x in p]
    with pytest.raises(ValueError, match="unknown container merge op"):
        TorchBackend(device="cpu")._container_fold_many(
            [(t_sets, ("xor",), n)])
    with pytest.raises(ValueError, match="unknown container merge op"):
        get_backend("jax", interpret=True)._container_fold(r_sets, ("xor",), n)
    a = torch.zeros(2, C.CHUNK_WORDS, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown container merge op"):
        ops.container_pairs(a, a, "xor")
    with pytest.raises(ValueError, match="unknown container merge op"):
        rops.container_pairs(np.zeros((2, 8), np.uint32),
                             np.zeros((2, 8), np.uint32), "xor")


def test_wrappers_reject_mismatched_shapes():
    a = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="differ"):
        ops.container_pairs(a, a[:1])
    with pytest.raises(ValueError, match="do not pair up"):
        ops.container_gallop(a, a[:1])


def test_cpu_wrappers_count_no_launches():
    ops.reset_launches()
    dense, words, pos, _ = gallop_inputs()
    ops.container_gallop(t32(pos), t32(words))
    ops.container_pairs(t32(words), t32(words), "or")
    assert ops.LAUNCHES["member"] == 0 and ops.LAUNCHES["containerops"] == 0


# ---------------------------------------------------------------------------
# the one-launch fold (kernels.containers.pack_folds + ops.container_fold)
# ---------------------------------------------------------------------------


def styled_positions(n_rows, styles, seed):
    """Positions over ``n_rows`` rows, chunk by chunk in the given styles:
    "empty", "array" (about 100 random rows), "bitmap" (density 0.3),
    "run" (three long intervals), "full"; the last chunk may be partial."""
    r = np.random.default_rng(seed)
    out = []
    for key, style in enumerate(styles):
        lo = key * C.CHUNK_ROWS
        width = min(C.CHUNK_ROWS, n_rows - lo)
        if width <= 0 or style == "empty":
            continue
        if style == "array":
            local = np.unique(r.integers(0, width, size=100))
        elif style == "bitmap":
            local = np.flatnonzero(r.random(width) < 0.3)
        elif style == "run":
            cuts = np.sort(r.choice(width, size=6, replace=False))
            local = np.concatenate([np.arange(a, b + 1)
                                    for a, b in cuts.reshape(3, 2)])
        else:
            local = np.arange(width)
        out.append(local + lo)
    return np.concatenate(out) if out else np.empty(0, np.int64)


STYLES = ("empty", "array", "bitmap", "run", "full")


FOLD_KINDS = {"or": ("or",), "andnot": ("andnot",), "mixed": ("or", "andnot"),
              "and": ("and",), "mixed_and": ("or", "andnot", "and")}


def fold_case(k, ops_kind, n_rows, seed):
    """k sets over n_rows rows, each chunk of each set in a random style
    (so every class appears, and many keys live in one set only), with an
    op sequence of one op or ("mixed", "mixed_and") drawn from
    ``FOLD_KINDS[ops_kind]``."""
    r = np.random.default_rng(seed)
    n_chunks = -(-n_rows // C.CHUNK_ROWS)
    pos = [styled_positions(n_rows, r.choice(STYLES, size=n_chunks),
                            int(r.integers(0, 2**31))) for _ in range(k)]
    kinds = FOLD_KINDS[ops_kind]
    if len(kinds) == 1:
        fops = kinds * (k - 1)
    else:
        fops = tuple(str(o) for o in r.choice(list(kinds), size=k - 1))
    return pos, fops


ONE_LAUNCH_CASES = [(k, kind, n) for k in (1, 2, 5, 12)
                    for kind in FOLD_KINDS
                    for n in (3 * C.CHUNK_ROWS + 901, 4 * C.CHUNK_ROWS)]


@pytest.mark.parametrize("k,kind,n", ONE_LAUNCH_CASES)
def test_one_launch_fold_matches_reference(k, kind, n, monkeypatch):
    """The one-launch route's plain version (CPU tensors) against the
    reference's numpy fold and JaxBackend in interpret mode, and its dense
    planes against the folded set's words."""
    pos, fops = fold_case(k, kind, n, seed=k * 1000 + n % 997)
    t_sets = [C.from_positions(p, n) for p in pos]
    r_sets = [RC.from_positions(p, n) for p in pos]
    calls = count_calls(monkeypatch, "container_fold")
    gallops = count_calls(monkeypatch, "container_gallop")
    got = TorchBackend(device="cpu")._container_fold_many(
        [(t_sets, fops, n)])[0]
    assert len(calls) == 1 and not gallops   # one route, "and" or not
    np.testing.assert_array_equal(got, RC.fold(r_sets, fops, n))
    np.testing.assert_array_equal(
        got, get_backend("jax", interpret=True)._container_fold(
            r_sets, fops, n))
    packed = KC.pack_folds([(t_sets, fops, n)])
    planes = ops.container_fold(torch.from_numpy(packed.buf), packed)
    acc = t_sets[0]
    for op, nxt in zip(fops, t_sets[1:]):
        acc = C.merge(acc, nxt, op)
    np.testing.assert_array_equal(u32(planes), C.to_words(acc))


def test_one_launch_fold_covers_every_class_and_edge():
    """The cases above hold array, bitmap and run containers, keys held by
    one set only, keys only a later "and" set holds, "and" steps of an
    array with a bitmap, and a fold with an empty set."""
    seen, lone, and_only, array_and_bitmap = set(), 0, 0, 0
    for k, kind, n in ONE_LAUNCH_CASES:
        pos, fops = fold_case(k, kind, n, seed=k * 1000 + n % 997)
        sets = [C.from_positions(p, n) for p in pos]
        seen |= {int(c) for s in sets for c in s.classes}
        keys = [set(s.keys.tolist()) for s in sets]
        lone += sum(1 for i, ks in enumerate(keys) for key in ks
                    if not any(key in o for j, o in enumerate(keys) if j != i))
        steps = ("or",) + fops
        ored = set().union(*(ks for ks, op in zip(keys, steps) if op == "or"))
        and_only += sum(1 for ks, op in zip(keys, steps) if op == "and"
                        for key in ks if key not in ored)
        acc = sets[0]
        for op, nxt in zip(fops, sets[1:]):
            if op == "and":
                mine = dict(zip(acc.keys.tolist(), acc.classes.tolist()))
                array_and_bitmap += sum(
                    1 for key, c in zip(nxt.keys.tolist(),
                                        nxt.classes.tolist())
                    if {c, mine.get(key)} == {C.ARRAY, C.BITMAP})
            acc = C.merge(acc, nxt, op)
    assert seen == {C.ARRAY, C.BITMAP, C.RUN} and lone > 0
    assert and_only > 0 and array_and_bitmap > 0
    n = 2 * C.CHUNK_ROWS + 5
    empty = C.from_positions(np.empty(0, np.int64), n)
    full = C.from_positions(np.arange(n), n)
    be = TorchBackend(device="cpu")
    for sets, fops in (([empty], ()), ([empty, full], ("or",)),
                       ([full, empty], ("andnot",)), ([empty, empty], ("or",)),
                       ([full, full], ("andnot",)), ([empty, full], ("and",)),
                       ([full, empty], ("and",)), ([full, full], ("and",)),
                       ([full, empty, full], ("and", "or"))):
        got = be._container_fold_many([(sets, fops, n)])[0]
        np.testing.assert_array_equal(got, C.fold(sets, fops, n))


def test_one_launch_fold_batches_many_folds():
    """Several folds of different row counts in one call: one packed
    buffer, each plane at its own offset, every stream as containers.fold
    gives it; a set shared by folds is uploaded once."""
    folds = []
    for i, n in enumerate((C.CHUNK_ROWS + 33, 3 * C.CHUNK_ROWS,
                           C.CHUNK_ROWS + 33, 2 * C.CHUNK_ROWS + 64)):
        pos, fops = fold_case(3 + i, "mixed", n, seed=50 + i)
        folds.append(([C.from_positions(p, n) for p in pos], fops, n))
    folds.append((folds[0][0], ("or", "or", "or")[: len(folds[0][1])],
                  folds[0][2]))
    be = TorchBackend(device="cpu")
    got = be._container_fold_many(folds)
    for (sets, fops, n), g in zip(folds, got):
        np.testing.assert_array_equal(g, C.fold(sets, fops, n))
    packed = KC.pack_folds(folds)
    assert packed.n_out == sum(-(-n // 32) for _, _, n in folds)
    assert [w for _, w in packed.planes] == [-(-n // 32) for _, _, n in folds]
    n_bitmap = (packed.u16_at - packed.words_at) // C.CHUNK_WORDS
    distinct = {(id(s), i) for sets, _, _ in folds for s in sets
                for i, c in enumerate(s.classes) if c == C.BITMAP}
    assert n_bitmap == len(distinct)


def test_one_launch_fold_past_max_dirty_words():
    """Planes past ``MAX_DIRTY`` words, which the reference re-encodes on
    the host, encode on the device program's encoder (its plain version
    here): a dirty run past ``MAX_DIRTY`` and a clean-1 run past
    ``MAX_CLEAN``, in one call, as ``containers.fold`` gives them."""
    rng = np.random.default_rng(28)
    n1 = 17 * C.CHUNK_ROWS + 901          # 34,845 words
    n2 = 34 * C.CHUNK_ROWS + 5            # 69,633 words
    assert -(-n1 // 32) > ewah.MAX_DIRTY and -(-n2 // 32) > ewah.MAX_CLEAN
    dense = np.flatnonzero(rng.random(n1) < 0.5)
    sparse = np.unique(rng.integers(0, n1, size=500))
    tail = np.unique(rng.integers(n2 - 3000, n2, size=200))
    folds = [([C.from_positions(dense, n1), C.from_positions(sparse, n1)],
              ("or",), n1),
             ([C.from_positions(np.arange(n2), n2),
               C.from_positions(tail, n2)], ("andnot",), n2)]
    got = TorchBackend(device="cpu")._container_fold_many(folds)
    for (sets, fops, n), g in zip(folds, got):
        np.testing.assert_array_equal(g, C.fold(sets, fops, n))
        assert len(g) <= -(-n // 32) + 1 + -(-n // 32) // ewah.MAX_DIRTY


def test_and_folds_keep_the_per_round_route(monkeypatch):
    """Folds with an "and" step and folds without one share the call's
    single container_fold, each plane at its own offset: no
    container_pairs and no container_gallop call, no round on the
    host."""
    n = 4 * C.CHUNK_ROWS
    pos = [random_positions(n, d, 300 + i)
           for i, d in enumerate((0.002, 0.3, 0.05))]
    t_sets = [C.from_positions(p, n) for p in pos]
    pairs = count_calls(monkeypatch, "container_pairs")
    gallops = count_calls(monkeypatch, "container_gallop")
    folded = count_calls(monkeypatch, "container_fold")
    folds = [(t_sets, ("and", "or"), n), (t_sets, ("or", "andnot"), n),
             (t_sets[1:], ("or",), n)]
    got = TorchBackend(device="cpu")._container_fold_many(folds)
    for (sets, fops, _), g in zip(folds, got):
        np.testing.assert_array_equal(g, C.fold(sets, fops, n))
    assert not pairs and not gallops and len(folded) == 1
    W = n // 32
    assert folded[0][1].planes == ((0, W), (W, W), (2 * W, W))


# ---------------------------------------------------------------------------
# the batched lowering (core.query.lower_containers_many)
# ---------------------------------------------------------------------------


def roaring_plans(P):
    """Plans over a Roaring index (four chunks, a partial last one) from
    package P's planner: In and Range on both columns, each predicate
    twice, so folds repeat within one batch and across plans."""
    from repro.core import query as RQ
    from repro_torch.convert import index_from_reference

    r = np.random.default_rng(17)
    n = 3 * C.CHUNK_ROWS + 4099
    cols = [r.integers(0, 7, size=n), r.integers(0, 11, size=n)]
    ref_idx = RQ_index(cols)
    idx = index_from_reference(ref_idx) if P is T else ref_idx
    preds = [P.In(0, [1, 3, 5]), P.Range(1, 2, 8),
             P.And(P.In(0, [0, 2]), P.Not(P.Range(1, 0, 4))),
             P.Or(P.Eq(0, 6), P.In(1, [9, 10])), P.In(0, [1, 3, 5]),
             P.Range(1, 2, 8)]
    compile_ = TQ.compile_plan if P is T else RQ.compile_plan
    return [compile_(idx, p) for p in preds]


def RQ_index(cols):
    import repro.core as R

    return R.BitmapIndex.build(cols, R.IndexSpec(k=1, row_order="lex",
                                                 encoding="roaring"))


def test_batched_lowering_matches_per_plan_reference():
    """lower_containers_many with the torch backend's fold against the
    reference's per-plan lower_containers with its numpy fold: equal roots,
    streams, cache hits and misses; every distinct fold folded once, in
    one call."""
    from repro.core import query as RQ

    t_plans, r_plans = roaring_plans(T), roaring_plans(R)
    assert all(p.containers for p in t_plans)
    t_cache, r_cache = TQ.ResultCache(), RQ.ResultCache()
    be = TorchBackend(device="cpu")
    calls = []
    real = be._container_fold_many
    be._container_fold_many = lambda folds: calls.append(len(folds)) or \
        real(folds)
    TQ.lower_containers_many(t_plans, be._container_fold_many, t_cache)
    ref_fold = RQ.NumpyBackend()._container_fold
    for p in r_plans:
        RQ.lower_containers(p, ref_fold, r_cache)
    distinct = {k for k in r_cache._data}
    assert calls == [len(distinct)]
    for tp, rp in zip(t_plans, r_plans):
        assert tp.root == rp.root and tp.containers is None
        assert len(tp.streams) == len(rp.streams)
        for a, b in zip(tp.streams, rp.streams):
            np.testing.assert_array_equal(a, b)
    assert (t_cache.hits, t_cache.misses) == (r_cache.hits, r_cache.misses)
    assert t_cache.hits > 0
    # a second lowering of fresh plans hits the cache for every fold
    again = roaring_plans(T)
    TQ.lower_containers_many(again, be._container_fold_many, t_cache)
    assert calls == [len(distinct)]
    for tp, ap in zip(t_plans, again):
        assert tp.root == ap.root


def test_batched_lowering_entry_points_answer_like_numpy():
    """execute_many / execute_compressed_many lower all their plans' folds
    in one call and answer like NumpyBackend."""
    plans = roaring_plans(T)
    want = T.query.NumpyBackend().execute_compressed_many(roaring_plans(T))
    be = TorchBackend(device="cpu")
    calls = []
    real = be._container_fold_many
    be._container_fold_many = lambda folds: calls.append(len(folds)) or \
        real(folds)
    got = be.execute_compressed_many(plans)
    rows = be.execute_many(roaring_plans(T))
    for g, w, (r, _) in zip(got, want, rows):
        np.testing.assert_array_equal(g.data, w.data)
        np.testing.assert_array_equal(r, w.to_rows())
    assert len(calls) == 1       # the second call found every fold cached
