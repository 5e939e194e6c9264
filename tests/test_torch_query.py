"""The port's index build and ``TorchBackend`` against the reference.

* ``repro_torch`` builds the same streams, ``row_perm`` and ``col_perm`` as
  ``repro.core.BitmapIndex.build`` for every stream encoding;
* ``TorchBackend(device="cpu")``, fused and per stage, returns EWAH
  streams and row ids identical to ``JaxBackend`` (its jnp reference path)
  and ``NumpyBackend``, on an index carried across by
  ``convert.index_from_reference``, with the ``PREDICATES`` of
  test_planfuse.py, also under ``REPRO_SANITIZE=1``;
* Roaring columns: container sets identical to the reference's, and
  their container folds answering like ``NumpyBackend``;
* the Hopper gate, the CUDA-only default device, and the package's import
  isolation.

Tables are made with numpy from fixed seeds (about 2,000 rows).  Every
comparison is bit-identical.  test_torch_cuda.py runs the backend on the
card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.query import JaxBackend
from repro.core.query import NumpyBackend as RefNumpyBackend
from repro_torch.analysis.runtime import sanitized
from repro_torch.convert import index_from_reference
from repro_torch.core import query as TQ
from repro_torch.core.query import NumpyBackend, TorchBackend, compile_plan
from repro_torch.kernels import planfuse

ENCODINGS = ["equality", "bitsliced", "bitsliced-gray", "binned", "roaring"]


def assert_columns_equal(got, want):
    """Same streams, or for Roaring columns the same container sets (keys,
    classes and payloads of every value's set)."""
    assert got.encoding.kind == want.encoding.kind
    assert len(got.streams) == len(want.streams)
    for sg, sw in zip(got.streams, want.streams):
        if got.encoding.kind == "roaring":
            np.testing.assert_array_equal(sg.keys, sw.keys)
            np.testing.assert_array_equal(sg.classes, sw.classes)
            assert len(sg.payloads) == len(sw.payloads)
            for pg, pw in zip(sg.payloads, sw.payloads):
                assert pg.dtype == pw.dtype
                np.testing.assert_array_equal(pg, pw)
        else:
            np.testing.assert_array_equal(sg, sw)
    np.testing.assert_array_equal(got.sizes, want.sizes)


def predicates(P):
    """The PREDICATES of test_planfuse.py, built from package ``P``."""
    return [
        P.Eq(0, 3),
        P.Not(P.Eq(1, 2)),
        P.In(1, [1, 5, 9]),
        P.Range(2, 4, 21),
        P.And(P.Eq(0, 2), P.Eq(1, 4)),
        P.Or(P.Eq(0, 1), P.Eq(0, 2), P.Eq(1, 0)),
        P.And(P.In(0, [0, 1, 2]), P.Range(1, 0, 6), P.Not(P.Eq(2, 5))),
        P.Or(P.And(P.Eq(0, 1), P.Eq(1, 1)), P.Not(P.In(2, [0, 1, 2]))),
    ]


def table(n=2011, cards=(7, 12, 64), seed=3):
    r = np.random.default_rng(seed)
    return [r.integers(0, c, size=n) for c in cards]


def ref_index(encoding, cols=None):
    cols = table() if cols is None else cols
    return R.BitmapIndex.build(
        cols, R.IndexSpec(k=1, row_order="lex", encoding=encoding))


@pytest.mark.parametrize("encoding", ENCODINGS + ["auto"])
def test_build_matches_reference(encoding):
    cols = table()
    want = ref_index(encoding, cols)
    got = T.BitmapIndex.build(
        cols, T.IndexSpec(k=1, row_order="lex", encoding=encoding))
    assert got.n_rows == want.n_rows
    np.testing.assert_array_equal(got.row_perm, want.row_perm)
    np.testing.assert_array_equal(got.col_perm, want.col_perm)
    assert got.encodings() == want.encodings()
    assert got.spec.to_dict() == want.spec.to_dict()
    for cg, cw in zip(got.columns, want.columns):
        assert_columns_equal(cg, cw)


def test_build_k2_grayfreq_matches_reference():
    cols = table(n=1500, cards=(9, 20, 33), seed=8)
    want = R.BitmapIndex.build(cols, R.IndexSpec(k=2, row_order="grayfreq"))
    got = T.BitmapIndex.build(cols, T.IndexSpec(k=2, row_order="grayfreq"))
    np.testing.assert_array_equal(got.row_perm, want.row_perm)
    for cg, cw in zip(got.columns, want.columns):
        np.testing.assert_array_equal(cg.codes, cw.codes)
        for sg, sw in zip(cg.streams, cw.streams):
            np.testing.assert_array_equal(sg, sw)


def test_index_from_reference_carries_state():
    ref = ref_index("binned")
    idx = index_from_reference(ref)
    assert isinstance(idx, T.BitmapIndex)
    assert idx.n_rows == ref.n_rows and idx.encodings() == ref.encodings()
    np.testing.assert_array_equal(idx.row_perm, ref.row_perm)
    for cg, cw in zip(idx.columns, ref.columns):
        for sg, sw in zip(cg.streams, cw.streams):
            np.testing.assert_array_equal(sg, sw)


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_torch_backend_matches_jax_and_numpy(encoding):
    ref = ref_index(encoding)
    idx = index_from_reference(ref)
    r_plans = [R.query.compile_plan(ref, p) for p in predicates(R)]
    t_plans = [compile_plan(idx, p) for p in predicates(T)]
    # Roaring plans reach the Pallas container kernels, run as the
    # reference's own tests run them: in interpret mode
    jax = (JaxBackend(interpret=True) if encoding == "roaring"
           else JaxBackend(use_kernel=False))
    jax_streams = jax.execute_compressed_many(r_plans)
    np_streams = [RefNumpyBackend().execute_compressed(p) for p in r_plans]
    jax_rows = (jax.execute_many(r_plans)
                if encoding in ("equality", "roaring") else None)
    for fuse in (True, False):
        be = TorchBackend(device="cpu", fuse=fuse)
        got = be.execute_compressed_many(t_plans)
        rows = be.execute_many(t_plans)
        for i, (s, js, ns) in enumerate(zip(got, jax_streams, np_streams)):
            np.testing.assert_array_equal(s.data, js.data)
            np.testing.assert_array_equal(s.data, ns.data)
            assert s.n_rows == js.n_rows
            assert s.words_scanned == js.words_scanned
            np.testing.assert_array_equal(rows[i][0], ns.to_rows())
            assert rows[i][1] == t_plans[i].leaf_words()
            if jax_rows is not None:
                np.testing.assert_array_equal(rows[i][0], jax_rows[i][0])
                assert rows[i][1] == jax_rows[i][1]


def test_fused_tape_used_and_per_stage_when_not_fused():
    """The default backend lowers a small plan to its planfuse tape,
    ``fuse=False`` lowers nothing, and both answer identically (and like
    ``NumpyBackend``)."""
    idx = index_from_reference(ref_index("equality"))
    plans = [compile_plan(idx, p) for p in predicates(T)]
    root = plans[-1].root
    fused = TorchBackend(device="cpu")
    per_stage = TorchBackend(device="cpu", fuse=False)
    share = TQ._sharing(plans[-1])
    tape = fused._fused_program(root, share).tape
    assert tape is not None and tape == TQ.lower_plan(root)[0]
    assert per_stage._fused_program(root, share) is None
    want = NumpyBackend().execute_compressed_many(plans)
    got_f = fused.execute_compressed_many(plans)
    got_p = per_stage.execute_compressed_many(plans)
    rows_f = fused.execute_many(plans)
    rows_p = per_stage.execute_many(plans)
    for f, p, w, rf, rp in zip(got_f, got_p, want, rows_f, rows_p):
        np.testing.assert_array_equal(f.data, p.data)
        np.testing.assert_array_equal(f.data, w.data)
        np.testing.assert_array_equal(rf[0], rp[0])
        np.testing.assert_array_equal(rf[0], w.to_rows())


def test_under_sanitizer():
    idx = index_from_reference(ref_index("bitsliced"))
    plans = [compile_plan(idx, p) for p in predicates(T)]
    want = NumpyBackend().execute_compressed_many(plans)
    with sanitized():
        for fuse in (True, False):
            be = TorchBackend(device="cpu", fuse=fuse)
            got = be.execute_compressed_many(plans)
            rows = be.execute_many(plans)
            for s, w, (r, _) in zip(got, want, rows):
                s.validate(origin="test_under_sanitizer")
                np.testing.assert_array_equal(s.data, w.data)
                np.testing.assert_array_equal(r, w.to_rows())


def _deep_root(depth):
    """A right-nested and/or chain whose operand stack peaks at ``depth``."""
    node = ("leaf", depth - 1)
    for i in range(depth - 2, -1, -1):
        node = ("and" if i % 2 else "or", (("leaf", i), node))
    return node


def _identity(root):
    """The leaf sharing of a root whose leaves read distinct streams."""
    return tuple(range(sum(1 for op, _ in TQ.lower_plan(root)[0]
                           if op == TQ.TAPE_PUSH)))


def test_hopper_gate_sends_deep_plans_per_stage():
    be = TorchBackend(device="cpu")
    ok = _deep_root(planfuse.MAX_STACK_DEPTH)
    deep = _deep_root(planfuse.MAX_STACK_DEPTH + 1)
    assert TQ.lower_plan(deep)[1] == planfuse.MAX_STACK_DEPTH + 1
    assert be._fused_program(ok, _identity(ok)) is not None
    assert be._fused_program(deep, _identity(deep)) is None
    long_tape = ("or", tuple(("leaf", i)
                             for i in range(planfuse.MAX_TAPE_LEN // 2 + 1)))
    assert be._fused_program(long_tape, _identity(long_tape)) is None


def test_gated_plans_run_per_stage_and_agree(monkeypatch):
    idx = index_from_reference(ref_index("equality"))
    plans = [compile_plan(idx, p) for p in predicates(T)]
    want = NumpyBackend().execute_compressed_many(plans)
    monkeypatch.setattr(planfuse, "MAX_STACK_DEPTH", 1)
    be = TorchBackend(device="cpu")
    got = be.execute_compressed_many(plans)
    assert be._fused_program(plans[4].root,
                             TQ._sharing(plans[4])) is None   # depth 2: per stage
    assert be._fused_program(plans[0].root,
                             TQ._sharing(plans[0])) is not None
    for s, w in zip(got, want):
        np.testing.assert_array_equal(s.data, w.data)


def test_group_capacity_is_the_bucket_of_its_longest_stream():
    """A group pads to the power of two (at least 8) that holds its
    longest leaf stream, whatever the process compiled before: compiling
    plans leaves no process-wide state that grouping reads."""
    assert [TQ._capacity_bucket(n) for n in (1, 8, 9, 16, 17, 1000)] == \
        [8, 8, 16, 16, 32, 1024]
    idx = index_from_reference(ref_index("equality"))
    be = TorchBackend(device="cpu")
    plans = [compile_plan(idx, p) for p in predicates(T)]
    first = be._group(plans)
    wide = T.BitmapIndex.build(table(n=20000, seed=9),
                               T.IndexSpec(k=1, row_order="lex"))
    for _ in range(40):
        for p in predicates(T):
            compile_plan(wide, p)
    plans = [compile_plan(idx, p) for p in predicates(T)]
    groups = be._group(plans)
    assert list(groups) == list(first)
    for (_, _, cap, _), idxs in groups.items():
        longest = max(len(s) for i in idxs for s in plans[i].streams)
        assert cap == max(8, 1 << (longest - 1).bit_length())
        assert cap == TQ._capacity_bucket(longest)


def test_entry_points_answer_like_evaluate_mask():
    cols = table(seed=5)
    idx = T.BitmapIndex.build(cols, T.IndexSpec(row_order="lex",
                                                encoding="auto"))
    preds = predicates(T)
    got = idx.query_many(preds, device="cpu")
    for p, (rows, _) in zip(preds, got):
        want = np.flatnonzero(T.evaluate_mask(p, cols))
        np.testing.assert_array_equal(np.sort(idx.row_perm[rows]), want)
        s = idx.query_compressed(p, device="cpu", fuse=False)
        np.testing.assert_array_equal(np.sort(idx.row_perm[s.to_rows()]), want)
        rows1, _ = idx.query(p, device="cpu")
        np.testing.assert_array_equal(rows1, rows)


def test_host_reencode_above_max_dirty():
    """Rows past MAX_DIRTY words, which the reference re-encodes on the
    host, encode on the device program's encoder (its plain version
    here), fused and per stage; results stay identical to the numpy
    backend."""
    from repro_torch.core import ewah

    n = (ewah.MAX_DIRTY + 2) * ewah.WORD_BITS
    r = np.random.default_rng(2)
    cols = [np.sort(r.integers(0, 3, size=n)), r.integers(0, 5, size=n)]
    idx = T.BitmapIndex.build(cols, T.IndexSpec(row_order="unsorted",
                                                column_order="given"))
    plans = [compile_plan(idx, p) for p in
             (T.Eq(0, 1), T.Or(T.Eq(0, 2), T.Not(T.Eq(1, 0))))]
    want = NumpyBackend().execute_compressed_many(plans)
    for fuse in (True, False):
        got = TorchBackend(device="cpu", fuse=fuse).execute_compressed_many(
            plans)
        for s, w in zip(got, want):
            np.testing.assert_array_equal(s.data, w.data)


def test_result_cache_hits_on_repeat():
    idx = index_from_reference(ref_index("equality"))
    plans = [compile_plan(idx, p) for p in predicates(T)]
    be = TorchBackend(device="cpu")
    first = be.execute_compressed_many(plans)
    be.result_cache.hits = be.result_cache.misses = 0
    again = be.execute_compressed_many(plans)
    assert be.result_cache.hit_rate == 1.0
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a.data, b.data)
        assert b.words_scanned == 0


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        TorchBackend()
    with pytest.raises(RuntimeError, match="CUDA device"):
        TorchBackend(device="cuda")
    idx = T.BitmapIndex.build(table(n=300), T.IndexSpec())
    with pytest.raises(RuntimeError, match="CUDA device"):
        idx.query(T.Eq(0, 1))
    assert TorchBackend(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("fuse", [True, False])
def test_roaring_plans_answer_like_numpy(fuse):
    """Roaring columns' container folds run on the torch backend (the
    plain versions of the containerops and member kernels here) and answer
    like ``NumpyBackend`` and ``evaluate_mask``."""
    cols = table(n=700, seed=4)
    idx = T.BitmapIndex.build(cols, T.IndexSpec(encoding="roaring"))
    assert set(idx.encodings()) == {"roaring"}
    preds = predicates(T)
    plans = [compile_plan(idx, p) for p in preds]
    be = TorchBackend(device="cpu", fuse=fuse)
    got = be.execute_compressed_many(plans)
    rows = be.execute_many(plans)
    want = NumpyBackend().execute_compressed_many(plans)
    for p, s, w, (r, _) in zip(preds, got, want, rows):
        np.testing.assert_array_equal(s.data, w.data)
        np.testing.assert_array_equal(r, w.to_rows())
        np.testing.assert_array_equal(np.sort(idx.row_perm[r]),
                                      np.flatnonzero(T.evaluate_mask(p, cols)))


def test_package_imports_no_jax_and_no_reference():
    code = (
        "import pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print('LOADED', len([m for m in sys.modules\n"
        "                     if m.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20
