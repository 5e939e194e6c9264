"""The port's index build and ``TorchBackend`` against the reference.

* ``repro_torch`` builds the same streams, ``row_perm`` and ``col_perm`` as
  ``repro.core.BitmapIndex.build`` for every stream encoding;
* ``TorchBackend(device="cpu")``, fused and per stage, returns EWAH
  streams and row ids identical to ``JaxBackend`` (its jnp reference path)
  and ``NumpyBackend``, on an index carried across by
  ``convert.index_from_reference``, with the ``PREDICATES`` of
  test_planfuse.py, also under ``REPRO_SANITIZE=1``;
* the Hopper gate, the CUDA-only default device, the unported container
  fold, and the package's import isolation.

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

ENCODINGS = ["equality", "bitsliced", "bitsliced-gray", "binned"]


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
        assert len(cg.streams) == len(cw.streams)
        for sg, sw in zip(cg.streams, cw.streams):
            np.testing.assert_array_equal(sg, sw)
        np.testing.assert_array_equal(cg.sizes, cw.sizes)


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
    jax_streams = JaxBackend(use_kernel=False).execute_compressed_many(r_plans)
    np_streams = [RefNumpyBackend().execute_compressed(p) for p in r_plans]
    jax_rows = (JaxBackend(use_kernel=False).execute_many(r_plans)
                if encoding == "equality" else None)
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
    idx = index_from_reference(ref_index("equality"))
    plan = compile_plan(idx, predicates(T)[-1])
    assert TorchBackend(device="cpu")._fused_tape(plan.root) is not None
    assert TorchBackend(device="cpu", fuse=False)._fused_tape(plan.root) is None


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


def test_hopper_gate_sends_deep_plans_per_stage():
    be = TorchBackend(device="cpu")
    ok = _deep_root(planfuse.MAX_STACK_DEPTH)
    deep = _deep_root(planfuse.MAX_STACK_DEPTH + 1)
    assert TQ.lower_plan(deep)[1] == planfuse.MAX_STACK_DEPTH + 1
    assert be._fused_tape(ok) is not None
    assert be._fused_tape(deep) is None
    long_tape = ("or", tuple(("leaf", i)
                             for i in range(planfuse.MAX_TAPE_LEN // 2 + 1)))
    assert be._fused_tape(long_tape) is None


def test_gated_plans_run_per_stage_and_agree(monkeypatch):
    idx = index_from_reference(ref_index("equality"))
    plans = [compile_plan(idx, p) for p in predicates(T)]
    want = NumpyBackend().execute_compressed_many(plans)
    monkeypatch.setattr(planfuse, "MAX_STACK_DEPTH", 1)
    be = TorchBackend(device="cpu")
    got = be.execute_compressed_many(plans)
    assert be._fused_tape(plans[4].root) is None   # depth 2: per stage
    assert be._fused_tape(plans[0].root) is not None
    for s, w in zip(got, want):
        np.testing.assert_array_equal(s.data, w.data)


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
    """Rows past MAX_DIRTY words re-encode on the host, as in the
    reference; results stay identical to the numpy backend."""
    from repro_torch.core import ewah

    n = (ewah.MAX_DIRTY + 2) * ewah.WORD_BITS
    r = np.random.default_rng(2)
    cols = [np.sort(r.integers(0, 3, size=n)), r.integers(0, 5, size=n)]
    idx = T.BitmapIndex.build(cols, T.IndexSpec(row_order="unsorted",
                                                column_order="given"))
    plans = [compile_plan(idx, p) for p in
             (T.Eq(0, 1), T.Or(T.Eq(0, 2), T.Not(T.Eq(1, 0))))]
    got = TorchBackend(device="cpu").execute_compressed_many(plans)
    want = NumpyBackend().execute_compressed_many(plans)
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


def test_container_fold_not_ported():
    cols = table(n=700, seed=4)
    idx = T.BitmapIndex.build(cols, T.IndexSpec(encoding="roaring"))
    plan = compile_plan(idx, T.Eq(0, 1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchBackend(device="cpu").execute_compressed(plan)
    # the host backend still answers Roaring plans
    rows = NumpyBackend().execute(compile_plan(idx, T.Eq(0, 1)))[0]
    np.testing.assert_array_equal(np.sort(idx.row_perm[rows]),
                                  np.flatnonzero(cols[0] == 1))


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
