"""``repro_torch.tracing`` and the spans and counters of the query path.

* the module: off by default with one shared no-op span, on under
  ``enable()`` and while a ``torch.profiler`` session records, self time
  of nested spans, counters, ``reset``, two threads at once, and the
  ``repro.<name>`` host ranges a profiler sees (host-only spans alone);
* ``TorchBackend(device="cpu")``: the same answers with tracing on as off,
  the spans of every layer boundary, the copied and stream bytes, the
  leaf references and the distinct planes decoded, the per-stage span,
  and past ``ewah.MAX_DIRTY`` words the encoder's counters, with no host
  re-encode;
* ``launch.serve``'s phase report, read from the module.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core import (And, BitmapIndex, Eq, In, IndexSpec, Not,
                              Range, ewah)
from repro_torch.core.query import NumpyBackend, TorchBackend, compile_plan
from torch_encode_cases import overflows

BACKEND_SPANS = ("backend.call", "backend.pad", "backend.h2d",
                 "backend.device")
DEVICE_SPANS = ("backend.call", "backend.h2d", "backend.device")


@pytest.fixture(autouse=True)
def clean():
    """Every test starts and ends with tracing off and no totals."""
    prev = tracing.enable(False)
    tracing.reset()
    yield
    tracing.enable(prev)
    tracing.reset()


def test_off_by_default_with_one_shared_no_op():
    assert not tracing.enabled()
    a = tracing.span("a")
    b = tracing.span("b", device=True)
    assert a is b
    with a, b:
        tracing.add("c", 5)
    assert tracing.snapshot() == {"spans": {}, "counters": {}}


def test_one_span_off_costs_no_more_than_an_empty_context():
    """A span off against ``nullcontext()``, in interleaved blocks so that
    load slows both alike; the best block of each reads its cost (about
    0.4 us each on an idle host)."""
    from contextlib import nullcontext

    def block(make, n=1_000):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with make():
                pass
        return (time.perf_counter_ns() - t0) / n

    best_span = best_null = float("inf")
    for _ in range(50):
        best_span = min(best_span, block(lambda: tracing.span("x")))
        best_null = min(best_null, block(nullcontext))
    assert best_span < 2 * best_null, f"{best_span} ns, {best_null} ns"
    assert tracing.snapshot()["spans"] == {}


def test_on_under_enable_and_under_a_profiler_session():
    assert tracing.enable() is False
    assert tracing.enabled()
    with tracing.span("on"):
        pass
    assert tracing.enable(False) is True
    assert not tracing.enabled()
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.enabled()
        with tracing.span("profiled"):
            pass
        tracing.add("n", 2)
    assert not tracing.enabled()
    with tracing.span("after"):
        pass
    snap = tracing.snapshot()
    assert set(snap["spans"]) == {"on", "profiled"}
    assert snap["spans"]["on"]["n"] == 1
    assert snap["counters"] == {"n": 2}


def test_nested_self_time():
    tracing.enable()
    with tracing.span("outer"):
        time.sleep(0.002)
        for _ in range(2):
            with tracing.span("inner"):
                time.sleep(0.003)
                with tracing.span("leaf"):
                    time.sleep(0.001)
    s = tracing.snapshot()["spans"]
    assert s["outer"]["n"] == 1 and s["inner"]["n"] == 2
    assert s["leaf"]["n"] == 2
    assert s["outer"]["self_s"] == pytest.approx(
        s["outer"]["s"] - s["inner"]["s"], abs=1e-9)
    assert s["inner"]["self_s"] == pytest.approx(
        s["inner"]["s"] - s["leaf"]["s"], abs=1e-9)
    assert s["leaf"]["self_s"] == s["leaf"]["s"]
    assert s["outer"]["self_s"] >= 0.002
    assert s["inner"]["self_s"] >= 2 * 0.003


def test_counters_and_reset():
    tracing.enable()
    tracing.add("bytes", 10)
    tracing.add("bytes", np.int64(32))
    tracing.add("groups", 1)
    with tracing.span("s"):
        pass
    snap = tracing.snapshot()
    assert snap["counters"] == {"bytes": 42, "groups": 1}
    snap["counters"]["bytes"] = 0   # a copy
    assert tracing.snapshot()["counters"]["bytes"] == 42
    tracing.reset()
    assert tracing.snapshot() == {"spans": {}, "counters": {}}


def test_two_threads_record_at_once():
    """Lost updates would show as counts short of the work done; each
    thread's self time is its own (its stack is per thread)."""
    tracing.enable()
    n = 2_000
    barrier = threading.Barrier(2)

    def work(tag):
        barrier.wait(timeout=30)
        for _ in range(n):
            with tracing.span("shared"):
                with tracing.span(f"child.{tag}"):
                    tracing.add("ticks", 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = tracing.snapshot()
    s = snap["spans"]
    assert s["shared"]["n"] == 2 * n
    assert s["child.a"]["n"] == s["child.b"]["n"] == n
    assert snap["counters"]["ticks"] == 2 * n
    assert s["shared"]["self_s"] == pytest.approx(
        s["shared"]["s"] - s["child.a"]["s"] - s["child.b"]["s"], abs=1e-8)


def _host_event_names(prof) -> set:
    return {e.name() for e in prof.profiler.kineto_results.events()}


def test_host_only_spans_reach_the_profiler_timeline():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("backend.call", device=True):
            with tracing.span("backend.reencode"):
                torch.ones(4).sum()
            with tracing.span("backend.h2d", device=True):
                torch.ones(4).sum()
    names = _host_event_names(prof)
    assert "repro.backend.reencode" in names
    assert not {"repro.backend.call", "repro.backend.h2d"} & names
    assert set(tracing.snapshot()["spans"]) == {
        "backend.call", "backend.reencode", "backend.h2d"}


# -- the backend's spans ----------------------------------------------------


def predicates():
    return [Eq(0, 2), Range(1, 3, 40), And(In(0, [1, 4]), Range(2, 0, 5)),
            Not(Eq(2, 7)), Eq(1, 11)]


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(27)
    n = 3_001
    cols = [rng.integers(0, 6, n), rng.integers(0, 60, n),
            rng.integers(0, 12, n)]
    return BitmapIndex.build(cols, IndexSpec(row_order="lex"))


@pytest.fixture(scope="module")
def wide_index():
    """The fewest rows past ``MAX_DIRTY`` words a row, where the
    reference re-encodes the compressed entry's answers on the host."""
    rng = np.random.default_rng(28)
    n = ewah.WORD_BITS * ewah.MAX_DIRTY + 1
    assert (n + ewah.WORD_BITS - 1) // ewah.WORD_BITS > ewah.MAX_DIRTY
    return BitmapIndex.build([rng.integers(0, 3, n)],
                             IndexSpec(row_order="unsorted",
                                       encoding="equality"))


@pytest.fixture(scope="module")
def sliced_index():
    """Bit-sliced columns: a range reads some slices from both of its
    ends, and an IN-list reads every slice once a key."""
    rng = np.random.default_rng(29)
    n = 3_001
    cols = [rng.integers(0, 600, n), rng.integers(0, 60, n)]
    return BitmapIndex.build(cols, IndexSpec(row_order="lex",
                                             encoding="bitsliced"))


def sliced_predicates():
    return [Range(0, 37, 410), In(0, [3, 90, 91, 92, 250, 511]),
            And(Range(1, 5, 44), Eq(0, 77)), Not(Range(0, 100, 599))]


def distinct_streams(plan):
    """The plan's leaf streams, each stream object once."""
    return list({id(s): s for s in plan.streams}.values())


def spy_copies(be):
    """Record (bytes, stream words) of every group ``_to_device`` copies."""
    seen = []
    orig = be._to_device

    def spy(batch, lengths):
        seen.append((batch.nbytes + lengths.nbytes, int(lengths.sum())))
        return orig(batch, lengths)

    be._to_device = spy
    return seen


def run_traced(entry, plans):
    be = TorchBackend(device="cpu", cache_size=0)
    seen = spy_copies(be)
    tracing.enable()
    out = getattr(be, entry)(plans)
    tracing.enable(False)
    return out, seen, tracing.snapshot()


def check_backend_totals(snap, plans, seen, n_groups):
    s, c = snap["spans"], snap["counters"]
    assert s["backend.call"]["n"] == 1
    assert s["backend.h2d"]["n"] == s["backend.device"]["n"] == n_groups
    assert s["backend.pad"]["n"] == n_groups + 1   # _group, each _pad_group
    assert c["backend.groups"] == n_groups == len(seen)
    assert c["backend.h2d_bytes"] == sum(b for b, _ in seen)
    assert c["backend.stream_bytes"] == 4 * sum(w for _, w in seen) == \
        4 * sum(len(st) for p in plans for st in distinct_streams(p))
    children = sum(v["s"] for k, v in s.items()
                   if k.startswith("backend.") and k != "backend.call")
    assert s["backend.call"]["self_s"] == pytest.approx(
        s["backend.call"]["s"] - children, abs=1e-8)


def test_compressed_entry_spans_and_answers(index):
    plans = [compile_plan(index, p) for p in predicates()]
    want = TorchBackend(device="cpu", cache_size=0).execute_compressed_many(
        plans)
    assert tracing.snapshot()["spans"] == {}
    got, seen, snap = run_traced("execute_compressed_many", plans)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.data, w.data)
    assert set(snap["spans"]) == {*BACKEND_SPANS, "backend.key"}
    assert snap["spans"]["backend.key"]["n"] == 1
    check_backend_totals(snap, plans, seen, len(plans))


def test_rows_entry_spans_and_answers(index):
    plans = [compile_plan(index, p) for p in predicates()]
    want = TorchBackend(device="cpu", cache_size=0).execute_many(plans)
    got, seen, snap = run_traced("execute_many", plans)
    for (gr, gw), (wr, ww) in zip(got, want):
        np.testing.assert_array_equal(gr, wr)
        assert gw == ww
    assert set(snap["spans"]) == {*BACKEND_SPANS, "backend.unpack"}
    assert snap["spans"]["backend.unpack"]["n"] == len(plans)
    check_backend_totals(snap, plans, seen, len(plans))


def test_planning_is_a_span(index):
    tracing.enable()
    for p in predicates():
        compile_plan(index, p)
    assert tracing.snapshot()["spans"]["query.plan"]["n"] == len(
        predicates())


def test_host_reencode_past_max_dirty_one_span_an_answer(wide_index):
    """Past ``MAX_DIRTY`` words no answer re-encodes on the host: the
    ``backend.reencode`` span is never entered, ``backend.encoded`` counts
    every answer the device encoder wrote, ``backend.encoded_overflow``
    those whose stream splits a run, and the answers are the numpy
    backend's."""
    plans = [compile_plan(wide_index, p)
             for p in (Eq(0, 1), Not(Eq(0, 2)), In(0, [0, 2]))]
    want = NumpyBackend().execute_compressed_many(plans)
    got, seen, snap = run_traced("execute_compressed_many", plans)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.data, w.data)
    assert "backend.reencode" not in snap["spans"]
    assert snap["counters"]["backend.encoded"] == len(plans)
    n_words = -(-wide_index.n_rows // ewah.WORD_BITS)
    assert snap["counters"]["backend.encoded_overflow"] == sum(
        overflows(ewah.decompress(g.data, n_words)) for g in got) > 0
    check_backend_totals(snap, plans, seen, len(plans))


@pytest.mark.parametrize("entry", ["execute_compressed_many",
                                   "execute_many"])
def test_shared_leaves_are_padded_and_counted_once(sliced_index, entry):
    """``backend.leaf_refs`` counts every leaf of the plans sent to the
    device, ``backend.planes`` and the stream bytes each distinct stream
    of a plan once; the answers are the numpy backend's."""
    plans = [compile_plan(sliced_index, p) for p in sliced_predicates()]
    assert any(len(distinct_streams(p)) < len(p.streams) for p in plans)
    want = NumpyBackend().execute_compressed_many(plans)
    got, seen, snap = run_traced(entry, plans)
    for g, w in zip(got, want):
        if entry == "execute_many":
            np.testing.assert_array_equal(g[0], w.to_rows())
        else:
            np.testing.assert_array_equal(g.data, w.data)
    c = snap["counters"]
    assert c["backend.leaf_refs"] == sum(len(p.streams) for p in plans)
    assert c["backend.planes"] == sum(len(distinct_streams(p))
                                      for p in plans) < c["backend.leaf_refs"]
    check_backend_totals(snap, plans, seen, len(plans))


def per_stage_traced(entry, plans):
    be = TorchBackend(device="cpu", cache_size=0, fuse=False)
    seen = spy_copies(be)
    tracing.enable()
    out = getattr(be, entry)(plans)
    tracing.enable(False)
    return out, seen, tracing.snapshot()


@pytest.mark.parametrize("entry", ["execute_compressed_many",
                                   "execute_many"])
def test_per_stage_groups_enter_the_stages_span(sliced_index, entry):
    """Each group that runs per stage enters ``backend.stages`` once, beside
    (not inside) ``backend.device``, so the call's self time and its
    children still add up; fused groups never enter it."""
    plans = [compile_plan(sliced_index, p) for p in sliced_predicates()]
    _, _, fused = run_traced(entry, plans)
    assert "backend.stages" not in fused["spans"]
    tracing.reset()
    got, seen, snap = per_stage_traced(entry, plans)
    assert snap["spans"]["backend.stages"]["n"] == len(plans)
    assert snap["spans"]["backend.device"]["n"] == len(plans)
    check_backend_totals(snap, plans, seen, len(plans))


def test_device_spans_stay_off_the_profiler_timeline(index):
    plans = [compile_plan(index, p) for p in predicates()]
    be = TorchBackend(device="cpu", cache_size=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        be.execute_many(plans)
    names = _host_event_names(prof)
    assert {"repro.backend.pad", "repro.backend.unpack"} <= names
    assert not {"repro." + n for n in DEVICE_SPANS} & names


def test_stages_span_stays_off_the_profiler_timeline(sliced_index):
    """``backend.stages`` encloses device work: no ``repro.`` range."""
    plans = [compile_plan(sliced_index, p) for p in sliced_predicates()]
    be = TorchBackend(device="cpu", cache_size=0, fuse=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        be.execute_compressed_many(plans)
    names = _host_event_names(prof)
    assert "repro.backend.pad" in names
    assert not {"repro." + n for n in (*DEVICE_SPANS, "backend.stages")} \
        & names
    assert tracing.snapshot()["spans"]["backend.stages"]["n"] == len(plans)


# -- the serve launcher's phases ---------------------------------------------


def test_serve_phases_come_from_the_module(capsys):
    from repro_torch.launch import serve

    got = serve.main(["--device", "cpu", "--requests", "8", "--batch", "4",
                      "--gen-tokens", "2"])
    assert set(got["phases"]) == {"pack", "prefill", "decode"}
    assert all(v > 0 for v in got["phases"].values())
    assert not tracing.enabled()
    spans = tracing.snapshot()["spans"]
    assert spans["serve.decode"]["n"] == 2   # one step a batch of 4
    assert spans["backend.call"]["n"] >= 1
