"""The Q17 cell's readers on the CPU: ``planes_per_query`` (counter
``backend.planes``) and ``stage_ms_per_query`` (span ``backend.stages``)
give None without the program's totals, and read them from a small traced
run of ``dbgen-4d.tpch-q17``: every leaf reference of an IN-list on the
bit-sliced key column reads one of its slices, each decoded once."""

import sys

import pytest

from h100_bench.tests.helpers_h100bench import BENCH, run_small, small_root
from h100_bench import harness, totals

Q17, STREAM = "dbgen-4d.tpch-q17", "dbgen-4d.tpch-stream"
READERS = ("planes_per_query", "stage_ms_per_query")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("q17"))


@pytest.fixture
def tracing():
    from repro_torch import tracing

    tracing.reset()   # pytest shares one process between runs
    yield tracing
    tracing.reset()


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_totals(monkeypatch, tracing, name):
    run = harness.Run(cell={}, config={}, mix={}, queries=7,
                      latencies_s=[0.5])
    read = harness.reader(BENCH, name)
    assert read(run) is None                 # the module recorded nothing
    monkeypatch.delitem(sys.modules, totals.MODULE, raising=False)
    assert read(run) is None                 # no module at all


def test_q17_cell_reads_the_planes_and_the_stages_span(root, tracing):
    r = run_small(root, Q17, traced=True)
    assert r["correct"], (r["checks"], r.get("failures"))
    snap = totals.totals()
    planes = snap["counters"]["backend.planes"]
    refs = snap["counters"]["backend.leaf_refs"]
    n = r["attempted"]
    got = r["metrics"]["planes_per_query"]["value"]
    assert got == pytest.approx(planes / n)
    # 19 slices of l_partkey (400,000 keys); at most one constant leaf more
    assert 19 <= got <= 20 and refs >= 300 * 19 * n
    stages = snap["spans"]["backend.stages"]
    assert stages["n"] == n
    assert r["metrics"]["stage_ms_per_query"]["value"] == pytest.approx(
        1e3 * stages["s"] / n)


def test_stream_cell_reads_fewer_planes_than_leaf_references(root, tracing):
    """Ranges on the bit-sliced ``l_shipdate`` read some slices from both
    ends; the stream's plans all run fused, so no stage span."""
    r = run_small(root, STREAM, traced=True)
    snap = totals.totals()
    assert r["metrics"]["planes_per_query"]["value"] * r["attempted"] == \
        pytest.approx(snap["counters"]["backend.planes"])
    assert snap["counters"]["backend.planes"] < \
        snap["counters"]["backend.leaf_refs"]
    assert "stage_ms_per_query" not in r["metrics"]
    assert "backend.stages" not in snap["spans"]
