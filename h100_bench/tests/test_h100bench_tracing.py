"""The readers of the program's own spans and counters, on the CPU: a
traced run of each cell reports every metric that names the cell, the
backend's self time and its child spans add up to the call, and the
control, which records nothing, reports none of them."""

import json
import sys

import pytest

from h100_bench.tests.helpers_h100bench import REPO, run_small, small_root
from h100_bench import harness, totals
from h100_bench.control import ControlProgram

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
READERS = [m for m in SPEC["per_layer"]
           if m["source"] in ("program_span", "program_counter")]
CELLS = [c["name"] for c in SPEC["workloads"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def tracing():
    from repro_torch import tracing

    tracing.reset()   # pytest shares one process between runs
    yield tracing
    tracing.reset()


def test_every_cell_has_program_readers():
    assert {"plan_span_ms_per_query", "key_ms_per_batch", "pad_ms_per_batch",
            "h2d_wait_ms_per_batch", "padding_share", "groups_per_batch",
            "device_wait_ms_per_batch", "reencode_ms_per_batch",
            "unpack_ms_per_batch", "backend_self_ms_per_batch"} <= {
                m["name"] for m in READERS}
    for cell in CELLS:
        assert [m for m in READERS if cell in m["workloads"]], cell
    for m in READERS:
        assert m["moves"] == "queries_per_s"
        assert callable(harness.reader(REPO / "h100_bench", m["name"]))


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_each_metric_of_its_cell(root, tracing, cell):
    r = run_small(root, cell, traced=True)
    assert r["correct"], r["checks"]
    for m in READERS:
        if cell in m["workloads"]:
            v = r["metrics"][m["name"]]["value"]
            assert v >= 0, (m["name"], v)
    spans = totals.totals()["spans"]
    call = spans["backend.call"]
    children = sum(v["s"] for k, v in spans.items()
                   if k.startswith("backend.") and k != "backend.call")
    assert call["self_s"] + children == pytest.approx(call["s"], rel=0.01)
    assert r["metrics"]["groups_per_batch"]["value"] >= 1
    assert 0 < r["metrics"]["padding_share"]["value"] < 100


@pytest.mark.parametrize("cell", CELLS)
def test_readers_find_nothing_with_the_control(root, tracing, cell):
    def make(config, entry, device):
        return ControlProgram(config, entry, device, "approx")

    r = run_small(root, cell, traced=True, make_program=make)
    assert totals.totals() is None
    assert not {m["name"] for m in READERS} & set(r["metrics"])


def test_readers_find_nothing_without_the_module(monkeypatch):
    """A program without the module (an older commit): no value, no
    error."""
    monkeypatch.delitem(sys.modules, totals.MODULE, raising=False)
    run = harness.Run(cell={}, config={}, mix={}, queries=7,
                      latencies_s=[0.5])
    for m in READERS:
        assert harness.reader(REPO / "h100_bench", m["name"])(run) is None
