"""The benchmark's layout and contract, checked on the CPU: every cell
resolves by name to its files, names and units keep to their characters,
generators and traffic repeat for a seed, a new cell needs new files
only, nothing imports JAX, and the command refuses to run without a
card."""

import ast
import datetime
import json
import re
import subprocess
import sys

import numpy as np
import pytest

from h100_bench.tests.helpers_h100bench import BENCH, REPO, run_small, \
    small_root
from h100_bench import harness, workload
from h100_bench.data.tables import make_table

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["h100_bench"]
    assert all(not w.startswith("/") and ".." not in w
               for w in SPEC["command"])
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c, config, mix = harness.resolve(SPEC, REPO, cell)
    cfg = next(x for x in SPEC["configs"] if x["name"] == c["config"])
    assert cfg["file"].startswith("h100_bench/configs/")
    assert (BENCH / "traffic" / f"{c['traffic']}.json").is_file()
    assert config["reduced"] == cfg["reduced"]
    assert mix["entry"] in ("compressed", "rows")
    for traced in (False, True):
        for m in harness.metrics_of(SPEC, cell, traced):
            assert callable(harness.reader(BENCH, m["name"]))
    reported = {m["name"] for m in harness.metrics_of(SPEC, cell, False)}
    assert "setup_s" in reported and len(reported) >= 2
    assert harness.metrics_of(SPEC, cell, True)
    for m in harness.metrics_of(SPEC, cell, True):
        assert m["moves"] in reported


def test_names_units_and_keys():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert 0 < len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for c in SPEC["workloads"]:
        assert NAME.match(c["traffic"]) and c["chips"] in (1, 4)
        assert 0 < len(c["why"]) <= 200
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert 0 < len(c["source"]) <= 200


MIXES = ("tpch-stream", "tpch-stream-rowids", "tpch-q17")


def _config(rows=None):
    config = json.loads((BENCH / "configs" / "dbgen-4d.json").read_text())
    if rows:
        config["rows"] = rows
    return config


def test_generators_repeat_for_a_seed():
    config = _config(5000)
    seed = 2**31 + 12345
    a = make_table(config, workload.rng_for(seed, workload.STREAM_DATA))
    b = make_table(config, workload.rng_for(seed, workload.STREAM_DATA))
    c = make_table(config, workload.rng_for(seed + 1, workload.STREAM_DATA))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert [int(x.max()) < int(col["card"]) for x, col in zip(
        a, config["columns"])] == [True] * 4


@pytest.mark.parametrize("mix", MIXES)
def test_traffic_repeats_for_a_seed(mix):
    seed = 2**31 + 12345
    m = workload.load(BENCH, mix)
    t1 = workload.Traffic(m, _config(), seed)
    t2 = workload.Traffic(m, _config(), seed)
    assert t1.batch(3) == t2.batch(3)
    assert t1.batch(3) != t1.batch(4)
    assert t1.warmup(0) == t2.warmup(0) != t1.batch(0)
    assert len(t1.batch(0)) == m["batch"]
    assert m["source"].startswith("TPC-H")


def test_every_seed_deals_the_same_predicates_in_another_order():
    m = workload.load(BENCH, "tpch-stream")
    a = workload.Traffic(m, _config(), 11)
    b = workload.Traffic(m, _config(), 12)
    assert [a.batch(k) for k in range(5)] != [b.batch(k) for k in range(5)]
    # each template's parameter sets come once before any comes again
    for t, size in enumerate(a.sizes):
        first_a = [repr(a.batch(k)[t]) for k in range(size)]
        first_b = [repr(b.batch(k)[t]) for k in range(size)]
        assert len(set(first_a)) == size
        assert sorted(first_a) == sorted(first_b)
    assert a.sizes == [61, 31, 40, 1, 105, 60, 58]


def _day(y, mth, d):
    return (datetime.date(y, mth, d) - datetime.date(1992, 1, 2)).days


def _next_month(y, mth, n):
    k = mth - 1 + n
    return datetime.date(y + k // 12, k % 12 + 1, 1)


def test_stream_parameters_are_the_tpch_substitutions():
    """The day numbers of tpch-stream.json against TPC-H 2.4's rules, with
    l_shipdate counted in days since 1992-01-02."""
    m = workload.load(BENCH, "tpch-stream")
    choices = {t["name"]: [c["choices"] for c in t["clauses"]
                           if "choices" in c] for t in m["templates"]}
    last = _day(1998, 12, 1)
    assert last == 2525 == _config()["columns"][2]["card"] - 1
    years = [[_day(y, 1, 1), _day(y + 1, 1, 1) - 1] for y in range(1993, 1998)]
    assert choices["Q1"] == [[[0, last - d] for d in range(60, 121)]]
    assert choices["Q3"] == [[[_day(1995, 3, d) + 1, last]
                              for d in range(1, 32)]]
    assert choices["Q6"] == [years, [[d - 1, d + 1] for d in range(2, 10)]]
    assert choices["Q7"] == [[[_day(1995, 1, 1), _day(1996, 12, 31)]]]
    assert choices["Q12"] == [years]
    months = [(y, mth) for y in range(1993, 1998) for mth in range(1, 13)]
    assert choices["Q14"] == [[
        [_day(y, mth, 1), (_next_month(y, mth, 1)
                           - datetime.date(1992, 1, 2)).days - 1]
        for y, mth in months]]
    assert choices["Q15"] == [[
        [_day(y, mth, 1), (_next_month(y, mth, 3)
                           - datetime.date(1992, 1, 2)).days - 1]
        for y, mth in months if (y, mth) <= (1997, 10)]]


def test_q17_selects_the_parts_of_one_brand_and_container():
    config = _config()
    t = workload.Traffic(workload.load(BENCH, "tpch-q17"), config, 5)
    part = t.tables["part"]
    (kind, col, keys), = t.batch(0)
    assert kind == "in" and config["columns"][col]["name"] == "l_partkey"
    assert len({int(part["p_brand"][k]) for k in keys}) == 1
    assert len({int(part["p_container"][k]) for k in keys}) == 1
    # TPC-H's 25 brands x 40 containers: about one part in 1,000
    assert 300 < len(keys) < 500
    assert t.sizes == [1000]


def test_stream_tapes_fit_planfuse_and_q17_runs_per_stage():
    """Every tpch-stream plan runs as one fused launch; a Q17 IN-list's
    tape is past the fused kernel's gate."""
    from h100_bench.program import Program
    from repro_torch.core.query import lower_plan
    from repro_torch.kernels import planfuse

    config = _config(20_003)
    prog = Program(config, "compressed", "cpu")
    prog.build(make_table(config, workload.rng_for(3, workload.STREAM_DATA)))
    t = workload.Traffic(workload.load(BENCH, "tpch-stream"), config, 3)
    for p in prog.plans([q for k in range(8) for q in t.batch(k)]):
        assert planfuse.fits(*lower_plan(p.root))
    t = workload.Traffic(workload.load(BENCH, "tpch-q17"), config, 3)
    for p in prog.plans(t.batch(0)):
        assert not planfuse.fits(*lower_plan(p.root))


def _add_cell(root, name, config, traffic, metric=None):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    if config not in {c["name"] for c in spec["configs"]}:
        spec["configs"].append({"name": config, "source": "a test",
                                "file": f"h100_bench/configs/{config}.json",
                                "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": name, "config": config,
                              "traffic": traffic, "chips": 1,
                              "why": "a test"})
    if metric:
        spec["end_to_end"].append({"name": metric, "unit": "count",
                                   "better": "higher", "bound": 0.25,
                                   "source": "host_clock",
                                   "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def test_a_new_cell_needs_new_files_only(tmp_path):
    root = small_root(tmp_path, rows=8003)
    cfg = _config(8003)
    cfg.update(name="toy-2d", columns=[
        {"name": "a", "card": 5, "dist": "uniform"},
        {"name": "b", "card": 300, "dist": "zipf", "skew": 1.1}])
    cfg.pop("tables")
    (root / "h100_bench" / "configs" / "toy-2d.json").write_text(
        json.dumps(cfg))
    (root / "h100_bench" / "traffic" / "toy-mix.json").write_text(
        json.dumps({"source": "a test", "entry": "compressed",
                    "kind": "templates", "batch": 4,
                    "checks_per_batch": 2, "max_checks": 8,
                    "templates": [{"name": "T", "count": 4, "clauses": [
                        {"op": "in", "column": "a", "distinct": 2},
                        {"op": "range", "column": "b",
                         "choices": [[10, 60], [0, 150]]}]}]}))
    (root / "h100_bench" / "metrics" / "toy_batches.py").write_text(
        "def read(run):\n    return len(run.latencies_s)\n")
    _add_cell(root, "toy-2d.toy-mix", "toy-2d", "toy-mix", "toy_batches")
    r = run_small(root, "toy-2d.toy-mix")
    assert r["correct"], r["checks"]
    assert r["metrics"]["toy_batches"]["value"] >= 1
    assert {"queries_per_s", "setup_s", "index_bytes_per_row"} <= set(
        r["metrics"])
    assert list(r)[-1] == "checks"


def test_the_q17_mix_is_a_cell_by_an_entry_alone(tmp_path):
    """The Q17 mix is kept for a cell that fits the card; adding that cell
    takes one entry in BENCHMARK.json."""
    root = small_root(tmp_path, rows=8003)
    _add_cell(root, "dbgen-4d.tpch-q17", "dbgen-4d", "tpch-q17")
    r = run_small(root, "dbgen-4d.tpch-q17", seconds=0.1)
    assert r["correct"], (r["checks"], r.get("failures"))
    assert r["attempted"] >= 1


def test_nothing_loads_jax_or_the_jax_package(tmp_path):
    root = small_root(tmp_path, rows=8003)
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]\n"
        "from h100_bench.tests.helpers_h100bench import run_small\n"
        "from pathlib import Path\n"
        f"r = run_small(Path({str(root)!r}), 'dbgen-4d.tpch-stream',"
        " traced=True)\n"
        "from h100_bench import control, harness\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    code = ("import sys, json\n"
            f"sys.path[:0] = [{str(REPO)!r}]\n"
            "import h100_bench.reference.evaluate, h100_bench.reference.ewah\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'repro_torch', 'repro', 'jax', 'torch'})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_source_of_the_benchmark_imports_jax_or_the_reference_package():
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and not node.level else [])
            for n in names:
                assert n.split(".")[0] not in harness.FORBIDDEN, (path, n)
                if "reference" in path.parts:
                    assert n.split(".")[0] in ("numpy", "__future__"), (
                        path, n)


def test_command_refuses_to_run_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal needs none")
    out = subprocess.run(
        [sys.executable, str(REPO / "h100_bench" / "run.py"), "--workload",
         "dbgen-4d.tpch-stream", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, str(REPO / "h100_bench" / "run.py"), "--workload",
         "dbgen-4d.tpch-stream", "--seed", "5", "--seconds", "2",
         "--trace", "1"], capture_output=True, text=True, timeout=900,
        cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0
