"""Shared set-up of the benchmark's CPU tests: a copy of the benchmark's
data files in a temporary directory, with every configuration cut to a
size a test run can hold, run on the port's plain versions."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for _p in (REPO / "src", REPO):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

BENCH = REPO / "h100_bench"


def small_root(tmp: Path, rows: int = 12_003) -> Path:
    """A root holding BENCHMARK.json and a copy of the benchmark's
    configurations, traffic mixes and metric readers, each configuration
    at ``rows`` rows (by default not a whole number of 32-row words, so
    the last word holds padding) and each mix with one warm-up batch."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(BENCH / "metrics", tmp / "h100_bench" / "metrics")
    (tmp / "h100_bench" / "traffic").mkdir(parents=True)
    for f in (BENCH / "traffic").glob("*.json"):
        mix = json.loads(f.read_text())
        mix["warmup_batches"] = 1
        (tmp / "h100_bench" / "traffic" / f.name).write_text(json.dumps(mix))
    (tmp / "h100_bench" / "configs").mkdir(parents=True)
    for f in (BENCH / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["rows"] = rows
        (tmp / "h100_bench" / "configs" / f.name).write_text(json.dumps(c))
    return tmp


def run_small(root: Path, cell: str, seed: int = 7, seconds: float = 0.3,
              traced: bool = False, make_program=None) -> dict:
    from h100_bench import harness

    return harness.run(cell, seed, seconds, traced, root=root,
                       bench_dir=root / "h100_bench", device="cpu",
                       make_program=make_program)
