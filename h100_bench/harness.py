"""Run one cell of ``BENCHMARK.json``: set-up, the measured window, the
trace (``--trace 1``), the metrics, and the comparison that decides
``correct``.  Nothing here knows a particular cell: the configuration,
the traffic mix and each metric's reader are files found by name.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import check, roofline, trace as trace_mod, workload
from .data.tables import make_table

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # whole top-level names
PROFILER_PRIMING = 256   # device ops the trace starts with, then ignores


@dataclass
class Run:
    """Everything a metric's reader may read."""
    cell: dict
    config: dict
    mix: dict
    setup_s: float = 0.0
    index_build_s: float = 0.0
    index_words: int = 0
    n_rows: int = 0
    window_s: float = 0.0
    queries: int = 0
    latencies_s: list = field(default_factory=list)
    spans_s: dict = field(default_factory=dict)    # summed host spans
    cache: dict | None = None                      # result-cache deltas
    trace: trace_mod.TraceSummary | None = None
    needed_bytes: int = 0                          # traced runs only


def load_benchmark(root) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def resolve(bench: dict, root, name: str, bench_dir=BENCH_DIR):
    """(cell, configuration, traffic mix) of the cell ``name``."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((Path(root) / cfg["file"]).read_text())
    return cell, config, workload.load(bench_dir, cell["traffic"])


def metrics_of(bench: dict, cell: str, traced: bool) -> list:
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(bench_dir, name: str):
    path = Path(bench_dir) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "h100_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Spans:
    """Host-clock spans of the window; in a traced run each is also a
    profiler ``record_function`` named ``bench.<name>``."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.total_s: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        ctx = contextlib.nullcontext()
        if self.traced:
            from torch.profiler import record_function
            ctx = record_function(trace_mod.SPAN_PREFIX + name)
        t0 = time.perf_counter()
        with ctx:
            yield
        self.total_s[name] = (self.total_s.get(name, 0.0)
                              + time.perf_counter() - t0)


def sync(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the measuring process must
    not hold (run.py checks once the run is over)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(workload_name: str, seed: int, seconds: float, traced: bool, *,
        root=None, bench_dir=BENCH_DIR, device: str = "cuda",
        make_program=None, t_process: float | None = None) -> dict:
    """One run of one cell; returns the result object (see ``run.py``).
    ``make_program(config, entry, device)`` stands in for the program
    (the control and the fault tests use it)."""
    t_process = time.perf_counter() if t_process is None else t_process
    root = Path(root) if root is not None else bench_dir.parent
    bench = load_benchmark(root)
    cell, config, mix = resolve(bench, root, workload_name, bench_dir)
    if make_program is None:
        from .program import Program as make_program
    prog = make_program(config, mix["entry"], device)
    traffic = workload.Traffic(mix, config, seed)
    out = Run(cell=cell, config=config, mix=mix)

    # -- set-up: data, index, the cell's own shapes warmed up ------------
    cols = make_table(config, workload.rng_for(seed, workload.STREAM_DATA))
    out.index_build_s = prog.build(cols)
    out.index_words = prog.index_words()
    out.n_rows = prog.n_rows
    _warm_up(prog, traffic, mix, device)
    prog.clear_cache()
    cache0 = prog.cache_stats()
    sync(device)
    out.setup_s = time.perf_counter() - t_process

    # -- the window -------------------------------------------------------
    spans = Spans(traced)
    prof = _start_profiler(device) if traced else None
    if prof is not None:
        from torch.profiler import record_function
        with record_function(trace_mod.SPAN_PREFIX + "window"):
            t_start, batches = _window(prog, traffic, seconds, spans,
                                       traced, device, seed, mix)
        sync(device)
        prof.__exit__(None, None, None)
    else:
        t_start, batches = _window(prog, traffic, seconds, spans, traced,
                                   device, seed, mix)
    cache1 = prog.cache_stats()
    out.cache = {k: cache1[k] - cache0[k] for k in ("hits", "misses")}
    out.window_s = batches[-1]["done"] - t_start
    out.queries = sum(b["n"] for b in batches)
    out.latencies_s = [b["done"] - b["submit"] for b in batches]
    out.spans_s = dict(spans.total_s)
    device_info = _device(device)
    if prof is not None:
        out.trace = trace_mod.summarize(prof)
        out.needed_bytes = _needed_bytes(prog, batches)

    # -- correct: the window's answers against the reference -------------
    samples = _sample(batches, seed, mix)
    numbers, named = check.compare(samples, cols, prog.row_perm,
                                   prog.n_rows, mix["entry"],
                                   sum(b["missing"] for b in batches))
    correct, checks = check.verdict(numbers)

    metrics = {}
    for m in metrics_of(bench, cell["name"], traced):
        v = reader(bench_dir, m["name"])(out)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": correct, "attempted": out.queries,
              "failed": sum(b["missing"] for b in batches),
              "metrics": metrics, "device": device_info}
    if out.trace is not None:
        result["device"]["busy_s"] = out.trace.busy_s
        result["device"]["window_s"] = out.trace.window_s
        result["breakdown"] = {"device_ops": out.trace.device_ops,
                               "idle_gaps": out.trace.idle_gaps}
    q = np.percentile(np.asarray(out.latencies_s) * 1e3, [0, 25, 50, 75, 100])
    result["batches"] = {"count": len(batches),
                         "ms_min_q1_median_q3_max": q.tolist(),
                         "host_spans_s": out.spans_s}
    if named:
        result["failures"] = named
    result["checks"] = checks
    return result


def _warm_up(prog, traffic, mix, device) -> None:
    """Run the warm-up batches (kernels built and loaded, the allocator
    grown to the cell's shapes) and hold the launches they made against
    the mix's ``launch_check``."""
    prog.ops.reset_launches()
    for w in range(int(mix.get("warmup_batches", 2))):
        prog.run_batch(traffic.warmup(w))
    sync(device)
    launches = prog.launches()
    if launches is None:   # the control: the reference launches nothing
        return
    want = mix.get("launch_check", {})
    for k in want.get("zero", []):
        if launches[k] != 0:
            raise RuntimeError(f"warm-up launched {k} {launches[k]} times; "
                               f"this mix must not reach it")
    for k in want.get("nonzero", []):
        # the plain versions on the host count no launches
        if device == "cuda" and launches[k] == 0:
            raise RuntimeError(f"warm-up never launched {k}")
    prog.ops.reset_launches()


def _start_profiler(device):
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    # the profiler can drop a session's first device records
    x = torch.zeros(1, device=device)
    for _ in range(PROFILER_PRIMING):
        x.add_(1)
    sync(device)
    return prof


def _window(prog, traffic, seconds, spans, traced, device, seed,
            mix) -> list:
    """The closed loop: one client, the next batch once the last answer of
    the previous one is on the host, until ``seconds`` have passed.  Of
    each batch only the answers drawn for the check are kept.  Returns the
    window's start and its batches."""
    per = int(mix["checks_per_batch"])
    rows_entry = mix["entry"] == "rows"
    batches = []
    t_start = time.perf_counter()
    k = 0
    while not batches or time.perf_counter() - t_start < seconds:
        preds = traffic.batch(k)
        plans = [] if traced else None
        submit = time.perf_counter()
        with spans("batch"):
            answers = prog.run_batch(preds, spans, plans)
        done = time.perf_counter()
        with spans("result"):
            answers = list(answers)[: len(preds)]
            rng = workload.rng_for(seed, workload.STREAM_SAMPLE, k)
            drawn = rng.choice(len(preds), size=min(per, len(preds)),
                               replace=False)
            batches.append({
                "k": k, "submit": submit, "done": done, "n": len(preds),
                "preds": preds,
                "kept": [(preds[i], answers[i]) for i in sorted(drawn)
                         if i < len(answers) and answers[i] is not None],
                "missing": len(preds) - sum(a is not None for a in answers),
                "answer_words": [
                    roofline.rowid_answer_words(prog.n_rows) if rows_entry
                    else len(a) for a in answers if a is not None],
                "leaves": _distinct_leaf_words(plans) if plans else None})
        k += 1
    return t_start, batches


def _distinct_leaf_words(plans) -> list:
    return [len(s) for s in {id(s): s for p in plans
                             for s in p.streams}.values()]


def _needed_bytes(prog, batches) -> int:
    """The bytes the window's queries need (``roofline.needed_bytes``)."""
    total = 0
    for b in batches:
        leaves = b["leaves"]
        if leaves is None:   # the rows entry plans inside the program
            leaves = _distinct_leaf_words(prog.plans(b["preds"]))
        total += roofline.needed_bytes(leaves, b["answer_words"])
    return total


def _sample(batches, seed, mix) -> list:
    """The kept (predicate, answer) pairs, at most ``max_checks`` of them,
    drawn from the seed."""
    pairs = [kp for b in batches for kp in b["kept"]]
    cap = int(mix["max_checks"])
    if len(pairs) > cap:
        rng = workload.rng_for(seed, workload.STREAM_SAMPLE, 1 << 40)
        keep = np.sort(rng.choice(len(pairs), size=cap, replace=False))
        pairs = [pairs[i] for i in keep]
    return pairs


def _device(device: str) -> dict:
    if device != "cuda":
        return {"platform": device, "kind": device, "count": 1,
                "memory_peak_bytes": 0}
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
