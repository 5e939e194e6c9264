#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It imports the port (``src/repro_torch``) and nothing of JAX or of the
reference package, and:

1. builds the five CUDA kernels from ``src/repro_torch/csrc`` with nvcc
   for sm_90a and prints the card's name and power limit;
2. builds the dbgen-like (1,000,000 rows, seed 1) and census-like (199,523
   rows, seed 0) indexes with ``IndexSpec(row_order="lex",
   encoding="auto")`` and compiles a 64-predicate mix for each;
3. kernel phase: holds each kernel against its plain PyTorch version on the
   card, on the inputs the dbgen mix's largest batch gives it, bit for bit,
   and times both with CUDA events (median, L2 flushed before each run);
4. path phase: answers both mixes through ``BitmapIndex.query_many`` and
   ``query_compressed`` on ``TorchBackend()`` and ``TorchBackend(fuse=False)``,
   requires EWAH streams identical to the host ``NumpyBackend`` and row ids
   identical to ``evaluate_mask`` over the raw columns, requires each
   kernel's launch counter to rise on the path that uses it, and prints
   queries/s, host-to-device bytes per batch and the time split;
5. prints the card line, the ``{"kernels": [...]}`` line and, last,
   ``{"ok": true, "device": {...}}``.

Any mismatch or error exits non-zero before the last line.  The full
measurements also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)
ALU_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores,
#                              the table's rate for scalar work
N_PREDICATES = 64
TABLES = (("dbgen", 1_000_000, 1), ("census", 199_523, 0))
KERNELS = {
    # name: (source, the TPU kernel it replaces)
    "planfuse": ("src/repro_torch/csrc/planfuse.cu",
                 "src/repro/kernels/planfuse.py:91"),
    "recompress": ("src/repro_torch/csrc/recompress.cu",
                   "src/repro/kernels/recompress.py:47"),
    "wordops": ("src/repro_torch/csrc/wordops.cu",
                "src/repro/kernels/wordops.py:43"),
    "slicefold": ("src/repro_torch/csrc/slicefold.cu",
                  "src/repro/kernels/slicefold.py:44"),
    # no Pallas counterpart: the reference decodes with lax.scan
    "ewah_decode": ("src/repro_torch/csrc/ewah_decode.cu",
                    "src/repro/core/ewah_jax.py:129"),
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*parts):
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# the query mix
# ---------------------------------------------------------------------------


def make_predicates(T, cards, seed, n=N_PREDICATES):
    """A seeded mix over all four columns: half of it one dashboard template
    (equality on the smallest column AND a fixed range on the largest, so
    those plans share a root and batch together), half random Eq / In /
    Range / Not / nested And-Or."""
    import numpy as np

    rng = np.random.default_rng(seed)
    order = sorted(range(len(cards)), key=lambda c: cards[c])
    small, large = order[0], order[-1]
    lo, hi = cards[large] // 25, cards[large] // 25 + cards[large] * 7 // 10

    def leaf(depth=0):
        col = int(rng.integers(0, len(cards)))
        card = cards[col]
        kind = int(rng.integers(0, 5 if depth < 2 else 3))
        if kind == 0:
            return T.Eq(col, int(rng.integers(0, card)))
        if kind == 1:
            vals = rng.integers(0, card, size=int(rng.integers(2, 5)))
            return T.In(col, [int(v) for v in vals])
        if kind == 2:
            a = int(rng.integers(0, card))
            return T.Range(col, a, a + int(rng.integers(1, max(2, card // 3))))
        if kind == 3:
            return T.Not(leaf(depth + 1))
        cls = T.And if rng.random() < 0.5 else T.Or
        return cls(*(leaf(depth + 1) for _ in range(int(rng.integers(2, 4)))))

    preds = []
    for i in range(n):
        if i % 2 == 0:
            preds.append(T.And(T.Eq(small, int(rng.integers(0, cards[small]))),
                               T.Range(large, lo, hi)))
        else:
            cls = T.And if i % 4 == 1 else T.Or
            preds.append(cls(leaf(1), leaf(1), leaf(1)))
    return preds


def build_table(T, tables, name, n_rows, seed):
    make = {"dbgen": tables.make_dbgen_like,
            "census": tables.make_census_like}[name]
    t0 = time.perf_counter()
    cols = make(n_rows, seed=seed)
    idx = T.BitmapIndex.build(cols, T.IndexSpec(row_order="lex",
                                                encoding="auto"))
    secs = time.perf_counter() - t0
    cards = [int(c.max()) + 1 for c in cols]
    log(f"[index] {name}: {n_rows} rows, cards {cards}, encodings "
        f"{list(idx.encodings())}, {idx.size_words()} words, built in "
        f"{secs:.3f} s")
    return cols, idx, cards


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def event_ms(torch, fn, reps, flush, rounds=5):
    """Device time of one ``fn`` call with a cold L2: CUDA events around a
    run of ``reps`` (L2 flush, ``fn``) pairs, minus the same run of flushes
    alone, over the count; the median of ``rounds`` such runs.  The 256 MB
    flush keeps the card busy while the host enqueues the next call, so
    the host's launch overhead does not show as device time."""
    fn()  # warm-up
    torch.cuda.synchronize()

    def per_call(body):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            body()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    times = []
    for _ in range(rounds):
        base = per_call(flush.zero_)
        both = per_call(lambda: (flush.zero_(), fn()))
        times.append(max(both - base, 0.0))
    return statistics.median(times)


def bound(nbytes, nops):
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = nops / ALU_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def max_err(torch, got, want):
    errs = []
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        errs.append(int((g.long() - w.long()).abs().max()) if g.numel() else 0)
    return max(errs)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def largest_group(be, plans):
    groups = be._group(plans)
    (root, cap, n_rows), idxs = max(
        groups.items(),
        key=lambda kv: len(kv[1]) * len(plans[kv[1][0]].streams) * kv[0][1])
    return root, cap, n_rows, idxs, len(groups)


def find_fold(node):
    """The first ("fold", ops, leaves) node: a bit-sliced comparison."""
    if node[0] == "fold" and all(c[0] == "leaf" for c in node[2]):
        return node
    kids = (node[2] if node[0] == "fold" else
            (node[1],) if node[0] == "not" else
            node[1] if node[0] in ("and", "or") else ())
    for c in kids:
        hit = find_fold(c)
        if hit is not None:
            return hit
    return None


def kernel_phase(torch, T, idx, plans, device, reps):
    """Each kernel against its plain version on the dbgen mix's largest
    batch: its streams, their decoded planes, the plan's tape, and the
    per-stage path's inputs."""
    from repro_torch.core import ewah
    from repro_torch.core.query import lower_plan
    from repro_torch.kernels import ops, ref

    be = T.TorchBackend(device=device)
    root, cap, n_rows, idxs, n_groups = largest_group(be, plans)
    batch_np, lengths_np = be._pad_group(plans, idxs, cap)
    batch, lengths = be._to_device(batch_np, lengths_np)
    B, m, C = batch.shape
    W = (n_rows + ewah.WORD_BITS - 1) // ewah.WORD_BITS
    tape, depth = lower_plan(root)
    log(f"[kernels] dbgen largest batch: B={B} queries x m={m} leaves, "
        f"capacity {C}, W={W} words, tape {len(tape)} entries, depth {depth} "
        f"({n_groups} batches in the mix)")
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=device)

    planes = ops.ewah_decode(batch, lengths, W)
    x = planes.reshape(m, -1)
    n = x.shape[1]
    r, _ = ref.plan_fuse(x, tape)
    words = r.reshape(B, W)
    sent = torch.where(words[:, :1] == 0, -1, 0).to(torch.int32)
    prev = torch.cat([sent, words[:, :-1]], dim=1).reshape(-1)
    w_flat = words.reshape(-1)
    fold = find_fold(root)
    if fold is not None:
        f_ops = fold[1]
        f_x = torch.stack([planes[c[1]] for c in fold[2]]).reshape(
            len(fold[2]), -1)
    else:
        f_ops = tuple("and" if i % 2 else "or" for i in range(min(m, 8) - 1))
        f_x = x[: len(f_ops) + 1].contiguous()
    a, b = x[0], x[1 % m]
    stream_bytes = int(lengths_np.sum()) * 4 + lengths_np.nbytes

    cases = {
        "ewah_decode": (lambda: (ops.ewah_decode(batch, lengths, W),),
                        lambda: (ref.ewah_decode(batch, lengths, W),),
                        stream_bytes + m * B * W * 4, m * B * W, 1),
        "planfuse": (lambda: ops.plan_fuse(x, tape),
                     lambda: ref.plan_fuse(x, tape),
                     (m + 2) * n * 4 + len(tape) * 8,
                     (len(tape) + 2) * n, reps),
        "recompress": (lambda: ops.recompress_flags(w_flat, prev),
                       lambda: ref.recompress(w_flat, prev),
                       4 * n * 4, 4 * n, reps),
        "wordops": (lambda: ops.wordops(a, b, "and"),
                    lambda: ref.wordops(a, b, "and"),
                    4 * n * 4, 3 * n, reps),
        "slicefold": (lambda: (ops.slice_fold(f_x, f_ops),),
                      lambda: (ref.slice_fold(f_x, f_ops),),
                      (f_x.shape[0] + 1) * n * 4 + len(f_ops),
                      len(f_ops) * n, reps),
    }
    out = {}
    for name, (kern, plain, nbytes, nops, plain_reps) in cases.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        mism = sum(int((g != w).sum()) for g, w in zip(got, want))
        err = max_err(torch, got, want)
        ms = event_ms(torch, kern, reps, flush)
        plain_ms = event_ms(torch, plain, plain_reps, flush,
                            rounds=3 if plain_reps == 1 else 5)
        bound_ms, bound_by = bound(nbytes, nops)
        out[name] = {"max_abs_err": err, "mismatches": mism, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bytes": nbytes,
                     "shape": ([B, m, C] if name == "ewah_decode" else
                               list(f_x.shape) if name == "slicefold" else
                               [m, n] if name == "planfuse" else [n])}
        log(f"[kernels] {name}: mismatches {mism}, max_abs_err {err} "
            f"(tolerance 0: bit identity), "
            f"{ms:.4f} ms (bound {bound_ms:.4f} ms, {bound_by}; "
            f"{bound_ms / max(ms, 1e-9):.1%} of it), plain {plain_ms:.4f} ms")
        check(mism == 0 and err == 0,
              f"{name} kernel disagrees with its plain version")
    return out


def path_phase(torch, T, name, cols, idx, preds, device):
    """Drive the mix through the user entry points, fused then per stage,
    and hold every answer against the host oracle and evaluate_mask."""
    import numpy as np

    from repro_torch.core.query import NumpyBackend, compile_plan, get_backend
    from repro_torch.kernels import ops

    plans = [compile_plan(idx, p) for p in preds]
    t0 = time.perf_counter()
    oracle = NumpyBackend()
    want_streams = [oracle.execute_compressed(p).data for p in plans]
    t1 = time.perf_counter()
    want_rows = [np.flatnonzero(T.evaluate_mask(p, cols)) for p in preds]
    log(f"[path] {name}: host oracles: NumpyBackend {t1 - t0:.3f} s, "
        f"evaluate_mask {time.perf_counter() - t1:.3f} s")
    result = {"numpy_backend_s": t1 - t0}
    for mode, fuse in (("fused", True), ("per_stage", False)):
        # the entry points run on the card unless told otherwise
        opts = {"fuse": fuse} if device == "cuda" else {"fuse": fuse,
                                                       "device": device}
        get_backend("torch", **opts).result_cache.clear()
        ops.reset_launches()
        rows = idx.query_many(preds, **opts)
        streams = [idx.query_compressed(p, **opts) for p in preds]
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        bad = 0
        for i, p in enumerate(preds):
            ok = (np.array_equal(streams[i].data, want_streams[i])
                  and np.array_equal(np.sort(idx.row_perm[rows[i][0]]),
                                     want_rows[i])
                  and np.array_equal(streams[i].to_rows(), rows[i][0]))
            if not ok:
                bad += 1
                log(f"[path] {name} {mode}: MISMATCH on {p!r}")
        check(bad == 0, f"{name} {mode}: {bad} predicates disagree")
        need = (["ewah_decode", "planfuse"] if fuse else
                ["ewah_decode", "wordops", "slicefold", "recompress"])
        for k in need:  # CPU tensors take the plain versions: no launches
            check(device == "cpu" or launches[k] > 0,
                  f"{name} {mode}: {k} never launched")
        log(f"[path] {name} {mode}: {len(preds)} predicates identical to "
            f"NumpyBackend and evaluate_mask; launches {launches}")
        result[mode] = {"launches": launches}

        # throughput: batched calls on a fresh backend, caches cleared
        be = T.TorchBackend(device=device, fuse=fuse)
        be.execute_compressed_many(plans)             # warm-up
        be.result_cache.clear()
        t0 = time.perf_counter()
        be.execute_compressed_many(plans)
        t_comp = time.perf_counter() - t0
        t0 = time.perf_counter()
        be.execute_many(plans)
        t_rows = time.perf_counter() - t0
        result[mode].update(
            compressed_qps=len(plans) / t_comp, rows_qps=len(plans) / t_rows,
            compressed_s=t_comp, rows_s=t_rows)
        log(f"[path] {name} {mode}: execute_compressed_many "
            f"{len(plans) / t_comp:.1f} queries/s ({t_comp:.4f} s), "
            f"execute_many {len(plans) / t_rows:.1f} queries/s "
            f"({t_rows:.4f} s)")
    result["split"] = time_split(torch, T, plans, device)
    return result


def time_split(torch, T, plans, device):
    """One fused compressed batch of the mix, step by step with a
    synchronize after each: host grouping and padding, host-to-device
    copy, the device program, device-to-host copy and host slicing."""
    import numpy as np

    from repro_torch.core import ewah

    be = T.TorchBackend(device=device)
    split = {"pad_s": 0.0, "h2d_s": 0.0, "device_s": 0.0, "d2h_s": 0.0,
             "result_words": 0}
    h2d = []
    t0 = time.perf_counter()
    groups = be._group(plans)
    split["group_s"] = time.perf_counter() - t0
    for (root, cap, n_rows), idxs in groups.items():
        check(n_rows <= ewah.MAX_DIRTY * ewah.WORD_BITS,
              "the split times the on-device re-encode")
        t0 = time.perf_counter()
        batch, lengths = be._pad_group(plans, idxs, cap)
        t1 = time.perf_counter()
        dev = be._to_device(batch, lengths)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        streams, lens = be._run(root, *dev, (n_rows + 31) // 32,
                                compressed=True)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        streams = streams.cpu().numpy().view(np.uint32)
        lens = lens.cpu().numpy()
        results = [streams[b, : lens[b]] for b in range(len(idxs))]
        t4 = time.perf_counter()
        split["result_words"] += sum(len(r) for r in results)
        split["pad_s"] += t1 - t0
        split["h2d_s"] += t2 - t1
        split["device_s"] += t3 - t2
        split["d2h_s"] += t4 - t3
        h2d.append(batch.nbytes + lengths.nbytes)
    split["batches"] = len(groups)
    split["h2d_bytes_per_batch_mean"] = float(np.mean(h2d))
    split["h2d_bytes_per_batch_max"] = int(max(h2d))
    split["h2d_bytes_total"] = int(sum(h2d))
    log("[split] " + ", ".join(f"{k} {v:.6g}" for k, v in split.items()))
    return split


def profile_kernels(torch, T, plans, device):
    """Device activity of one fused compressed batch of the mix, from
    torch.profiler: time by kernel or copy, by category (the port's
    kernels, copies, PyTorch's own kernels), and the device's idle share
    of the wall time (1 - union of activity intervals / wall).  None where
    the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    be = T.TorchBackend(device=device)
    be.execute_compressed_many(plans)
    be.result_cache.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        be.execute_compressed_many(plans)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            # CUPTI's own buffer bookkeeping, not device work
            and e.name != "Activity Buffer Request"]
    if not acts:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in acts)
    busy_us, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    by_name, by_cat = {}, {"port_kernels": 0.0, "copies": 0.0, "torch": 0.0}
    for e in acts:
        ms = e.time_range.elapsed_us() / 1e3
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += ms
        entry[1] += 1
        cat = ("port_kernels" if any(f"{k}_kernel" in e.name for k in KERNELS)
               else "copies" if "Memcpy" in e.name or "Memset" in e.name
               else "torch")
        by_cat[cat] += ms
    rows = sorted(((k, v[0], v[1]) for k, v in by_name.items()),
                  key=lambda r: -r[1])
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "by_category_ms": by_cat, "by_kernel": rows}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def run(device="cuda", scale=1.0, reps=20):
    """All phases; ``scale`` shrinks the tables for a rehearsal on the CPU
    with the kernels' plain versions (``device="cpu"``)."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as T
    from repro_torch.data import tables
    from repro_torch.kernels import build, ops

    report = {"device": str(device)}
    if device != "cpu":
        t0 = time.perf_counter()
        build.build_all()
        report["build_s"] = time.perf_counter() - t0
        log(f"[build] {len(build.KERNELS)} kernels built in "
            f"{report['build_s']:.1f} s")
        for name in build.KERNELS:
            for line in build.build_log(name).splitlines():
                if "registers" in line or "stack frame" in line:
                    log(f"[build] {name}: {line.strip()}")

    data = {}
    for name, n_rows, seed in TABLES:
        cols, idx, cards = build_table(T, tables, name,
                                       max(64, int(n_rows * scale)), seed)
        t0 = time.perf_counter()
        preds = make_predicates(T, cards, seed)
        plans = [T.query.compile_plan(idx, p) for p in preds]
        plan_s = time.perf_counter() - t0
        log(f"[plan] {name}: {len(preds)} predicates compiled in "
            f"{plan_s:.4f} s, {sum(len(p.streams) for p in plans)} leaves")
        data[name] = (cols, idx, preds, plans, plan_s)

    if device != "cpu":
        report["kernels"] = kernel_phase(torch, T, data["dbgen"][1],
                                         data["dbgen"][3], device, reps)
    totals = dict.fromkeys(ops.LAUNCHES, 0)
    report["path"] = {}
    for name, (cols, idx, preds, plans, plan_s) in data.items():
        res = path_phase(torch, T, name, cols, idx, preds, device)
        res["plan_s"] = plan_s
        report["path"][name] = res
        for mode in ("fused", "per_stage"):
            for k, v in res[mode]["launches"].items():
                totals[k] += v
    report["launches"] = totals
    if device != "cpu":
        try:
            prof = profile_kernels(torch, T, data["dbgen"][3], device)
        except Exception as exc:  # a diagnostic, not a phase
            prof = None
            log(f"[profile] torch.profiler failed: {exc!r}")
        report["profile_dbgen_fused"] = prof
        if prof is None:
            log("[profile] no device time recorded: not measured")
        else:
            log(f"[profile] dbgen fused batch: wall {prof['wall_ms']:.3f} ms,"
                f" device busy {prof['device_busy_ms']:.3f} ms, idle share "
                f"{prof['idle_share']:.1%}; by category (ms) "
                f"{prof['by_category_ms']}")
            for key, ms, count in prof["by_kernel"][:12]:
                log(f"[profile] {ms:10.4f} ms  x{count:<5d} {key[:100]}")
    return report


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = card[0] if card else "unknown"
    log(f"[card] {card}")
    t_start = time.perf_counter()
    try:
        report = run()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    report["card"] = card
    report["total_s"] = time.perf_counter() - t_start
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        k = report["kernels"][name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": report["launches"][name],
                        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "bound_by": k["bound_by"], "library_ms": None})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"[done] {report['total_s']:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
