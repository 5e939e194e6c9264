"""Reduce a ``torch.profiler`` trace of the window to what the per-layer
metrics read.

The arithmetic (device activity as a union of intervals, idle share of
the wall time, time by operation) is a copy of ``chip_smoke.py``'s
``device_profile``.  The window and each batch are the benchmark's own
``record_function`` spans (``bench.window``, ``bench.batch``,
``bench.plan``, ``bench.execute``, ``bench.result``), which the profiler
records on the host's timeline beside the device's operations.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SPAN_PREFIX = "bench."
NOT_DEVICE_WORK = ("Activity Buffer Request",)   # CUPTI's own bookkeeping
TOP = 10


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float                 # union of device operations in the window
    kernel_s: float               # union of device kernels (no copies)
    n_kernels: int
    h2d_s: float                  # summed host-to-device copies
    batch_busy_s: list = field(default_factory=list)
    device_ops: list = field(default_factory=list)   # [[name, s]], top 10
    idle_gaps: list = field(default_factory=list)    # [[label, s]], top 10


def _events(prof):
    """(name, on_device, start_s, end_s) of every record."""
    from torch.autograd import DeviceType

    out = []
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        raw = None
    if raw is not None:
        for e in raw:
            s = e.start_ns() / 1e9
            out.append((e.name(), e.device_type() == DeviceType.CUDA, s,
                        s + e.duration_ns() / 1e9))
        return out
    for e in prof.events():
        out.append((e.name, e.device_type == DeviceType.CUDA,
                    e.time_range.start / 1e6, e.time_range.end / 1e6))
    return out


def _union(intervals):
    """Sorted disjoint (start, end) arrays of a set of intervals."""
    if not intervals:
        return np.zeros(0), np.zeros(0)
    iv = sorted(intervals)
    starts, ends = [iv[0][0]], [iv[0][1]]
    for s, e in iv[1:]:
        if s > ends[-1]:
            starts.append(s)
            ends.append(e)
        elif e > ends[-1]:
            ends[-1] = e
    return np.asarray(starts), np.asarray(ends)


def _covered(starts, ends, t):
    """Seconds of the union before each time in ``t``."""
    cum = np.concatenate([[0.0], np.cumsum(ends - starts)])
    i = np.searchsorted(starts, t, side="right") - 1
    inside = np.where(i >= 0, np.minimum(t, ends[np.maximum(i, 0)])
                      - starts[np.maximum(i, 0)], 0.0)
    return np.where(i >= 0, cum[np.maximum(i, 0)] + inside, 0.0)


def summarize(prof) -> TraceSummary | None:
    """None where the trace holds no ``bench.window`` span."""
    evs = _events(prof)
    host = [(n, s, e) for n, dev, s, e in evs if not dev]
    window = [(s, e) for n, s, e in host if n == SPAN_PREFIX + "window"]
    if not window:
        return None
    w0, w1 = window[0]
    dev = [(n, max(s, w0), min(e, w1)) for n, d, s, e in evs
           if d and not n.startswith(SPAN_PREFIX)
           and n not in NOT_DEVICE_WORK and e > w0 and s < w1]
    starts, ends = _union([(s, e) for _, s, e in dev])
    kernels = [(s, e) for n, s, e in dev
               if "Memcpy" not in n and "Memset" not in n]
    k_starts, k_ends = _union(kernels)
    by_name: dict = {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    batches = sorted((s, e) for n, s, e in host
                     if n == SPAN_PREFIX + "batch")
    if batches and len(starts):
        b = np.asarray(batches)
        busy = (_covered(starts, ends, b[:, 1])
                - _covered(starts, ends, b[:, 0])).tolist()
    else:
        busy = [0.0] * len(batches)
    return TraceSummary(
        window_s=w1 - w0,
        busy_s=float((ends - starts).sum()),
        kernel_s=float((k_ends - k_starts).sum()),
        n_kernels=len(kernels),
        h2d_s=float(sum(e - s for n, s, e in dev if "Memcpy HtoD" in n)),
        batch_busy_s=busy,
        device_ops=[[n[:120], t] for n, t in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=_idle_gaps(host, starts, ends, w0, w1))


def _idle_gaps(host, starts, ends, w0, w1) -> list:
    """The longest stretches of the window with no device operation, each
    named by what the host was doing at its middle: the innermost
    benchmark span, and the innermost host operation inside it."""
    gap_s = np.concatenate([[w0], ends])
    gap_e = np.concatenate([starts, [w1]])
    length = gap_e - gap_s
    order = np.argsort(-length)[:TOP]
    spans = _table([h for h in host if h[0].startswith(SPAN_PREFIX)
                    and h[0] != SPAN_PREFIX + "window"])
    ops = _table([h for h in host if not h[0].startswith(SPAN_PREFIX)])
    out = []
    for g in order:
        if length[g] <= 0:
            break
        mid = (gap_s[g] + gap_e[g]) / 2
        label = _innermost(spans, mid) or "between batches"
        label = label[len(SPAN_PREFIX):] if label.startswith(
            SPAN_PREFIX) else label
        op = _innermost(ops, mid)
        out.append([f"{label}: {op}" if op else label, float(length[g])])
    return out


def _table(events):
    return ([n for n, _, _ in events], np.asarray([s for _, s, _ in events]),
            np.asarray([e for _, _, e in events]))


def _innermost(table, t):
    """The name of the latest-starting event that covers time ``t``."""
    names, s, e = table
    hit = np.flatnonzero((s <= t) & (e >= t)) if len(names) else []
    return names[hit[np.argmax(s[hit])]] if len(hit) else None
