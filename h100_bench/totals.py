"""The program's own span and counter totals (``repro_torch.tracing``),
for the readers of the metrics that split a batch's host time.

The program's spans and counters record while a ``torch.profiler``
session records, so in a traced run their totals cover the traced window
and nothing else.  The readers reach the program's module through
``sys.modules`` and import nothing of the program: where it is not loaded
(a program without it) or recorded nothing (the control), they find
nothing and return None.
"""

from __future__ import annotations

import sys

MODULE = "repro_torch.tracing"


def totals():
    """``{"spans": {name: {"s", "self_s", "n"}}, "counters": {name: n}}``
    of the window, or None."""
    mod = sys.modules.get(MODULE)
    if mod is None:
        return None
    snap = mod.snapshot()
    return snap if snap["spans"] or snap["counters"] else None


def span_ms(run, name: str, per: str = "batch", key: str = "s"):
    """Milliseconds of span ``name`` (``key``: ``s`` its duration,
    ``self_s`` its self time) a batch or a query; 0 for a span the window
    never entered."""
    snap = totals()
    n = len(run.latencies_s) if per == "batch" else run.queries
    if snap is None or not n:
        return None
    return 1e3 * snap["spans"].get(name, {}).get(key, 0.0) / n


def counter(name: str):
    """The window's count of ``name`` (0 where never added), or None."""
    snap = totals()
    return None if snap is None else snap["counters"].get(name, 0)
