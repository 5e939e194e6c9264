"""Spans and counters inside the port: where a query batch's host time goes.

    from repro_torch import tracing

    prev = tracing.enable()
    with tracing.span("backend.pad"):          # host work only
        ...
    with tracing.span("backend.h2d", device=True):   # encloses device work
        ...
    tracing.add("backend.groups", 3)
    tracing.snapshot()
    # {"spans": {name: {"s", "self_s", "n"}}, "counters": {name: int}}
    tracing.enable(prev)

A span is **on** while :func:`enable` holds or while a ``torch.profiler``
session records (``torch.autograd.profiler._is_profiler_enabled``, read
through ``sys.modules``: this module imports no torch).  Off, :func:`span`
returns one shared no-op object: no clock read, no allocation.  On, it
adds its duration, its count and its self time (the duration less what
its child spans on the same thread cover) to the process-wide totals.

While a profiler records, a span that encloses no device work also opens
``torch.profiler.record_function("repro." + name)``, so it sits on the
profiler's host timeline beside the device's records and names the idle
gaps it covers.  A span with ``device=True`` keeps only its host-clock
totals: a ``record_function`` range around device work can appear among
the trace's device records and would change what a device trace counts.

Totals and the :func:`enable` switch are shared by every thread of the
process; the serve plane's worker threads call the backend.  See
docs/tracing_torch.md for the spans and counters the query path records.
"""

from __future__ import annotations

import sys
import threading
import time

from .analysis.runtime import make_lock

__all__ = ["add", "enable", "enabled", "reset", "snapshot", "span"]

_PROFILER_PREFIX = "repro."

_mutex = make_lock("tracing", reentrant=False)
_spans: dict = {}      # guarded-by: _mutex  name -> [ns, self ns, count]
_counters: dict = {}   # guarded-by: _mutex
_enabled = False
_local = threading.local()   # .stack: child ns of each open span


def _profiler(_modules=sys.modules):
    """The ``torch.autograd.profiler`` module while a session records."""
    prof = _modules.get("torch.autograd.profiler")
    return prof if prof is not None and prof._is_profiler_enabled else None


def enabled() -> bool:
    """Whether spans and counters record now."""
    return _enabled or _profiler() is not None


def enable(on: bool = True) -> bool:
    """Switch recording on (or off with ``on=False``) outside a profiler
    session; returns the previous setting, for restoring it."""
    global _enabled
    prev, _enabled = _enabled, bool(on)
    return prev


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "mark", "t0")

    def __init__(self, name: str, mark):
        self.name = name
        self.mark = mark

    def __enter__(self):
        if self.mark is not None:
            self.mark.__enter__()
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        stack.append(0)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        stack = _local.stack
        child = stack.pop()
        if stack:
            stack[-1] += dur
        with _mutex:
            tot = _spans.get(self.name)
            if tot is None:
                tot = _spans[self.name] = [0, 0, 0]
            tot[0] += dur
            tot[1] += dur - child
            tot[2] += 1
        if self.mark is not None:
            self.mark.__exit__(*exc)
        return False


def span(name: str, device: bool = False):
    """A context manager timing ``name`` (see the module's doc);
    ``device=True`` for a span that encloses device work."""
    prof = _profiler()
    if prof is None:
        return _Span(name, None) if _enabled else _OFF
    return _Span(name, None if device
                 else prof.record_function(_PROFILER_PREFIX + name))


def add(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    if not enabled():
        return
    with _mutex:
        _counters[name] = _counters.get(name, 0) + int(n)


def snapshot() -> dict:
    """A copy of the totals: ``{"spans": {name: {"s", "self_s", "n"}},
    "counters": {name: int}}``, seconds on the host clock."""
    with _mutex:
        return {"spans": {k: {"s": v[0] / 1e9, "self_s": v[1] / 1e9,
                              "n": v[2]} for k, v in _spans.items()},
                "counters": dict(_counters)}


def reset() -> None:
    """Clear every span total and counter."""
    with _mutex:
        _spans.clear()
        _counters.clear()
