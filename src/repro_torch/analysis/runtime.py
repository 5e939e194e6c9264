"""Opt-in runtime sanitizers (``REPRO_SANITIZE=1``).

Two hooks, both free when the env var is unset:

* :func:`maybe_validate` — structural EWAH validation at backend
  ``execute_compressed`` boundaries (delegates to
  :meth:`EwahStream.validate`).
* :func:`make_lock` — lock factory.  Sanitizing returns an
  order-tracking wrapper that records the global acquisition graph and
  raises :class:`LockOrderError` the first time two locks are ever taken
  in both orders (potential deadlock), even if no thread actually
  deadlocks during the run.

The env var is re-read on every call so tests can flip it with
:func:`sanitized` mid-process; ``make_lock`` is the one creation-time
decision (a lock built while sanitizing stays instrumented for life,
which is what tests want).
"""

from __future__ import annotations

import contextlib
import os
import threading


def sanitize_enabled() -> bool:
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


@contextlib.contextmanager
def sanitized(on: bool = True):
    """Temporarily force sanitizer mode on (or off) for a test block."""
    prev = os.environ.get("REPRO_SANITIZE")
    os.environ["REPRO_SANITIZE"] = "1" if on else "0"
    try:
        yield
    finally:
        if prev is None:
            del os.environ["REPRO_SANITIZE"]
        else:
            os.environ["REPRO_SANITIZE"] = prev


def maybe_validate(stream, origin: str = ""):
    """Validate ``stream`` when sanitizing; always returns it unchanged."""
    if sanitize_enabled() and stream is not None:
        stream.validate(origin=origin)
    return stream


class LockOrderError(RuntimeError):
    """Two locks were acquired in both orders across the process."""


class _OrderGraph:
    """Global happened-before graph over named locks.

    Edge a->b means some thread held a while acquiring b.  Adding an edge
    that closes a cycle is an inversion: the opposite order was already
    observed, so two threads interleaving those paths can deadlock.
    """

    def __init__(self):
        self._mutex = threading.Lock()
        self._edges: dict[str, set[str]] = {}
        self._local = threading.local()

    def _held(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _reaches(self, src: str, dst: str) -> bool:
        seen, todo = set(), [src]
        while todo:
            node = todo.pop()
            if node == dst:
                return True
            if node in seen:
                continue
            seen.add(node)
            todo.extend(self._edges.get(node, ()))
        return False

    def acquired(self, name: str):
        stack = self._held()
        with self._mutex:
            for held in stack:
                if held == name:  # reentrant re-acquire adds no ordering
                    continue
                if name not in self._edges.get(held, set()):
                    if self._reaches(name, held):
                        raise LockOrderError(
                            f"lock order inversion: acquiring {name!r} while "
                            f"holding {held!r}, but {name!r} -> {held!r} "
                            f"order was already observed"
                        )
                    self._edges.setdefault(held, set()).add(name)
        stack.append(name)

    def released(self, name: str):
        stack = self._held()
        # release order need not be LIFO; drop the innermost occurrence
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                break


_GRAPH = _OrderGraph()


def reset_order_graph():
    """Forget all observed orderings (test isolation)."""
    global _GRAPH
    _GRAPH = _OrderGraph()


class _TrackedLock:
    """Context-manager lock wrapper feeding the global order graph."""

    def __init__(self, name: str, reentrant: bool):
        self.name = name
        self._inner = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            try:
                _GRAPH.acquired(self.name)
            except BaseException:
                self._inner.release()
                raise
        return ok

    def release(self):
        self._inner.release()
        _GRAPH.released(self.name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def make_lock(name: str, reentrant: bool = True):
    """A named lock: plain threading lock normally, order-tracked under
    ``REPRO_SANITIZE=1`` (decided at creation time)."""
    if sanitize_enabled():
        return _TrackedLock(name, reentrant)
    return threading.RLock() if reentrant else threading.Lock()
