"""The system under test: the port's index and its two query entry points.

This is the only module of the benchmark that imports the program
(``repro_torch``).  It builds the index from the generated columns, turns
the neutral predicate tuples into the port's predicates, and drives one
batch through the entry the traffic names:

``compressed``
    ``compile_plan`` for each predicate, then
    ``get_backend("torch").execute_compressed_many``, with a result cache
    of the configuration's ``result_cache_entries``: EWAH answers.
``rows``
    ``BitmapIndex.query_many``: row-id answers.

Answers are in the index's row order (``row_perm``), as the port returns
them.
"""

from __future__ import annotations

import contextlib
import time

ENTRIES = ("compressed", "rows")


class Program:
    def __init__(self, config: dict, entry: str, device: str = "cuda"):
        if entry not in ENTRIES:
            raise ValueError(f"unknown entry {entry!r}; known: {ENTRIES}")
        from repro_torch.core import query as Q
        from repro_torch.kernels import ops

        self.Q = Q
        self.ops = ops
        self.entry = entry
        # the entry points run on the card unless told otherwise
        self.opts = {} if device == "cuda" else {"device": device}
        self.backend = Q.get_backend(
            "torch", cache_size=int(config["result_cache_entries"]),
            **self.opts)
        self.config = config
        self.index = None

    def build(self, cols) -> float:
        """Build the index with the configuration's spec; its seconds."""
        from repro_torch.core.bitmap_index import BitmapIndex
        from repro_torch.core.strategies import IndexSpec

        t0 = time.perf_counter()
        self.index = BitmapIndex.build(
            cols, IndexSpec(**self.config["index_spec"]))
        return time.perf_counter() - t0

    @property
    def n_rows(self) -> int:
        return self.index.n_rows

    @property
    def row_perm(self):
        return self.index.row_perm

    def index_words(self) -> int:
        return self.index.size_words()

    def predicate(self, t):
        Q = self.Q
        kind = t[0]
        if kind == "eq":
            return Q.Eq(t[1], t[2])
        if kind == "in":
            return Q.In(t[1], list(t[2]))
        if kind == "range":
            return Q.Range(t[1], t[2], t[3])
        if kind == "not":
            return Q.Not(self.predicate(t[1]))
        if kind == "and":
            return Q.And(*(self.predicate(c) for c in t[1]))
        if kind == "or":
            return Q.Or(*(self.predicate(c) for c in t[1]))
        raise ValueError(f"unknown predicate kind {kind!r}")

    def plans(self, preds) -> list:
        return [self.Q.compile_plan(self.index, self.predicate(p))
                for p in preds]

    def run_batch(self, preds, span=None, plans_out=None) -> list:
        """The answers of one batch: EWAH stream arrays (``compressed``) or
        row-id arrays (``rows``), one a predicate.  ``span(name)`` wraps the
        planning and the execution; the compiled plans are appended to
        ``plans_out`` where given."""
        span = span or (lambda name: contextlib.nullcontext())
        if self.entry == "rows":
            with span("execute"):
                out = self.index.query_many(
                    [self.predicate(p) for p in preds], **self.opts)
            return [rows for rows, _ in out]
        with span("plan"):
            plans = self.plans(preds)
        if plans_out is not None:
            plans_out.extend(plans)
        with span("execute"):
            out = self.backend.execute_compressed_many(plans)
        return [s.data for s in out]

    def clear_cache(self) -> None:
        self.backend.result_cache.clear()

    def cache_stats(self) -> dict:
        return dict(self.backend.result_cache.stats())

    def launches(self) -> dict:
        return dict(self.ops.LAUNCHES)
