"""Compressed bitmap index over a table (paper §2-§4, Algorithm 1).

Construction is driven by an :class:`~repro.core.strategies.IndexSpec`
resolved through the strategy registry (row order, code enumeration, value
policy, column order); queries go through the predicate algebra + planner in
:mod:`repro.core.query`.

``BitmapIndex.build`` is a *seal-once convenience* over the incremental
lifecycle (:mod:`repro_torch.core.lifecycle`): it appends the whole table
to an :class:`~repro_torch.core.lifecycle.IndexWriter` and closes it into a
single segment.  Streaming ingestion, per-batch sealing, and compaction live on
the writer; see docs/lifecycle.md.  Queries default to the ``"torch"``
backend, which runs on the CUDA device.

Two paths:
  * ``BitmapIndex`` materializes per-bitmap EWAH streams (supports predicate
    queries via compressed-domain logical ops) — used at query-benchmark
    scale.
  * ``index_size_report`` computes exact sizes only, in O(nck + L), for the
    multi-million-row size tables.

The pre-IndexSpec string kwargs (``BitmapIndex.build(cols, k=2,
row_order=...)``), deprecated since the IndexSpec migration, are **removed**;
``IndexSpec`` is the only entry point (docs/query_api.md has the migration
table).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from time import perf_counter

import numpy as np

from .encodings import (ColumnEncoding, assign_codes,  # noqa: F401 (re-export)
                        build_encoding, _materialize_streams)
from .histogram import column_histogram
from .query import compile_plan, get_backend
from .strategies import IndexSpec


def _observe_workload(plans, seconds: float) -> None:
    """Feed one executed batch into the workload-telemetry subsystem
    (lazy import: the core package must not depend on repro_torch.workload
    at import time)."""
    from ..workload import record_execution

    record_execution(plans, seconds)

_LEGACY_KWARGS = ("k", "row_order", "code_order", "value_policy",
                  "column_order")


def _reject_legacy(kwargs: dict) -> None:
    legacy = sorted(set(kwargs) & set(_LEGACY_KWARGS))
    if legacy:
        raise TypeError(
            f"the string-kwarg build API ({', '.join(legacy)}=...) was "
            "removed; pass an IndexSpec — e.g. "
            "BitmapIndex.build(cols, IndexSpec(k=2, row_order='grayfreq')) "
            "(see docs/query_api.md, 'Migration from the string-kwargs API')")
    if kwargs:
        raise TypeError(f"unexpected keyword arguments: {sorted(kwargs)}")


@dataclass
class ColumnIndex:
    """One indexed column: a :class:`~repro.core.encodings.ColumnEncoding`
    (value bitmaps / slice planes / bins + its predicate compiler) behind
    the attribute surface the rest of the stack reads.

    ``codes`` and ``k`` exist only on the equality encoding (the k-of-N
    code table); other encodings raise AttributeError for them.
    """

    encoding: ColumnEncoding

    @property
    def card(self) -> int:
        return self.encoding.card

    @property
    def N(self) -> int:
        """Bitmap/stream count (value bitmaps, slice planes, or bins)."""
        return self.encoding.n_streams

    @property
    def streams(self):
        return self.encoding.streams

    @property
    def sizes(self) -> np.ndarray:
        return self.encoding.sizes

    @property
    def codes(self) -> np.ndarray:
        return self.encoding.codes  # equality encoding only

    @property
    def k(self) -> int:
        return self.encoding.k      # equality encoding only


@dataclass
class BitmapIndex:
    """An EWAH-compressed k-of-N bitmap index over an integer-coded table.

    ``row_perm`` / ``col_perm`` are public: the row and column permutations
    the build applied (query row ids live in ``row_perm`` space; map back to
    original rows with ``index.row_perm[row_ids]``).

    ``cache_scope`` tags this index's cached query results for scoped
    eviction (:func:`repro.core.query.invalidate_scope`); the segment
    lifecycle sets it to ``("segment", generation)``.
    """

    n_rows: int
    columns: list = field(default_factory=list)  # ColumnIndex per table column
    spec: IndexSpec | None = None
    row_perm: np.ndarray | None = None
    col_perm: np.ndarray | None = None
    cache_scope: tuple | None = None

    # -- construction ------------------------------------------------------

    @staticmethod
    def build(table_cols: list, spec: IndexSpec | None = None, *,
              materialize: bool = True, **removed) -> "BitmapIndex":
        """End-to-end Algorithm-1-style construction: a seal-once
        convenience over :class:`~repro_torch.core.lifecycle.IndexWriter`
        (append everything, close into one segment, return its index).

        table_cols: list of (n,) integer value-id arrays (0-based, dense ids).
        spec: IndexSpec naming the row-order / code-order / value-policy /
          column-order strategies (see repro.core.strategies).
        """
        _reject_legacy(removed)
        if spec is not None and not isinstance(spec, IndexSpec):
            raise TypeError(
                f"second argument must be an IndexSpec, got {spec!r}; the old "
                "positional form build(cols, k) is gone — pass IndexSpec(k=...)")
        from .lifecycle import IndexWriter

        writer = IndexWriter(spec, materialize=materialize)
        writer.append(table_cols)
        seg = writer.close()
        if seg is None:
            raise ValueError("cannot build an index over zero rows")
        return seg.index

    # -- stats -------------------------------------------------------------

    def size_words(self) -> int:
        return int(sum(int(c.sizes.sum()) for c in self.columns))

    def per_column_words(self) -> list:
        return [int(c.sizes.sum()) for c in self.columns]

    # -- queries -----------------------------------------------------------

    def query(self, pred, backend: str = "torch", names=None, **backend_opts):
        """Run a predicate (Eq/In/Range/And/Or/Not over *original* column
        positions, or names via ``names``) through the planner.

        Returns (row_ids, words_scanned); row ids are positions in the
        reordered row space (``self.row_perm[row_ids]`` maps back).
        """
        plan = compile_plan(self, pred, names=names)
        t0 = perf_counter()
        out = get_backend(backend, **backend_opts).execute(plan)
        _observe_workload([plan], perf_counter() - t0)
        return out

    def query_compressed(self, pred, backend: str = "torch", names=None,
                         **backend_opts):
        """Compressed-in/compressed-out execution: the result stays an EWAH
        stream (:class:`~repro.core.ewah_stream.EwahStream` — ``.to_rows()``
        materializes, ``.count()`` popcounts without expansion), and
        sub-plan results are memoized in the backend's LRU result cache so
        cascaded predicates reuse shared work."""
        plan = compile_plan(self, pred, names=names)
        t0 = perf_counter()
        out = get_backend(backend, **backend_opts).execute_compressed(plan)
        _observe_workload([plan], perf_counter() - t0)
        return out

    def query_many(self, preds, backend: str = "torch", names=None,
                   **backend_opts):
        """Batch-execute many predicates; on the torch backend, same-shape
        plans share one padded device dispatch.  Returns a list of
        (row_ids, words_scanned)."""
        plans = [compile_plan(self, p, names=names) for p in preds]
        t0 = perf_counter()
        out = get_backend(backend, **backend_opts).execute_many(plans)
        _observe_workload(plans, perf_counter() - t0)
        return out

    def equality_query(self, col_idx: int, value: int, backend: str = "torch"):
        """Rows where column == value (planner-compiled AND of the value's
        k bitmaps).

        Returns (row_ids, words_scanned).  col_idx refers to the *reordered*
        column position (use .original_column(col_idx) for the mapping).
        """
        from .query import Eq

        return self.query(Eq(self.original_column(col_idx), value),
                          backend=backend)

    def original_column(self, reordered_idx: int) -> int:
        return int(self.col_perm[reordered_idx])

    def encodings(self) -> tuple:
        """Per-column encoding kinds, in reordered column order (what the
        spec's encoding chooser picked per histogram)."""
        return tuple(c.encoding.kind for c in self.columns)


def _construct(table_cols: list, spec: IndexSpec | None,
               materialize: bool = True,
               encoding_chooser=None) -> "BitmapIndex":
    """The actual Algorithm-1 pipeline over one run of rows.

    This is what :meth:`IndexWriter.seal` runs per segment (and what
    ``BitmapIndex.build`` reaches through its one-segment writer): column
    histograms -> column permutation -> row sort -> per-column encoding
    choice (the spec's ``encoding`` strategy reads each histogram) ->
    per-encoding EWAH streams (k-of-N value bitmaps, bit-slice planes,
    histogram-equalized bins, or Roaring container sets; see
    :mod:`repro.core.encodings`).

    ``encoding_chooser(original_col, hist, k) -> kind | None`` overrides
    the spec's static chooser per column — the workload-driven
    re-encoding hook compaction passes down
    (:func:`repro_torch.workload.make_compaction_chooser`); a None return
    defers that column back to the spec.
    """
    spec = (spec or IndexSpec()).validate()
    strategies = spec.strategies()

    table_cols = [np.asarray(c) for c in table_cols]
    n = len(table_cols[0])
    cards = [int(c.max()) + 1 for c in table_cols]

    if strategies["column_order"] is not None:
        perm_cols = np.asarray(strategies["column_order"](cards, spec.k))
    else:  # explicit permutation carried by the spec
        perm_cols = np.asarray(spec.column_order)
    cols = [table_cols[i] for i in perm_cols]
    cards = [cards[i] for i in perm_cols]

    # histograms are row-permutation invariant: compute once, share with
    # the row-order strategy, the value policy, and the encoding chooser
    hists = [column_histogram(c, card) for c, card in zip(cols, cards)]
    row_perm = strategies["row_order"](cols, hists)
    cols = [c[row_perm] for c in cols]

    idx = BitmapIndex(n_rows=n, spec=spec, row_perm=np.asarray(row_perm),
                      col_perm=perm_cols)
    chooser = strategies["encoding"]
    for pos, col, card, hist in zip(perm_cols, cols, cards, hists):
        kind = None
        if encoding_chooser is not None:
            kind = encoding_chooser(int(pos), hist, spec.k)
        if kind is None:
            kind = chooser(hist, spec.k)
        enc = build_encoding(kind, col, card, hist, spec,
                             materialize=materialize)
        idx.columns.append(ColumnIndex(encoding=enc))
    return idx


def index_size_report(table_cols, spec: IndexSpec | None = None,
                      **removed) -> dict:
    """Size-only construction (no bitmap materialization)."""
    _reject_legacy(removed)
    idx = BitmapIndex.build(table_cols, spec, materialize=False)
    return {
        "total_words": idx.size_words(),
        "per_column_words": idx.per_column_words(),
        "column_order": [int(i) for i in idx.col_perm],
        "encodings": list(idx.encodings()),
        "k_effective": [getattr(c.encoding, "k", None) for c in idx.columns],
        "bitmaps": [c.N for c in idx.columns],
    }
