"""Immutable index segments and the segmented query surface.

The paper's pipeline (histogram -> column/value reordering -> row sort ->
EWAH) runs *per segment*: a :class:`Segment` is one sealed, immutable run of
rows with its own locally-sorted :class:`~repro_torch.core.bitmap_index.BitmapIndex`
("Sorting improves word-aligned bitmap indexes" shows the sorting benefit
survives partitioning into independently sorted blocks).  A
:class:`SegmentedIndex` stitches many segments — plus the owning writer's
open (not yet sealed) row buffer — into one query surface:

* segments partition the global row space into contiguous *id spans*, every
  physical segment boundary word-aligned (a multiple of 32 rows), exactly
  the shard contract of the reference package's ``repro.dist.query_fanout``,
  so per-segment compressed results concatenate with
  :func:`~repro_torch.core.ewah_stream.concat_streams`;
* predicates compile per segment (value domains are segment-local: a value
  a segment never saw compiles to a constant-empty leaf) and execute
  through the existing compressed engine in **one** batched backend call;
* open-buffer rows — the writer's in-flight tail — evaluate directly over
  the uncompressed columns (:func:`~repro_torch.core.query.evaluate_mask`), so
  appends are queryable before any seal;
* row ids come back in **original ingest order** (each segment's local ids
  map through its ``row_perm`` plus its id span) — there is no global
  reordered space across independently sorted segments;
* encodings are **per segment, per column**: each seal re-runs the spec's
  encoding chooser on that segment's own histograms, so an ``'auto'`` spec
  can give the same column different encodings in different segments
  (mixed-encoding segments).  Nothing downstream cares — predicates
  compile per segment against whatever encoding that segment has, and the
  per-plane/per-bitmap representations never cross a segment boundary:
  only *result* streams concatenate.  Compaction concatenates the retired
  segments' raw columns and re-runs the whole pipeline, so the merged
  segment re-chooses its encodings from the merged histograms.

LSM mutability (docs/lifecycle.md):

* **Tombstones.**  Sealed segments stay physically immutable but carry a
  mutable *tombstone* bitmap — an EWAH stream in the segment's reordered
  row space.  A delete ORs into it in the compressed domain and recomputes
  the cached **live mask** (the marker-flip complement,
  :func:`~repro_torch.core.ewah_stream.logical_not`); every compiled plan root
  is then ANDed with the live mask
  (:func:`~repro_torch.core.query.with_live_mask`), so a delete costs one extra
  merge per segment at query time, never a rebuild.
* **TTLs.**  A segment may carry an ingest-order ``expiry`` array (absolute
  deadlines; ``inf`` = never).  Expired rows fold into the tombstones
  *lazily at query time* — the fold memoizes the next-unexpired horizon,
  so the check is O(1) until something actually expires — and are
  physically dropped at compaction.
* **Purged spans.**  Compaction drops dead rows, so a merged segment's id
  span ``[row_start, row_stop)`` can cover more ids than it has physical
  rows; ``row_ids`` then records the surviving ingest ids.  A fully-dead
  span compacts to a valid zero-row segment that keeps the span covered.

Each segment carries a monotonically increasing ``generation``; its index's
``cache_scope`` tags every compressed result the backends cache, so
compaction evicts exactly the retired segments' cache entries
(:func:`repro_torch.core.query.invalidate_scope`) and untouched segments keep
their hits.  See docs/lifecycle.md.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from time import perf_counter

import numpy as np

from . import ewah, ewah_stream
from ..analysis.runtime import maybe_validate
from .bitmap_index import BitmapIndex, _observe_workload
from .ewah_stream import EwahStream, concat_streams
from .query import compile_plan, evaluate_mask, get_backend, with_live_mask

__all__ = ["Segment", "SegmentedIndex"]

_GENERATIONS = itertools.count(1)


def next_generation() -> int:
    """Process-wide monotonic segment generation (cache-invalidation key)."""
    return next(_GENERATIONS)


@dataclass(frozen=True, eq=False)  # identity equality: fields hold ndarrays
class Segment:
    """One sealed run of rows with its own local index.

    ``columns`` keeps the segment's rows in **original ingest order** — the
    row store compaction re-sorts from (a production system would re-read
    them from storage); seal with ``keep_columns=False`` when the segment
    will never compact (the dist fan-out shards do this) and the raw
    arrays are dropped.  ``index`` is the histogram-aware build over the
    rows; ``generation`` is the process-wide monotonic id that scopes the
    segment's entries in backend result caches.

    The physical rows are immutable; the only mutable state is the
    *tombstone* bitmap (deleted rows, reordered row space) and its cached
    complement, the **live mask**.  Both update by whole-array replacement
    (publish-by-reference), so a concurrent reader holding either sees a
    consistent point-in-time mask.

    ``row_start``/``span_stop`` bound the segment's ingest-id span; after a
    purging compaction the span can cover more ids than physical rows, and
    ``row_ids`` records which ids survived (None = the contiguous
    ``arange(row_start, row_start + n_rows)``).  ``expiry`` holds absolute
    per-row deadlines in ingest order (None = no TTLs).
    """

    index: BitmapIndex
    columns: tuple | None = field(repr=False)  # ingest-order arrays, or None
    row_start: int
    generation: int
    span_stop: int | None = None               # id-span end; None = physical
    row_ids: np.ndarray | None = field(default=None, repr=False)
    expiry: np.ndarray | None = field(default=None, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "_tombstone", None)  # deleted, reordered
        object.__setattr__(self, "_live", None)       # cached complement
        object.__setattr__(self, "_inv_perm_cache", None)
        horizon = np.inf
        if self.expiry is not None and len(self.expiry):
            lo = float(self.expiry.min())
            horizon = lo if np.isfinite(lo) else np.inf
        object.__setattr__(self, "_expiry_horizon", horizon)

    @staticmethod
    def seal(table_cols, spec=None, *, row_start: int = 0,
             materialize: bool = True, keep_columns: bool = True,
             span_stop: int | None = None, row_ids=None, expiry=None,
             tombstone_rows=None, encoding_chooser=None) -> "Segment":
        """Run the full per-segment pipeline and freeze the result.

        ``row_ids`` (ascending global ingest ids, one per row) and
        ``span_stop`` describe a purged id span; ``expiry`` carries
        ingest-order absolute deadlines; ``tombstone_rows`` marks
        ingest-local positions dead at birth (buffer deletes surviving a
        seal, compaction's word-alignment filler rows).
        ``encoding_chooser`` is the workload-driven per-column override
        compaction threads down to ``_construct`` (docs/containers.md).
        """
        from .bitmap_index import _construct

        cols = tuple(np.asarray(c) for c in table_cols)
        gen = next_generation()
        index = _construct(list(cols), spec, materialize=materialize,
                           encoding_chooser=encoding_chooser)
        index.cache_scope = ("segment", gen)
        if expiry is not None:
            expiry = np.asarray(expiry, dtype=np.float64)
            if not np.isfinite(expiry).any():
                expiry = None  # all-inf: no TTLs to track
        if row_ids is not None:
            row_ids = np.asarray(row_ids, dtype=np.int64)
            # ascending + first/last contiguous => the whole run is the
            # implicit arange; drop the array
            if len(row_ids) and row_ids[0] == row_start \
                    and row_ids[-1] == row_start + len(row_ids) - 1:
                row_ids = None
        seg = Segment(index=index, columns=cols if keep_columns else None,
                      row_start=int(row_start), generation=gen,
                      span_stop=None if span_stop is None else int(span_stop),
                      row_ids=row_ids, expiry=expiry)
        if tombstone_rows is not None:
            seg.delete_ingest_local(tombstone_rows)
        return seg

    @staticmethod
    def empty(row_start: int, span_stop: int) -> "Segment":
        """A valid zero-row segment covering ``[row_start, span_stop)`` —
        what a fully-tombstoned span compacts to.  It keeps the id span
        contiguous for its neighbours while contributing nothing (and
        costing nothing) to execution."""
        gen = next_generation()
        index = BitmapIndex(n_rows=0, columns=[],
                            row_perm=np.zeros(0, dtype=np.int64),
                            col_perm=np.zeros(0, dtype=np.int64))
        index.cache_scope = ("segment", gen)
        return Segment(index=index, columns=(), row_start=int(row_start),
                       generation=gen, span_stop=int(span_stop))

    # -- shape ---------------------------------------------------------------

    @property
    def n_rows(self) -> int:
        """Physical (surviving) rows."""
        return self.index.n_rows

    @property
    def n_words(self) -> int:
        return (self.n_rows + ewah.WORD_BITS - 1) // ewah.WORD_BITS

    @property
    def row_stop(self) -> int:
        """End of the ingest-id span (>= ``row_start + n_rows`` after a
        purging compaction)."""
        if self.span_stop is not None:
            return self.span_stop
        return self.row_start + self.n_rows

    @property
    def cache_scope(self) -> tuple:
        return ("segment", self.generation)

    def size_words(self) -> int:
        return self.index.size_words()

    def ingest_ids(self) -> np.ndarray:
        """Global ingest ids of the physical rows, ascending ingest order."""
        if self.row_ids is not None:
            return self.row_ids
        return np.arange(self.row_start, self.row_start + self.n_rows,
                         dtype=np.int64)

    def original_rows(self, local_rows: np.ndarray) -> np.ndarray:
        """Map segment-local reordered row ids to original ingest ids."""
        ingest_local = np.asarray(self.index.row_perm)[
            np.asarray(local_rows, dtype=np.int64)]
        if self.row_ids is not None:
            return self.row_ids[ingest_local]
        return self.row_start + ingest_local

    def _inv_perm(self) -> np.ndarray:
        inv = self._inv_perm_cache
        if inv is None:
            perm = np.asarray(self.index.row_perm)
            inv = np.empty(len(perm), dtype=np.int64)
            inv[perm] = np.arange(len(perm))
            object.__setattr__(self, "_inv_perm_cache", inv)
        return inv

    # -- tombstones / TTL ----------------------------------------------------

    @property
    def tombstones(self) -> EwahStream | None:
        """Deleted-row bitmap (reordered row space), or None."""
        t = self._tombstone
        return EwahStream(t, self.n_rows, len(t)) if t is not None else None

    def live_stream(self, now=None):
        """Compressed live-row mask the planner ANDs into every plan root
        (:func:`~repro_torch.core.query.with_live_mask`), or None when every
        physical row is live.  Passing ``now`` folds newly-expired rows in
        first (O(1) when nothing newly expires)."""
        if now is not None:
            self.fold_expired(now)
        return self._live

    def _apply_tombstone(self, stream: np.ndarray) -> None:
        cur = self._tombstone
        if cur is None:
            new = np.asarray(stream, dtype=np.uint32)
        else:
            new, _ = ewah_stream.logical_op(cur, stream, "or")
        live, _ = ewah_stream.logical_not(new, self.n_words)
        # publish complement first: a reader pairing old tombstones with
        # the new live mask would only over-exclude, never resurrect
        object.__setattr__(self, "_live", live)
        object.__setattr__(self, "_tombstone", new)

    def delete_reordered(self, positions) -> int:
        """Tombstone segment-local *reordered* row positions (what a
        compiled plan's execution returns).  Idempotent; returns the count
        of newly-dead rows."""
        positions = np.unique(np.asarray(positions, dtype=np.int64))
        if not len(positions):
            return 0
        before = self.deleted_count()
        words = ewah.positions_to_words(positions, self.n_rows)
        self._apply_tombstone(ewah.compress(words))
        return self.deleted_count() - before

    def delete_ingest_local(self, positions) -> int:
        """Tombstone ingest-local row positions (0..n_rows)."""
        positions = np.asarray(positions, dtype=np.int64)
        if not len(positions):
            return 0
        return self.delete_reordered(self._inv_perm()[positions])

    def delete_ids(self, ids) -> int:
        """Tombstone by global ingest id.  Ids outside the span — or inside
        it but already purged by a compaction — are silently ignored (the
        row is gone either way).  Returns the newly-dead count."""
        ids = np.asarray(ids, dtype=np.int64)
        ids = ids[(ids >= self.row_start) & (ids < self.row_stop)]
        if not len(ids):
            return 0
        mine = self.ingest_ids()
        pos = np.searchsorted(mine, ids)
        hit = pos < len(mine)
        pos = pos[hit]
        present = mine[pos] == ids[hit]
        if not present.any():
            return 0
        return self.delete_ingest_local(pos[present])

    def deleted_count(self) -> int:
        """Tombstoned rows (not counting unexpired TTL rows)."""
        t = self._tombstone
        return EwahStream(t, self.n_rows, 0).count() if t is not None else 0

    def fold_expired(self, now) -> None:
        """Fold rows whose TTL deadline has passed into the tombstones.

        Lazy: memoizes the earliest still-pending deadline, so until the
        clock crosses it this is a single float compare."""
        if self.expiry is None or now < self._expiry_horizon:
            return
        expired = np.flatnonzero(self.expiry <= now)
        pending = self.expiry[self.expiry > now]
        horizon = float(pending.min()) if len(pending) else np.inf
        self.delete_ingest_local(expired)
        object.__setattr__(self, "_expiry_horizon", horizon)

    def dead_ingest_mask(self, now=None) -> np.ndarray:
        """(n_rows,) bool in ingest order: tombstoned, or expired at
        ``now`` (whether or not the expiry has been folded yet)."""
        mask = np.zeros(self.n_rows, dtype=bool)
        t = self._tombstone
        if t is not None:
            reordered = EwahStream(t, self.n_rows, 0).to_rows()
            mask[np.asarray(self.index.row_perm)[reordered]] = True
        if self.expiry is not None and now is not None:
            mask |= self.expiry <= now
        return mask

    def dead_ids(self, now=None) -> np.ndarray:
        """Global ingest ids of dead rows (ascending)."""
        return self.ingest_ids()[self.dead_ingest_mask(now)]


class SegmentedIndex:
    """A query surface over sealed segments plus an optional open buffer.

    Built by :class:`repro_torch.core.lifecycle.IndexWriter` (the live ``.index``
    view) or directly from a list of segments (the dist fan-out path).  The
    contract every execution method checks:

    * segments cover contiguous ingest-id spans in order;
    * every segment but the last covers a multiple of 32 *physical* rows
      (word alignment — what lets compressed results concatenate in word
      space; a purged segment stays aligned via compaction's filler rows,
      and zero-row segments are trivially aligned);
    * the open buffer, when present, sits after the last segment.

    Writer-backed views are **live and snapshot-consistent**: every
    execution reads the writer's segment tuple and buffer once, atomically,
    so a query overlapping a background compaction sees the old or the new
    segment list — never a mix (the writer swaps the tuple by reference).
    """

    def __init__(self, segments, names=None, writer=None, clock=None):
        self._segments = tuple(segments)
        self.names = names
        self._writer = writer
        # writerless views (e.g. fan-out shards) that carry TTL deadlines
        # issued under an injected writer clock must evaluate "now" on that
        # same clock, or every deadline is in the distant past/future
        self._clock = clock

    # -- shape -------------------------------------------------------------

    def _snapshot(self):
        """One consistent (segments, buffer) view.  ``buffer`` is
        ``(columns, deleted_mask, expiry)`` or None."""
        w = self._writer
        if w is None:
            return self._segments, None
        return w.snapshot()

    @property
    def segments(self) -> list:
        return list(self._snapshot()[0])

    @property
    def n_segments(self) -> int:
        return len(self._snapshot()[0])

    def generations(self) -> tuple:
        return tuple(s.generation for s in self._snapshot()[0])

    def encodings(self) -> tuple:
        """Per-segment tuple of per-column encoding kinds (the chooser runs
        on each segment's own histograms, so these may differ — mixed-
        encoding segments are a supported steady state)."""
        return tuple(s.index.encodings() for s in self._snapshot()[0])

    @property
    def n_sealed_rows(self) -> int:
        """End of the sealed ingest-id span (the open buffer's first id)."""
        segs, _ = self._snapshot()
        return segs[-1].row_stop if segs else 0

    @property
    def n_rows(self) -> int:
        """Physical rows: surviving sealed rows plus the open buffer
        (purged rows no longer count)."""
        segs, buf = self._snapshot()
        return (sum(s.n_rows for s in segs)
                + (len(buf[1]) if buf is not None else 0))

    def size_words(self) -> int:
        """Compressed words across sealed segments (buffer rows are not
        compressed until sealed)."""
        return sum(s.size_words() for s in self._snapshot()[0])

    def _now(self, now):
        if now is not None:
            return float(now)
        if self._clock is not None:
            return self._clock()
        w = self._writer
        return w.clock() if w is not None else time.time()

    @staticmethod
    def _check(segments, has_buffer: bool) -> None:
        pos = segments[0].row_start if segments else 0
        last = len(segments) - 1
        for i, seg in enumerate(segments):
            if seg.row_start != pos:
                raise ValueError(
                    f"segment {i} (gen {seg.generation}) starts at "
                    f"{seg.row_start}, expected {pos}: segments must cover "
                    "contiguous id spans")
            if i < last and seg.n_rows % ewah.WORD_BITS:
                raise ValueError(
                    f"segment {i} (gen {seg.generation}) holds {seg.n_rows} "
                    "rows — every segment but the last must be word-aligned "
                    "(a multiple of 32 physical rows)")
            pos = seg.row_stop
        if has_buffer and segments \
                and segments[last].n_rows % ewah.WORD_BITS:
            raise ValueError(
                "open buffer follows a non-word-aligned final segment; "
                "seal order violated the alignment contract")

    # -- deletes (shared by the writer and writerless shard views) ---------

    def delete(self, pred=None, *, row_ids=None, backend: str = "torch",
               names=None, now=None) -> int:
        """Tombstone sealed rows by predicate or by global ingest id.

        Writer-backed views should prefer
        :meth:`~repro_torch.core.lifecycle.IndexWriter.delete`, which also covers
        the open buffer; this method handles sealed segments only (the
        writerless dist fan-out path).  Returns the newly-dead row count.
        """
        if (pred is None) == (row_ids is None):
            raise ValueError("delete needs exactly one of pred= or row_ids=")
        segs, _ = self._snapshot()
        deleted = 0
        if row_ids is not None:
            ids = np.unique(np.asarray(row_ids, dtype=np.int64))
            for seg in segs:
                deleted += seg.delete_ids(ids)
            return deleted
        names = names if names is not None else self.names
        be = get_backend(backend)
        now = self._now(now)
        for seg in segs:
            if not seg.n_rows:
                continue
            seg.fold_expired(now)
            plan = compile_plan(seg.index, pred, names=names)
            rows, _ = be.execute(plan)
            deleted += seg.delete_reordered(rows)
        return deleted

    # -- execution ---------------------------------------------------------

    def execute_compressed(self, pred, backend: str = "torch", names=None,
                           now=None, **backend_opts):
        """Per-segment compressed execution; returns
        ``(segment_streams, merged)`` — the merged stream covers sealed
        segments *and* open-buffer rows."""
        return self.execute_compressed_many(
            [pred], backend=backend, names=names, now=now,
            **backend_opts)[0]

    def execute_compressed_many(self, preds, backend: str = "torch",
                                names=None, now=None, **backend_opts):
        """Batched execution: all predicates' per-segment plans go to the
        backend in one ``execute_compressed_many`` call (same-shape plans
        batch across predicates and segments on the torch backend).  The open
        buffer evaluates densely over its uncompressed columns and its
        result stream concatenates after the sealed segments."""
        _, _, triples = self._execute_many(preds, backend, names,
                                           backend_opts, now)
        return [(per_seg, merged) for per_seg, _, merged in triples]

    def _execute_many(self, preds, backend, names, backend_opts, now=None):
        """-> (segments, buffer, triples): one (per_segment_streams,
        buffer_rows|None, merged) triple per predicate, all against a
        single atomic snapshot; the buffer is evaluated exactly once per
        predicate.  Tombstoned/expired rows are excluded everywhere: each
        sealed plan root is ANDed with its segment's live mask (one extra
        merge), buffer rows mask densely."""
        segs, buf = self._snapshot()
        self._check(segs, buf is not None)
        now = self._now(now)
        names = names if names is not None else self.names
        be = get_backend(backend, **backend_opts)
        live = [s.live_stream(now) if s.n_rows else None for s in segs]
        active = [j for j, s in enumerate(segs) if s.n_rows]
        plans = []
        for p in preds:
            for j in active:
                plan = compile_plan(segs[j].index, p, names=names)
                plans.append(with_live_mask(plan, live[j]))
        t0 = perf_counter()
        if hasattr(be, "execute_compressed_many"):
            results = be.execute_compressed_many(plans)
        else:
            results = [be.execute_compressed(p) for p in plans]
        _observe_workload(plans, perf_counter() - t0)
        total_rows = (sum(s.n_rows for s in segs)
                      + (len(buf[1]) if buf is not None else 0))
        out = []
        k = len(active)
        empty = ewah.compress(np.zeros(0, dtype=np.uint32))
        for i, pred in enumerate(preds):
            got = iter(results[i * k : (i + 1) * k])
            per_seg = [next(got) if s.n_rows else EwahStream(empty, 0, 0)
                       for s in segs]
            parts = [r.data for r in per_seg]
            scanned = sum(r.words_scanned for r in per_seg)
            buf_rows = None
            if buf is not None:
                cols, bdel, bexp = buf
                # dense one-pass evaluation; scan cost is the buffer's
                # dense word count
                mask = evaluate_mask(pred, cols, names=names)
                mask &= ~bdel & (bexp > now)
                buf_rows = np.flatnonzero(mask)
                words = ewah.positions_to_words(buf_rows, len(mask))
                parts.append(ewah.compress(words))
                scanned += len(words)
            merged = (EwahStream(concat_streams(parts), total_rows, scanned)
                      if parts else EwahStream(empty, 0, 0))
            maybe_validate(merged, origin="SegmentedIndex._execute_many")
            out.append((per_seg, buf_rows, merged))
        return segs, buf, out

    def query(self, pred, backend: str = "torch", names=None, now=None,
              **backend_opts):
        """Returns ``(row_ids, words_scanned)`` with row ids in **original**
        ingest row space, sorted ascending."""
        return self.query_many([pred], backend=backend, names=names,
                               now=now, **backend_opts)[0]

    def query_many(self, preds, backend: str = "torch", names=None,
                   now=None, **backend_opts):
        """Batched queries; one (row_ids, words_scanned) per predicate."""
        segs, _, triples = self._execute_many(preds, backend, names,
                                              backend_opts, now)
        buf_start = segs[-1].row_stop if segs else 0
        out = []
        for per_seg, buf_rows, merged in triples:
            ids = [seg.original_rows(r.to_rows())
                   for seg, r in zip(segs, per_seg) if seg.n_rows]
            if buf_rows is not None:
                ids.append(buf_start + buf_rows)
            rows = (np.sort(np.concatenate(ids)) if ids
                    else np.asarray([], dtype=np.int64))
            out.append((rows, merged.words_scanned))
        return out

    def count(self, pred, backend: str = "torch", names=None, now=None,
              **backend_opts) -> int:
        """Matching live-row count without materializing ids (compressed-
        domain popcount of the merged stream; tombstoned and expired rows
        are already ANDed out)."""
        _, merged = self.execute_compressed(pred, backend=backend,
                                            names=names, now=now,
                                            **backend_opts)
        return merged.count()
