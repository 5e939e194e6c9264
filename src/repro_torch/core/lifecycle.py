"""Index lifecycle: the append / delete / seal / compact writer API.

The one-shot ``BitmapIndex.build`` freezes the paper's whole pipeline behind
a single static call — every new batch of rows would force a full re-sort
and re-encode.  :class:`IndexWriter` makes the lifecycle incremental,
LSM-style:

* ``writer.append(rows, ttl=...)`` buffers rows in the **open segment**
  (queryable immediately through the live
  :class:`~repro_torch.core.segment.SegmentedIndex` view — dense evaluation, no
  index build); ``ttl`` stamps per-row absolute expiry deadlines;
* ``writer.delete(pred | row_ids)`` tombstones rows wherever they live:
  sealed segments OR the delete into their compressed tombstone bitmap
  (one merge, no rebuild — every later query ANDs the cached live mask
  into its plan root), buffered rows flip a dense mask;
* ``writer.seal()`` runs the full histogram-aware pipeline (histogram
  refresh, column/value reordering, row sort per the ``IndexSpec``) on the
  word-aligned prefix of the buffer and emits an immutable
  :class:`~repro_torch.core.segment.Segment`; the ``len(buffer) % 32`` tail rows
  carry over into the next open segment, preserving the word-alignment
  contract that lets segment results concatenate in word space.  Buffered
  deletes and TTLs travel into the new segment's tombstones/expiry — an
  all-deleted buffer seals into a valid fully-tombstoned segment;
* ``writer.close()`` seals *everything* left (the final segment may be
  non-word-aligned — it is last, so nothing concatenates after it) and
  rejects further appends (deletes and compaction stay legal: an LSM keeps
  maintaining closed data);
* :func:`compact` merges adjacent segments into one re-sorted segment and
  **purges** tombstoned/expired rows (up to 31 dead rows survive as
  tombstoned fillers so the merged segment stays word-aligned; a
  fully-dead span yields a valid zero-row segment).  The full pipeline
  re-runs, including the spec's per-column encoding chooser over the
  *merged* histograms; the merged segment's ``row_ids`` keep surviving
  ingest ids stable across purges.  ``writer.compact()`` applies the
  size-tiered policy, swaps the merged segment in **atomically** (the
  segment list is a copy-on-write tuple: concurrent queries see the old or
  the new list, never a mix), replays deletes that raced the merge, and
  evicts exactly the retired segments' result-cache entries
  (:func:`repro_torch.core.query.invalidate_scope`);
* :class:`BackgroundCompactor` runs that policy on a scheduler thread —
  compaction leaves the serving path entirely — with exponential backoff
  on transient failures and a drain-on-close that finishes pending tiers.

Thread-safety contract: any number of query threads (and one background
compactor) may run against one writer concurrently with its owner calling
``append``/``delete``/``seal``/``close``; the mutating calls themselves are
serialized by the writer (single-writer discipline, enforced by an RLock).

``BitmapIndex.build`` is now a seal-once convenience over this writer.
See docs/lifecycle.md for semantics and the cache-invalidation contract.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from . import ewah
from ..analysis.runtime import make_lock
from .query import compile_plan, evaluate_mask, get_backend, invalidate_scope
from .segment import Segment, SegmentedIndex
from .strategies import IndexSpec

__all__ = ["BackgroundCompactor", "IndexWriter", "compact",
           "size_tiered_pick"]


class IndexWriter:
    """Incremental builder: append rows, tombstone deletes, seal immutable
    segments, compact (foreground or via :class:`BackgroundCompactor`).

    Parameters
    ----------
    spec:
        The :class:`~repro_torch.core.strategies.IndexSpec` every seal resolves
        (one spec per writer — segments of one index sort consistently).
    names:
        Optional column names, forwarded to the query surface.
    seal_rows:
        Auto-seal threshold: ``append`` seals whenever the open buffer
        reaches this many rows (None = manual sealing only).
    materialize:
        Forwarded to the per-segment index build (False = sizes only).
    clock:
        TTL time source (absolute seconds; default ``time.time``).
        Injectable so tests can expire rows deterministically.
    workload_stats:
        Optional :class:`~repro_torch.workload.WorkloadStats`.  When set,
        every compaction fits a cost model over the recorded query mix
        and re-encodes the merged segment's columns toward the cheapest
        candidate (``repro_torch.workload.make_compaction_chooser``); unset
        keeps the spec's static per-histogram chooser.
    """

    def __init__(self, spec: IndexSpec | None = None, *, names=None,
                 seal_rows: int | None = None, materialize: bool = True,
                 clock=time.time, workload_stats=None):
        self.spec = (spec or IndexSpec()).validate()
        self.names = tuple(names) if names is not None else None
        self.seal_rows = seal_rows
        self.materialize = materialize
        self.clock = clock
        # optional WorkloadStats: compactions consult the fitted cost
        # model and re-encode merged segments toward the observed query
        # mix (repro_torch.workload.make_compaction_chooser)
        self.workload_stats = workload_stats
        self._segments: tuple[Segment, ...] = ()    # guarded-by: _lock
        self._chunks: list[list[np.ndarray]] = []   # guarded-by: _lock
        self._chunk_deleted: list[np.ndarray] = []  # guarded-by: _lock
        self._chunk_expiry: list[np.ndarray] = []   # guarded-by: _lock
        self._buffered = 0                          # guarded-by: _lock
        self._n_cols: int | None = None             # guarded-by: _lock
        self._closed = False                        # guarded-by: _lock
        # _lock serializes mutations and makes (segments, buffer) snapshots
        # atomic; _compact_lock keeps compactions single-file so the
        # background compactor and a foreground compact() can't both retire
        # the same run.  Acquisition order is _compact_lock before _lock,
        # never the reverse (the REPRO_SANITIZE lock-order sanitizer
        # enforces it at runtime).
        self._lock = make_lock("writer._lock")
        self._compact_lock = make_lock("writer._compact_lock",
                                       reentrant=False)

    @classmethod
    def from_parts(cls, spec=None, *, names=None, segments=(),
                   buffer=None, closed=False, seal_rows=None,
                   materialize=True, clock=time.time,
                   workload_stats=None) -> "IndexWriter":
        """Reassemble a writer from previously-sealed parts — the restore
        hook for the sharded serve-plane checkpoints
        (the reference package's
        ``repro.dist.serve_plane.ServePlane.restore``).

        ``segments`` are already-sealed :class:`Segment` objects covering
        contiguous id spans (typically re-sealed from checkpointed raw
        columns with their recorded encodings); ``buffer`` is the open
        tail as ``(columns, deleted_mask, expiry)`` or None.  The writer
        behaves exactly as if it had ingested those rows itself: appends,
        deletes, seals, and compactions all remain legal (unless
        ``closed``).
        """
        w = cls(spec, names=names, seal_rows=seal_rows,
                materialize=materialize, clock=clock,
                workload_stats=workload_stats)
        segments = tuple(segments)
        with w._lock:
            w._segments = segments
            if buffer is not None:
                cols, deleted, expiry = buffer
                cols = [np.asarray(c) for c in cols]
                n = len(deleted)
                if n:
                    w._chunks = [cols]
                    w._chunk_deleted = [np.asarray(deleted, dtype=bool)]
                    w._chunk_expiry = [np.asarray(expiry,
                                                  dtype=np.float64)]
                    w._buffered = n
                w._n_cols = len(cols)
            elif segments:
                live = next((s for s in segments if s.columns), None)
                if live is not None:
                    w._n_cols = len(live.columns)
            w._closed = bool(closed)
        SegmentedIndex._check(segments, buffer is not None)
        return w

    # -- state -------------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed  # analysis-ok: lock/unguarded-read atomic flag read

    @property
    def buffered_rows(self) -> int:
        return self._buffered  # analysis-ok: lock/unguarded-read atomic int read

    @property
    def n_rows(self) -> int:
        """Ingest ids issued so far (sealed span + buffer); purged rows do
        not shrink this — ids are stable forever."""
        # under _lock: a concurrent seal moves rows from the buffer into a
        # segment, and an unlocked sum could count them twice or miss them
        with self._lock:
            return self.sealed_rows + self._buffered

    @property
    def sealed_rows(self) -> int:
        """End of the sealed ingest-id span (the buffer's first id)."""
        segs = self._segments  # analysis-ok: lock/unguarded-read atomic tuple-reference snapshot
        return segs[-1].row_stop if segs else 0

    @property
    def segments(self) -> list:
        """Snapshot of the sealed segments (copy-on-write: compaction swaps
        the underlying tuple by reference, it never mutates this list)."""
        return list(self._segments)  # analysis-ok: lock/unguarded-read atomic tuple-reference snapshot

    def snapshot(self):
        """Atomic (segments, buffer) view for the query surface; ``buffer``
        is ``(columns, deleted_mask, expiry)`` or None."""
        with self._lock:
            segs = self._segments
            if not self._buffered:
                return segs, None
            cols = [np.concatenate([chunk[c] for chunk in self._chunks])
                    for c in range(self._n_cols)]
            deleted = np.concatenate(self._chunk_deleted)
            expiry = np.concatenate(self._chunk_expiry)
        return segs, (cols, deleted, expiry)

    def buffer_columns(self) -> list:
        """The open buffer as per-column arrays (ingest order); [] when
        nothing is buffered."""
        with self._lock:
            if not self._chunks:
                return []
            return [np.concatenate([chunk[c] for chunk in self._chunks])
                    for c in range(self._n_cols)]

    @property
    def index(self) -> SegmentedIndex:
        """The live query surface: sealed segments + the open buffer."""
        return SegmentedIndex(self._segments, names=self.names,  # analysis-ok: lock/unguarded-read atomic tuple-reference snapshot
                              writer=self)

    def size_words(self) -> int:
        return sum(s.size_words() for s in self._segments)  # analysis-ok: lock/unguarded-read atomic tuple-reference snapshot

    def live_rows(self, now=None) -> int:
        """Rows a whole-domain query would return right now."""
        now = self.clock() if now is None else float(now)
        with self._lock:
            segs = self._segments
            buf_live = 0
            for dmask, emask in zip(self._chunk_deleted, self._chunk_expiry):
                buf_live += int((~dmask & (emask > now)).sum())
        sealed = 0
        for s in segs:
            s.fold_expired(now)
            sealed += s.n_rows - s.deleted_count()
        return sealed + buf_live

    # -- append ------------------------------------------------------------

    def append(self, rows, *, ttl=None) -> None:
        """Buffer a batch of rows in the open segment.

        ``rows`` is a list of per-column integer value-id arrays (the
        ``BitmapIndex.build`` table convention) or, when the writer carries
        ``names``, a dict mapping those names to arrays.  All columns must
        be equal length; column count is fixed by the first append.

        ``ttl`` (seconds; scalar or per-row array) stamps the rows with
        absolute expiry deadlines ``clock() + ttl``; expired rows vanish
        from queries lazily (folded into tombstones at query time) and are
        physically dropped at compaction.
        """
        if self._closed:  # analysis-ok: lock/unguarded-read fast-fail; rechecked under _lock below
            raise ValueError("writer is closed; no further appends")
        if isinstance(rows, dict):
            if self.names is None:
                raise ValueError(
                    "dict appends need a writer built with names=...")
            missing = [c for c in self.names if c not in rows]
            if missing:
                raise ValueError(f"append missing columns: {missing}")
            rows = [rows[c] for c in self.names]
        chunk = [np.asarray(c) for c in rows]
        if not chunk:
            raise ValueError("append needs at least one column")
        n = len(chunk[0])
        if any(len(c) != n for c in chunk):
            raise ValueError("append columns must be equal length")
        expiry = np.full(n, np.inf)
        if ttl is not None:
            t = np.asarray(ttl, dtype=np.float64)
            if t.ndim == 0:
                t = np.full(n, float(t))
            elif len(t) != n:
                raise ValueError(
                    f"ttl has {len(t)} entries for {n} rows")
            expiry = self.clock() + t
        with self._lock:
            # closed/column-count checks belong under the lock: two racing
            # first appends could otherwise both set _n_cols, and a close
            # racing the buffer push could seal without these rows
            if self._closed:
                raise ValueError("writer is closed; no further appends")
            if self._n_cols is None:
                self._n_cols = len(chunk)
            elif len(chunk) != self._n_cols:
                raise ValueError(
                    f"append has {len(chunk)} columns, writer has "
                    f"{self._n_cols}")
            if n == 0:
                return
            self._chunks.append(chunk)
            self._chunk_deleted.append(np.zeros(n, dtype=bool))
            self._chunk_expiry.append(expiry)
            buffered = self._buffered = self._buffered + n
        if self.seal_rows is not None and buffered >= self.seal_rows:
            self.seal()

    # -- delete ------------------------------------------------------------

    def delete(self, pred=None, *, row_ids=None, backend: str = "torch",
               now=None) -> int:
        """Tombstone rows by predicate or by global ingest id.

        Sealed segments take the delete as a compressed-domain OR into
        their tombstone bitmap (the live-mask complement recomputes once,
        off the query path); buffered rows flip a dense mask that seals
        into the next segment's tombstones.  Ids already dead — or already
        purged by compaction — are ignored.  Legal after ``close()``.
        Returns the count of newly-dead rows.
        """
        if (pred is None) == (row_ids is None):
            raise ValueError("delete needs exactly one of pred= or row_ids=")
        now = self.clock() if now is None else float(now)
        deleted = 0
        # the whole delete holds _lock so it serializes against compaction's
        # late-replay + swap (also under _lock): a delete either lands fully
        # before the swap — its tombstones show up in the replay diff — or
        # starts after and sees the merged segment.  Unlocked, a delete that
        # read the old tuple could tombstone a retired segment after the
        # replay diff ran, and the rows would resurface in the merged
        # generation.  Queries only take _lock for their snapshot, so they
        # are never blocked for long.
        with self._lock:
            if row_ids is not None:
                ids = np.unique(np.asarray(row_ids, dtype=np.int64))
                for seg in self._segments:
                    deleted += seg.delete_ids(ids)
                start = self.sealed_rows
                local = ids[(ids >= start) & (ids < start + self._buffered)]
                deleted += self._mark_buffer_deleted(local - start)
                return deleted
            be = get_backend(backend)
            for seg in self._segments:
                if not seg.n_rows:
                    continue
                seg.fold_expired(now)
                plan = compile_plan(seg.index, pred, names=self.names)
                rows, _ = be.execute(plan)
                deleted += seg.delete_reordered(rows)
            if self._buffered:
                mask = evaluate_mask(pred, self.buffer_columns(),
                                     names=self.names)
                deleted += self._mark_buffer_deleted(np.flatnonzero(mask))
        return deleted

    def _mark_buffer_deleted(self, positions) -> int:  # holds-lock: _lock
        """Flip buffer-local positions dead; returns newly-dead count.
        Caller holds ``_lock``."""
        positions = np.asarray(positions, dtype=np.int64)
        if not len(positions):
            return 0
        newly = 0
        off = 0
        for dmask in self._chunk_deleted:
            n = len(dmask)
            sel = positions[(positions >= off) & (positions < off + n)] - off
            if len(sel):
                newly += int((~dmask[sel]).sum())
                dmask[sel] = True
            off += n
        return newly

    # -- seal --------------------------------------------------------------

    def seal(self) -> Segment | None:
        """Seal the word-aligned prefix of the open buffer into an
        immutable segment; the ``% 32`` tail rows stay buffered (they seal
        with the next segment, or with :meth:`close`).  Returns the new
        :class:`Segment`, or None when fewer than 32 rows are buffered."""
        # the whole seal holds _lock (reentrant with _seal_rows): computing
        # n_seal from an unlocked read lets two concurrent seals both claim
        # the same word-aligned prefix and drive _buffered negative
        with self._lock:
            if self._closed:
                raise ValueError("writer is closed")
            n_seal = (self._buffered // ewah.WORD_BITS) * ewah.WORD_BITS
            return self._seal_rows(n_seal) if n_seal else None

    def close(self) -> Segment | None:
        """Seal everything left in the buffer — the final segment may be
        non-word-aligned because nothing concatenates after it — and close
        the writer for appends.  Deletes and compaction remain legal.
        Returns the final segment (None if nothing buffered)."""
        with self._lock:
            if self._closed:
                raise ValueError("writer is already closed")
            seg = self._seal_rows(self._buffered) if self._buffered else None
            self._closed = True
            return seg

    def _seal_rows(self, n_seal: int) -> Segment:
        with self._lock:
            cols = [np.concatenate([chunk[c] for chunk in self._chunks])
                    for c in range(self._n_cols)]
            deleted = np.concatenate(self._chunk_deleted)
            expiry = np.concatenate(self._chunk_expiry)
            head = [c[:n_seal] for c in cols]
            # an all-deleted buffer still seals physically: the rows are
            # born tombstoned and the next compaction purges them
            seg = Segment.seal(
                head, self.spec, row_start=self.sealed_rows,
                materialize=self.materialize, expiry=expiry[:n_seal],
                tombstone_rows=np.flatnonzero(deleted[:n_seal]))
            remaining = self._buffered - n_seal
            self._segments = self._segments + (seg,)
            self._chunks = [[c[n_seal:] for c in cols]] if remaining else []
            self._chunk_deleted = [deleted[n_seal:]] if remaining else []
            self._chunk_expiry = [expiry[n_seal:]] if remaining else []
            self._buffered = remaining
        return seg

    # -- compaction --------------------------------------------------------

    def compact(self, span: tuple | None = None, *, fanout: int = 4,
                ratio: float = 4.0, now=None) -> Segment | None:
        """Merge a run of adjacent segments into one re-sorted segment,
        purging tombstoned/expired rows.

        ``span=(i, j)`` compacts ``segments[i:j]`` explicitly; without it
        the size-tiered policy (:func:`size_tiered_pick`) picks the first
        run of >= ``fanout`` adjacent segments whose compressed sizes are
        within ``ratio`` of each other (LSM size tiering, restricted to
        adjacent runs because segments must stay contiguous).

        Safe to run from a background thread while queries and appends
        continue: the heavy merge runs off-lock against an immutable
        snapshot, the swap is a single copy-on-write tuple replacement
        (readers see old or new, never a mix), deletes that landed on the
        retired segments during the merge are replayed onto the merged
        segment before it becomes visible, and retired segments' result-
        cache entries are evicted by generation scope — untouched segments
        keep theirs.  Returns the merged segment, or None when no run
        qualifies.
        """
        now = self.clock() if now is None else float(now)
        with self._compact_lock:
            snapshot = self._segments  # analysis-ok: lock/unguarded-read intentional off-_lock snapshot; the swap below re-locates under _lock
            if span is None:
                span = size_tiered_pick(snapshot, fanout=fanout, ratio=ratio)
                if span is None:
                    return None
            i, j = span
            if not 0 <= i < j <= len(snapshot) or j - i < 2:
                raise ValueError(f"compaction span {span} must cover >= 2 "
                                 f"segments of {len(snapshot)}")
            retired = snapshot[i:j]
            # dead-set snapshot: deletes racing the off-lock merge are
            # found by diffing against this and replayed onto the merged
            # segment before the swap publishes it
            pre_dead = [frozenset(s.dead_ids(now).tolist()) for s in retired]
            chooser = None
            if self.workload_stats is not None:
                from ..workload import make_compaction_chooser
                chooser = make_compaction_chooser(self.workload_stats)
            merged = compact(retired, self.spec,
                             materialize=self.materialize, now=now,
                             encoding_chooser=chooser)
            with self._lock:
                cur = self._segments
                # seals only append and compactions are single-file, so the
                # retired run still sits at one spot — locate by identity
                k = next(idx for idx in range(len(cur))
                         if cur[idx] is retired[0])
                late = set()
                now2 = self.clock()
                for s, pre in zip(retired, pre_dead):
                    late.update(set(s.dead_ids(now2).tolist()) - pre)
                if late:
                    merged.delete_ids(np.fromiter(late, dtype=np.int64))
                self._segments = cur[:k] + (merged,) + cur[k + len(retired):]
        for seg in retired:
            invalidate_scope(seg.cache_scope)
        return merged


def compact(segments, spec: IndexSpec | None = None, *,
            materialize: bool = True, now=None,
            encoding_chooser=None) -> Segment:
    """Merge adjacent sealed segments into one re-sorted segment, dropping
    tombstoned rows (and rows expired at ``now``).

    ``encoding_chooser(original_col, hist, k) -> kind | None`` overrides
    the spec's per-column encoding choice for the merged segment — the
    workload-driven re-encoding hook
    (:func:`repro_torch.workload.make_compaction_chooser`); None keeps the
    spec's static chooser for that column.

    Surviving rows concatenate in original ingest order and the full
    pipeline (histogram refresh over the merged distribution, reordering,
    row sort) re-runs across the whole range — the merged segment
    compresses like a monolithic build over those rows, and its ``row_ids``
    keep their global ingest ids so ids stay stable across purges.  Up to
    31 dead rows are retained as *fillers* — still tombstoned, purged by
    the next compaction — whenever that keeps the merged physical row count
    word-aligned (always possible when the retired span was aligned).  A
    fully-dead span returns a valid zero-row segment covering the same id
    span.  Segments must cover contiguous id spans (the writer's
    invariant); violations raise ValueError.
    """
    segments = list(segments)
    if len(segments) < 2:
        raise ValueError("compact needs at least 2 segments")
    for a, b in zip(segments, segments[1:]):
        if a.row_stop != b.row_start:
            raise ValueError(
                f"segments are not adjacent: [{a.row_start}, {a.row_stop}) "
                f"then [{b.row_start}, {b.row_stop})")
    live_segs = [s for s in segments if s.n_rows]
    if any(s.columns is None for s in live_segs):
        raise ValueError(
            "cannot compact segments sealed with keep_columns=False: their "
            "row store was dropped (dist fan-out shards are never compacted)")
    row_start = segments[0].row_start
    span_stop = segments[-1].row_stop
    if not live_segs:
        return Segment.empty(row_start, span_stop)
    n_cols = len(live_segs[0].columns)
    if any(len(s.columns) != n_cols for s in live_segs):
        raise ValueError("segments disagree on column count")
    cat_cols = [np.concatenate([s.columns[c] for s in live_segs])
                for c in range(n_cols)]
    cat_ids = np.concatenate([s.ingest_ids() for s in live_segs])
    cat_exp = np.concatenate(
        [s.expiry if s.expiry is not None
         else np.full(s.n_rows, np.inf) for s in live_segs])
    keep = ~np.concatenate([s.dead_ingest_mask(now) for s in live_segs])
    # retain dead fillers to keep the merged segment word-aligned (mid-
    # sequence segments must stay %32); if the span is too dead-poor to
    # reach alignment it must be the unaligned final segment — leave it
    need = int(-keep.sum() % ewah.WORD_BITS)
    dead_pos = np.flatnonzero(~keep)
    fillers = dead_pos[:need] if need and len(dead_pos) >= need \
        else dead_pos[:0]
    keep[fillers] = True
    kept = np.flatnonzero(keep)
    if not len(kept):
        return Segment.empty(row_start, span_stop)
    return Segment.seal(
        [c[kept] for c in cat_cols], spec, row_start=row_start,
        span_stop=span_stop, row_ids=cat_ids[kept], expiry=cat_exp[kept],
        tombstone_rows=np.searchsorted(kept, fillers),
        materialize=materialize, encoding_chooser=encoding_chooser)


class BackgroundCompactor:
    """Scheduler thread running :func:`size_tiered_pick` compaction off the
    serving path.

    Every ``interval`` seconds it asks the writer for one size-tiered
    compaction (``writer.compact()`` — snapshot, off-lock merge, atomic
    swap).  Transient failures back off exponentially (``backoff`` doubling
    up to ``max_backoff``) and are counted in ``stats`` rather than killing
    the thread; the next success resets the cadence.  ``close()`` drains
    gracefully: it stops the scheduler, joins (an in-flight compaction
    finishes — the swap is never torn), then runs remaining qualifying
    tiers to quiescence.

    Usable as a context manager::

        with BackgroundCompactor(writer, interval=0.01):
            ...ingest/serve...
    """

    def __init__(self, writer: IndexWriter, *, interval: float = 0.05,
                 fanout: int = 4, ratio: float = 4.0,
                 backoff: float = 0.05, max_backoff: float = 2.0,
                 on_error=None):
        self.writer = writer
        self.interval = float(interval)
        self.fanout = fanout
        self.ratio = ratio
        self.backoff = float(backoff)
        self.max_backoff = float(max_backoff)
        self.on_error = on_error
        self._stats_lock = make_lock("compactor._stats_lock",
                                     reentrant=False)
        self._stats = {"cycles": 0,            # guarded-by: _stats_lock
                       "compactions": 0, "failures": 0}
        self._stop = threading.Event()
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="index-compactor", daemon=True)
        self._thread.start()

    @property
    def stats(self) -> dict:
        """Point-in-time counter snapshot (the scheduler thread keeps
        mutating the live dict; callers get a consistent copy)."""
        with self._stats_lock:
            return dict(self._stats)

    def _bump(self, key: str) -> None:
        with self._stats_lock:
            self._stats[key] += 1

    def _run(self) -> None:
        delay = self.interval
        while not self._stop.wait(delay):
            self._bump("cycles")
            try:
                merged = self.writer.compact(fanout=self.fanout,
                                             ratio=self.ratio)
            except Exception as exc:  # transient: back off, keep serving
                self._bump("failures")
                if self.on_error is not None:
                    self.on_error(exc)
                delay = min(max(delay * 2, self.backoff), self.max_backoff)
                continue
            if merged is not None:
                self._bump("compactions")
            delay = self.interval

    @property
    def running(self) -> bool:
        return self._thread.is_alive()

    def close(self, drain: bool = True) -> None:
        """Stop the scheduler and join; with ``drain`` (default) finish any
        still-qualifying tiers so the writer closes quiescent.  Idempotent."""
        if self._closed:
            return
        self._stop.set()
        self._thread.join()
        self._closed = True
        if not drain:
            return
        while True:
            try:
                merged = self.writer.compact(fanout=self.fanout,
                                             ratio=self.ratio)
            except Exception as exc:
                self._bump("failures")
                if self.on_error is not None:
                    self.on_error(exc)
                return
            if merged is None:
                return
            self._bump("compactions")

    def __enter__(self) -> "BackgroundCompactor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def size_tiered_pick(segments, fanout: int = 4, ratio: float = 4.0):
    """First run of >= ``fanout`` adjacent segments whose compressed sizes
    are within ``ratio`` of each other; returns ``(i, j)`` or None.

    Classic size tiering buckets segments by size wherever they live; here
    runs must be *adjacent* (segments stay contiguous row ranges), so the
    policy slides a window and fires on the first size-homogeneous run.
    """
    if fanout < 2:
        raise ValueError(f"fanout must be >= 2, got {fanout}")
    sizes = [max(s.size_words(), 1) for s in segments]
    for i in range(len(sizes) - fanout + 1):
        window = sizes[i : i + fanout]
        if max(window) <= ratio * min(window):
            j = i + fanout
            # greedily extend the tier while sizes stay homogeneous
            while j < len(sizes) and \
                    max(max(sizes[i:j + 1]), 1) <= ratio * min(sizes[i:j + 1]):
                j += 1
            return (i, j)
    return None
