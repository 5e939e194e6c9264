"""EWAH bitmap index over training-data metadata — the paper's original use
case, hosted in the training data plane.

A copy of the reference's ``repro.data.metadata_index`` over this
package's engines.  Every training sequence carries categorical metadata
(source, domain, quality bin, length bin).  A data-mixing / curation query
like ``domain = 3 AND quality_bin >= 8`` is exactly the paper's predicate
workload; the index is built with histogram-aware column ordering and
Gray-Frequency row sorting (the paper's best heuristics) and queried
through the predicate planner (repro_torch.core.query), on the torch
backend (the card; the default) or the numpy streaming backend.

Ingestion is **incremental** (repro_torch.core.lifecycle): every
``add_batch`` appends to an :class:`~repro_torch.core.lifecycle.IndexWriter`
and seals the word-aligned prefix into an immutable segment — no
monolithic rebuild per batch.  Queries run through the live
:class:`~repro_torch.core.segment.SegmentedIndex` view (sealed segments
through the compressed engine, the open tail densely) and return row ids
in **original ingest order**.  The index is a full LSM surface:
``delete`` tombstones rows, ``add_batch(..., ttl=)`` expires rows lazily,
and ``compact()`` — or the
:class:`~repro_torch.core.lifecycle.BackgroundCompactor` behind
``start_compactor()`` — purges dead rows off the serving path while
re-sorting with the histogram-aware pipeline.

With ``query_fanout > 1`` the index instead shards over word-aligned row
ranges (``repro_torch.dist.query_fanout``) and every query fans out, each
shard executing in the compressed domain and shipping its compressed
result stream; fan-out row ids are original ingest positions too, so the
two modes answer identically.

With ``hosts >= 2`` queries serve through a multi-process
:class:`~repro_torch.dist.serve_plane.ServePlane` instead: each worker
process owns a word-aligned run of sealed segments (re-homed after
compaction), executes on the card, and ships only compressed result
streams back to the coordinator, which stitches them into the same
original-ingest-order answers; ``plane_opts`` (``connect_timeout``,
``reply_timeout``) go to that plane.

``delete``, ``query_pred`` and ``query`` default to ``backend="torch"``
(the reference's default is ``"numpy"``): the port answers on the card.
Query options (``device="cpu"`` runs the kernels' plain versions on the
host) pass through to the backend in every topology, the plane's
workers included; ``delete`` takes a backend name only, so on the host
it needs ``backend="numpy"``.
"""

from __future__ import annotations

import inspect

import numpy as np

from ..core import And, Eq, IndexSpec, IndexWriter
from ..core.lifecycle import BackgroundCompactor
from ..core.query import BACKENDS


def _check_backend_opts(backend: str, backend_opts: dict) -> None:
    """Raise ``TypeError`` for an option the backend's constructor does not
    take.  The constructor is read, not called: the torch backend's
    resolves its device, which raises where there is no card."""
    cls = BACKENDS.get(backend)
    if cls is None:
        return  # the query itself names the registered backends
    params = inspect.signature(cls).parameters
    if any(p.kind is p.VAR_KEYWORD for p in params.values()):
        return
    for key in backend_opts:
        if key not in params:
            raise TypeError(
                f"query() got an unexpected keyword argument {key!r}: "
                f"the {backend!r} backend takes {sorted(params)}; "
                "conditions go in where={column: value}")


class MetadataIndex:
    COLS = ("source", "domain", "quality_bin", "length_bin")

    def __init__(self, k: int = 1, row_order: str = "grayfreq",
                 spec: IndexSpec | None = None, query_fanout: int = 0,
                 encoding: str = "equality", hosts: int = 0,
                 plane_opts: dict | None = None):
        self.spec = spec or IndexSpec(k=k, row_order=row_order,
                                      column_order="heuristic",
                                      encoding=encoding)
        if hosts >= 2 and query_fanout > 1:
            raise ValueError(
                "hosts and query_fanout are separate serving topologies "
                "(multi-process plane vs in-process shard view); pick one")
        self.k = self.spec.k
        self.row_order = self.spec.row_order
        self.query_fanout = query_fanout
        self.hosts = hosts
        # ServePlane options in hosts mode (connect_timeout, reply_timeout)
        self.plane_opts = dict(plane_opts or {})
        self.writer = IndexWriter(self.spec, names=self.COLS)
        self._sharded = None
        self._compactor = None
        self._plane = None

    def add_batch(self, meta: dict, ttl=None):
        """Append one metadata batch and seal its word-aligned prefix into
        an immutable segment (the ``len % 32`` tail rides in the open
        buffer and is still queryable).  ``ttl`` (seconds, scalar or
        per-row) expires the rows lazily — rolling freshness windows for
        curation data.  In fan-out mode rows only buffer — queries run
        through ``.sharded``, so per-batch segment indexes would be wasted
        work."""
        self.writer.append({c: np.asarray(meta[c]) for c in self.COLS},
                           ttl=ttl)
        if self.query_fanout <= 1:
            self.writer.seal()
        self._sharded = None

    def delete(self, where: dict | None = None, *, pred=None, row_ids=None,
               backend: str = "torch") -> int:
        """Tombstone rows by equality conditions (``where={column: value}``,
        compiled to one And(Eq, ...) plan), an arbitrary predicate, or
        global ingest ids.  Sealed segments absorb the delete as one
        compressed-domain merge; every later query ANDs the live mask in.
        Returns the newly-dead row count."""
        given = [x is not None for x in (where, pred, row_ids)]
        if sum(given) != 1:
            raise ValueError(
                "delete needs exactly one of where=, pred=, or row_ids=")
        if where is not None:
            unknown = sorted(set(where) - set(self.COLS))
            if unknown:
                raise ValueError(f"unknown columns {unknown}; known: "
                                 f"{', '.join(self.COLS)}")
            pred = And(*[Eq(col, int(v)) for col, v in where.items()])
        if self._plane is not None:
            # the plane broadcasts tombstones to segment-owning workers
            # (shipped segments keep their generation across a tombstone)
            n = self._plane.delete(pred, row_ids=row_ids, backend=backend)
        else:
            n = self.writer.delete(pred, row_ids=row_ids, backend=backend)
        self._sharded = None
        return n

    def compact(self, **kwargs):
        """Size-tiered compaction of accumulated small segments (see
        ``IndexWriter.compact``): merges re-sort with the histogram-aware
        pipeline, tombstoned/expired rows are physically purged, and
        retired segments' cached query results are evicted by generation
        scope."""
        merged = self.writer.compact(**kwargs)
        if merged is not None:
            self._sharded = None
        return merged

    def start_compactor(self, **kwargs) -> BackgroundCompactor:
        """Run the size-tiered policy on a scheduler thread
        (:class:`~repro_torch.core.lifecycle.BackgroundCompactor`): ingest
        never pauses for maintenance.  ``close()`` drains it."""
        if self._compactor is not None and self._compactor.running:
            raise ValueError("a background compactor is already running")
        self._compactor = BackgroundCompactor(self.writer, **kwargs)
        return self._compactor

    def close(self) -> None:
        """Drain and stop the background compactor, if one is running,
        and shut down the serve-plane worker fleet (hosts mode)."""
        if self._compactor is not None:
            self._compactor.close()
            self._compactor = None
        if self._plane is not None:
            self._plane.close()
            self._plane = None

    @property
    def n_rows(self) -> int:
        return self.writer.n_rows

    def _live_cols(self):
        """(columns, ids, expiry) of the currently-live rows, ingest order
        — what the fan-out view is (re)built from.  Ids are global ingest
        positions, so fan-out results stay comparable across deletes and
        purges; expiry travels so rows TTL-ing out after the build still
        vanish lazily."""
        now = self.writer.clock()
        segs, buf = self.writer.snapshot()
        col_parts, id_parts, exp_parts = [], [], []
        for s in segs:
            keep = ~s.dead_ingest_mask(now)
            col_parts.append([c[keep] for c in s.columns])
            id_parts.append(s.ingest_ids()[keep])
            exp_parts.append(
                (s.expiry if s.expiry is not None
                 else np.full(s.n_rows, np.inf))[keep])
        if buf is not None:
            bcols, bdel, bexp = buf
            keep = ~bdel & (bexp > now)
            start = segs[-1].row_stop if segs else 0
            col_parts.append([c[keep] for c in bcols])
            id_parts.append(start + np.flatnonzero(keep))
            exp_parts.append(bexp[keep])
        n_cols = len(self.COLS)
        cols = [np.concatenate([p[c] for p in col_parts])
                if col_parts else np.zeros(0, dtype=np.int64)
                for c in range(n_cols)]
        ids = (np.concatenate(id_parts) if id_parts
               else np.zeros(0, dtype=np.int64))
        exp = np.concatenate(exp_parts) if exp_parts else np.zeros(0)
        return cols, ids, exp

    @property
    def index(self):
        """The live :class:`~repro_torch.core.segment.SegmentedIndex` view
        (sealed segments + open buffer).  Row ids from queries are original
        ingest positions."""
        if self.query_fanout > 1:
            # a second full query surface would double memory and confuse
            # cache scoping; fan-out mode queries through .sharded
            raise ValueError(
                "MetadataIndex was built with query_fanout="
                f"{self.query_fanout}; use .sharded")
        return self.writer.index

    @property
    def plane(self):
        """The multi-process :class:`~repro_torch.dist.serve_plane.ServePlane`
        (``hosts >= 2`` mode), spawned lazily on first use so indexes that
        never query don't pay the worker-fleet startup."""
        if self.hosts < 2:
            raise ValueError(
                f"MetadataIndex was built with hosts={self.hosts}; the "
                "serve plane needs hosts >= 2")
        if self._plane is None:
            from ..dist.serve_plane import ServePlane

            self._plane = ServePlane(self.writer, n_hosts=self.hosts,
                                     **self.plane_opts)
        return self._plane

    @property
    def sharded(self):
        if self._sharded is None:
            from ..dist.query_fanout import ShardedIndex

            cols, ids, exp = self._live_cols()
            self._sharded = ShardedIndex.build(
                cols, self.spec, n_shards=self.query_fanout,
                names=self.COLS, row_ids=ids,
                expiry=exp if np.isfinite(exp).any() else None,
                clock=self.writer.clock)
        return self._sharded

    def query_pred(self, pred, backend: str = "torch", **backend_opts):
        """Run any predicate (columns by name, e.g. ``Eq("domain", 3)`` or
        ``In("quality_bin", range(8, 16))``) through the planner.
        Returns (row_ids, compressed_words_scanned); row ids are original
        ingest positions in all three serving modes (segmented, fan-out,
        multi-process plane); ``backend_opts`` go to the backend."""
        if self.hosts >= 2:
            return self.plane.query(pred, backend=backend, **backend_opts)
        if self.query_fanout > 1:
            return self.sharded.query(pred, backend=backend, names=self.COLS,
                                      **backend_opts)
        return self.index.query(pred, backend=backend, **backend_opts)

    def query(self, where: dict | None = None, *, backend: str = "torch",
              **backend_opts):
        """Equality query: rows matching all ``where={column: value}``
        conditions (compiled to one And(Eq, ...) plan — a single
        smallest-streams-first AND fan-in).  Returns
        (row_ids, compressed_words_scanned).

        ``backend`` and the backend's options are keyword-only;
        conditions travel in the explicit ``where=`` dict so column names
        can never collide with option names.  A keyword that the backend's
        constructor does not take (a condition passed bare, such as
        ``domain=2``, or ``_backend=``) raises ``TypeError``, with or
        without conditions.
        """
        _check_backend_opts(backend, backend_opts)
        if not where:
            return np.asarray([], dtype=np.int64), 0
        unknown = sorted(set(where) - set(self.COLS))
        if unknown:
            raise ValueError(
                f"unknown columns {unknown}; known: {', '.join(self.COLS)}")
        pred = And(*[Eq(col, int(v)) for col, v in where.items()])
        return self.query_pred(pred, backend=backend, **backend_opts)

    def size_words(self) -> int:
        if self.query_fanout > 1:
            return self.sharded.size_words()
        return self.writer.size_words()
