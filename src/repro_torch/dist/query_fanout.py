"""Query fan-out across row-range shards of a bitmap index.

Sharding-for-serving counterpart of the placement/checkpoint modules — and,
since the segmented-lifecycle redesign, a **thin view over segments**: a
shard IS a :class:`~repro_torch.core.segment.Segment` (word-aligned
contiguous row range + locally-sorted index + generation), and
:class:`ShardedIndex` delegates execution to
:class:`~repro_torch.core.segment.SegmentedIndex`.  What this module adds
is the *placement* policy (``shard_ranges``: split a table into up to N
equal word-aligned ranges) and the fan-out framing:

  1. the predicate compiles *per shard* against that shard's index (value
     domains are shard-local: a value a shard never saw compiles to a
     constant-empty leaf, and ``Not`` complements only the shard's row
     range); the spec's per-column *encoding* choice travels with the spec
     too — under ``encoding='auto'`` each shard's chooser reads its own
     histograms, so shards of one fan-out may answer the same ``Range``
     through different encodings and still merge bit-identically (only
     result streams cross the wire, never slice planes or bins);
  2. every shard executes the plan through ``execute_compressed`` — the
     result that crosses the (logical) wire is the compressed EWAH stream,
     not row ids, typically orders of magnitude smaller;
  3. the coordinator merges by **concatenation with clean-run coalescing**
     (:func:`~repro_torch.core.ewah_stream.concat_streams`): a clean run
     ending one shard and opening the next collapses into a single marker,
     so the merged stream is exactly what a single-shard execution over the
     concatenated row space would produce.

Shards are independent — the per-shard step parallelizes across processes
or hosts without coordination.  This module keeps the execution loop local
and owns the **placement policy** shared with the cross-process serve
plane (:mod:`repro_torch.dist.serve_plane`): :func:`shard_ranges` splits a
row space into word-aligned ranges, and :func:`assign_segments` maps sealed
segments onto host ranks by carving the *cumulative compressed word
space* with the same word-aligned splitter — so ownership rebalances
whenever compaction changes the segment list, as the reference's
`docs/dist.md` specifies for a multi-host deployment.

Query and delete entry points default to ``backend="torch"``, the CUDA
card, like the port's ``SegmentedIndex``; ``device="cpu"`` (a backend
option) runs the kernels' plain versions on the host.

Row-id semantics: fan-out queries return **original** table row positions
(each shard's local ids map through its ``row_perm`` and row offset) —
the same contract as every segmented surface; ``BitmapIndex.query`` ids
live in reordered space (map with ``index.row_perm``).
"""

from __future__ import annotations

from ..core.ewah import WORD_BITS
from ..core.segment import Segment, SegmentedIndex

# a shard is a segment; the old name stays importable
IndexShard = Segment


def assign_segments(segments, n_hosts: int) -> list:
    """Ownership map for the serve plane: one owner rank per segment.

    Carves the *cumulative compressed word space* (each segment weighted
    by its ``size_words``, floor 1 so zero-cost segments still land
    somewhere) into up to ``n_hosts`` contiguous ranges using the same
    word-aligned splitter queries shard rows with, then homes each
    segment on the range containing its midpoint.  Contiguity means a
    host owns a contiguous run of segments — compaction spans and
    ownership spans nest — and recomputing after a compaction re-homes
    only segments near the changed run.
    """
    if n_hosts < 1:
        raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
    sizes = [max(s.size_words(), 1) for s in segments]
    if not sizes:
        return []
    ranges = shard_ranges(sum(sizes) * WORD_BITS, n_hosts)
    starts = [start for start, _ in ranges]
    owners, pos = [], 0
    for words in sizes:
        mid = (pos + words / 2.0) * WORD_BITS
        rank = len(starts) - 1
        while rank > 0 and starts[rank] > mid:
            rank -= 1
        owners.append(rank)
        pos += words
    # densify: ranks number 0..k-1 in first-appearance order, so a tiny
    # fleet-of-one workload homes on rank 0, not wherever the word-aligned
    # splitter happened to drop its midpoint
    remap: dict = {}
    return [remap.setdefault(r, len(remap)) for r in owners]


def shard_ranges(n_rows: int, n_shards: int) -> list:
    """Split ``n_rows`` into up to ``n_shards`` contiguous [start, stop)
    ranges with every internal boundary word-aligned (multiple of 32 rows).
    Ranges cover the table exactly; empty ranges are dropped (tiny tables
    yield fewer shards than requested)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    words = (n_rows + WORD_BITS - 1) // WORD_BITS
    bounds = [min((words * i // n_shards) * WORD_BITS, n_rows)
              for i in range(n_shards)] + [n_rows]
    return [(bounds[i], bounds[i + 1]) for i in range(n_shards)
            if bounds[i + 1] > bounds[i]]


class ShardedIndex:
    """A bitmap index fanned out over word-aligned row-range shards.

    A thin view: ``shards`` are :class:`~repro_torch.core.segment.Segment`s
    and every execution method delegates to the shared
    :class:`~repro_torch.core.segment.SegmentedIndex` engine.
    """

    def __init__(self, shards: list, names=None, clock=None):
        if not shards:
            raise ValueError("ShardedIndex needs at least one shard")
        self.shards = shards
        self.names = names
        self._segmented = SegmentedIndex(shards, names=names, clock=clock)

    @staticmethod
    def build(table_cols, spec=None, n_shards: int = 4, names=None,
              row_ids=None, expiry=None, clock=None) -> "ShardedIndex":
        """Seal one :class:`Segment` per word-aligned row range.

        Each shard sorts its own rows (the paper's reordering applies per
        shard — sorted runs never span shard boundaries, which is also what
        keeps shard builds embarrassingly parallel).

        ``row_ids`` (ascending global ingest ids, one per row) builds the
        fan-out over a *purged* row set — rows dropped by deletes/TTLs
        before the fan-out was built keep every surviving id stable, and
        the shard id-spans stay contiguous around the gaps.  ``expiry``
        carries per-row absolute TTL deadlines into the shards (expired
        rows fold into shard tombstones lazily at query time); pass the
        ``clock`` those deadlines were issued against (e.g. the feeding
        writer's) so lazy expiry evaluates "now" consistently."""
        import numpy as np

        table_cols = [np.asarray(c) for c in table_cols]
        n_rows = len(table_cols[0])
        ranges = shard_ranges(n_rows, n_shards)
        if row_ids is not None:
            row_ids = np.asarray(row_ids, dtype=np.int64)
            # span boundaries sit on the first id of each shard, so spans
            # tile [first_id, last_id + 1) contiguously around purge gaps
            bounds = [int(row_ids[start]) for start, _ in ranges]
            bounds.append(int(row_ids[-1]) + 1 if len(row_ids) else 0)
        else:
            bounds = [start for start, _ in ranges]
            bounds.append(ranges[-1][1] if ranges else 0)
        shards = [
            # shards are never compacted: drop the raw-column row store
            Segment.seal(
                [c[start:stop] for c in table_cols], spec,
                row_start=bounds[i], span_stop=bounds[i + 1],
                keep_columns=False,
                row_ids=None if row_ids is None else row_ids[start:stop],
                expiry=None if expiry is None else expiry[start:stop])
            for i, (start, stop) in enumerate(ranges)
        ]
        return ShardedIndex(shards, names=names, clock=clock)

    @property
    def n_rows(self) -> int:
        return self.shards[-1].row_stop

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def size_words(self) -> int:
        return self._segmented.size_words()

    # -- deletes -----------------------------------------------------------

    def delete(self, pred=None, *, row_ids=None, backend: str = "torch",
               now=None) -> int:
        """Tombstone rows across the fan-out (delegated to the segmented
        engine): each shard ORs its share of the delete into its compressed
        tombstone bitmap and recomputes its live mask; every later fan-out
        query ANDs that mask into the shard's plan root — one extra merge
        per shard, no rebuild, and only result streams still cross the
        wire.  Returns the newly-dead row count."""
        return self._segmented.delete(pred, row_ids=row_ids,
                                      backend=backend, names=self.names,
                                      now=now)

    # -- execution (delegated to the segmented engine) ---------------------

    def execute_compressed(self, pred, backend: str = "torch", names=None,
                           **backend_opts):
        """Fan the predicate out; returns (shard_results, merged).

        ``shard_results`` is the per-shard list of
        :class:`~repro_torch.core.ewah_stream.EwahStream` (what each shard
        ships); ``merged`` is their concatenation with clean-run
        coalescing — one compressed stream over the full row space,
        bit-identical to a single-index execution over the same (per-shard
        reordered) rows.
        """
        return self._segmented.execute_compressed(
            pred, backend=backend, names=names, **backend_opts)

    def execute_compressed_many(self, preds, backend: str = "torch",
                                names=None, **backend_opts):
        """Batched fan-out: all predicates' per-shard plans go to the
        backend in **one** ``execute_compressed_many`` call, so the torch
        backend's same-shape grouping batches across predicates *and*
        shards (one padded dispatch per plan shape, not one per
        predicate x shard).  Returns a (shard_results, merged) pair per
        predicate."""
        return self._segmented.execute_compressed_many(
            preds, backend=backend, names=names, **backend_opts)

    def query(self, pred, backend: str = "torch", names=None,
              **backend_opts):
        """Fan-out query; returns (row_ids, words_scanned) with row ids in
        **original** table row space, sorted ascending."""
        return self._segmented.query(pred, backend=backend, names=names,
                                     **backend_opts)

    def query_many(self, preds, backend: str = "torch", names=None,
                   **backend_opts):
        """Batched fan-out queries; one (row_ids, words_scanned) per
        predicate, row ids in original table row space."""
        return self._segmented.query_many(preds, backend=backend,
                                          names=names, **backend_opts)
