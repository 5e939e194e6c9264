"""Workload telemetry: bounded, thread-safe samples of the planner's
per-column predicate flow.

Every executed query batch contributes one sample per predicate event the
planner recorded on its plans (``Plan.workload``, fed by
``query.compile_plan``): ``(column, predicate shape, width, encoding,
merge count, us_per_query)``.  :class:`WorkloadStats` keeps a bounded
recency-weighted tail of these — the training set for
:class:`~repro_torch.workload.cost.CostModel`, which ranks candidate encodings
per column so compaction can re-encode toward the live query mix
(docs/containers.md, "Workload-driven re-encoding").

The buffer is bounded: past ``MAX_SAMPLES`` it keeps the newest half, so
memory stays fixed and the samples follow the live mix.  :meth:`save` writes
its newest 2,048 samples and :meth:`load` restores them
(``serve --workload-stats``); one lock guards every read and write.
"""

from __future__ import annotations

import json

from ..analysis.runtime import make_lock


class WorkloadStats:
    """Thread-safe bounded sample buffer of observed predicate costs.

    Samples are ``(column, shape, width, encoding, merges, us)`` tuples:
    ``column`` is the original table position, ``shape`` the predicate
    kind (``"eq"`` / ``"in"`` / ``"range"``), ``width`` its value-domain
    span, ``encoding`` the :class:`~repro_torch.core.encodings.ColumnEncoding`
    kind that compiled it, ``merges`` its :func:`~repro_torch.core.query.
    count_merges` cost, and ``us`` the observed wall time attributed to
    it.  Serving records from worker threads while the background
    compactor reads; ``_mutex`` covers both.
    """

    MAX_SAMPLES = 8192

    def __init__(self):
        self._mutex = make_lock("workload_stats")
        self._samples: list = []  # guarded-by: _mutex
        self.recorded = 0         # guarded-by: _mutex

    def record(self, column, shape, width, encoding, merges, us) -> None:
        sample = (int(column), str(shape), int(width), str(encoding),
                  int(merges), float(us))
        with self._mutex:
            self.recorded += 1
            self._samples.append(sample)
            if len(self._samples) > self.MAX_SAMPLES:
                # keep the newest half: bounded memory, recency-weighted —
                # the model should track the *live* mix, not history
                self._samples = self._samples[self.MAX_SAMPLES // 2:]

    def record_plans(self, plans, us_each) -> None:
        """Record one executed batch: each plan's wall time is attributed
        evenly across its ``Plan.workload`` predicate events."""
        for plan, us in zip(plans, us_each):
            events = getattr(plan, "workload", ())
            if not events:
                continue
            share = float(us) / len(events)
            for col, shape, width, enc_kind, merges in events:
                self.record(col, shape, width, enc_kind, merges, share)

    def samples(self) -> list:
        with self._mutex:
            return list(self._samples)

    def __len__(self) -> int:
        with self._mutex:
            return len(self._samples)

    def clear(self) -> None:
        with self._mutex:
            self._samples = []
            self.recorded = 0

    def stats(self) -> dict:
        with self._mutex:
            return {"recorded": self.recorded,
                    "samples": len(self._samples)}

    def snapshot(self) -> dict:
        """A JSON-serializable copy of the buffer — the cross-host wire
        payload.  Same shape as the :meth:`save` file so the two transports
        (disk and socket) share one format."""
        with self._mutex:
            return {"recorded": self.recorded,
                    "samples": [list(s) for s in self._samples]}

    def drain(self) -> dict:
        """Atomically :meth:`snapshot` and reset — what a serve-plane
        worker ships with each reply so every sample reaches the
        coordinator exactly once."""
        with self._mutex:
            snap = {"recorded": self.recorded,
                    "samples": [list(s) for s in self._samples]}
            self._samples = []
            self.recorded = 0
        return snap

    def merge_snapshot(self, snap: dict) -> int:
        """Fold one host's :meth:`snapshot`/:meth:`drain` payload into this
        buffer; returns the number of samples merged.  Bounding applies, so
        the buffer stays recency-weighted across hosts."""
        samples = [(int(c), str(sh), int(w), str(e), int(m), float(u))
                   for c, sh, w, e, m, u in snap.get("samples", [])]
        extra = int(snap.get("recorded", len(samples))) - len(samples)
        with self._mutex:
            self.recorded += max(0, extra)
        for s in samples:
            self.record(*s)
        return len(samples)

    def save(self, path) -> None:
        with self._mutex:
            payload = {"recorded": self.recorded,
                       "samples": [list(s) for s in self._samples[-2048:]]}
        with open(path, "w") as fh:
            json.dump(payload, fh)

    def load(self, path) -> bool:
        """Restore a persisted sample tail; returns False when the file is
        missing or unreadable — a cold start, not an error."""
        try:
            with open(path) as fh:
                payload = json.load(fh)
        except (OSError, ValueError):
            return False
        samples = [(int(c), str(sh), int(w), str(e), int(m), float(u))
                   for c, sh, w, e, m, u in payload.get("samples", [])]
        with self._mutex:
            self._samples = samples
            self.recorded = int(payload.get("recorded", len(samples)))
        return True


#: Process-wide recorder the query surfaces feed
#: (``BitmapIndex.query*`` / ``SegmentedIndex`` timing wrappers) and
#: ``serve --workload-stats`` persists.
WORKLOAD_STATS = WorkloadStats()


def merge_snapshots(snaps, stats: WorkloadStats | None = None) -> WorkloadStats:
    """Merge per-host :meth:`WorkloadStats.snapshot` payloads into one
    recorder (default: the process-wide :data:`WORKLOAD_STATS`).

    The serve-plane coordinator calls this with every worker reply, so the
    compaction cost model (:func:`repro_torch.workload.cost.make_compaction_chooser`)
    ranks candidate encodings on the *global* query mix rather than any one
    host's slice.  Returns the target recorder.
    """
    target = stats if stats is not None else WORKLOAD_STATS
    for snap in snaps:
        if snap:
            target.merge_snapshot(snap)
    return target


def record_execution(plans, seconds, stats: WorkloadStats | None = None) -> None:
    """Attribute one executed batch's wall clock to its plans' predicate
    events, in microseconds per plan (the ``us_per_query`` the cost model
    fits against)."""
    if not plans:
        return
    us = float(seconds) * 1e6 / len(plans)
    (stats if stats is not None else WORKLOAD_STATS).record_plans(
        plans, [us] * len(plans))
