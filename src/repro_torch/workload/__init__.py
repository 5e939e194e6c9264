"""Workload telemetry + cost-model subsystem: the self-tuning loop.

The planner records per-column predicate events (``query.compile_plan``
-> ``Plan.workload``), the query surfaces time executed batches into
:data:`WORKLOAD_STATS` (:func:`record_execution`), :class:`CostModel`
fits per-encoding costs from those samples, and ``compact()`` /
``BackgroundCompactor`` consult :func:`make_compaction_chooser` to
re-encode merged segments toward the cheapest representation for the
observed mix.  Persisted across restarts by ``serve --workload-stats``.
See docs/containers.md.
"""

from .cost import (CANDIDATES, CostModel, column_mixes, estimate_merges,
                   make_compaction_chooser)
from .stats import (WORKLOAD_STATS, WorkloadStats, merge_snapshots,
                    record_execution)

__all__ = [
    "CANDIDATES",
    "CostModel",
    "WORKLOAD_STATS",
    "WorkloadStats",
    "column_mixes",
    "estimate_merges",
    "make_compaction_chooser",
    "merge_snapshots",
    "record_execution",
]
