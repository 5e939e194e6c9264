"""Predicate algebra, query planner, and pluggable execution backends.

The one query path from predicate to row ids::

    Eq / In / Range / And / Or / Not          (algebra, column = original id)
        -> compile_plan(index, pred)          (cost-ordered EWAH op tree)
        -> get_backend("numpy" | "torch")     (execution strategy)
        -> (row_ids, words_scanned)

Planner.  A predicate compiles against a materialized ``BitmapIndex`` into a
tree over *leaf* EWAH streams: ``Eq`` on a k-of-N column is an AND fan-in of
its k bitmaps, ``In``/``Range`` are OR fan-ins of those, and nested same-op
nodes are flattened, so ``And(Eq, Eq)`` at k=2 becomes a single 4-stream AND
fan-in.  Fan-in children are ordered smallest-estimated-size-first (leaf cost
= compressed stream length), the paper's smallest-streams-first fold.

Backends (pluggable via :func:`register_backend`):

* ``numpy`` — compressed-domain streaming merges (``ewah_stream``
  cursor/appender engine), never decompressing intermediates;
  ``words_scanned`` counts compressed words the cursors actually visited
  (the paper's machine-independent cost).
* ``torch`` — batched device execution on a CUDA card: leaf streams are
  padded to a capacity bucket, decoded by the ``ewah_decode`` kernel, and
  the whole plan runs in one ``planfuse`` kernel launch (or per stage
  through the ``wordops`` / ``slicefold`` / ``recompress`` kernels), many
  queries per dispatch.  ``words_scanned`` is the total compressed leaf
  words read.

Each backend exposes two result surfaces:

* ``execute(plan) -> (row_ids, words_scanned)`` — the row-id path;
* ``execute_compressed(plan) -> EwahStream`` — compressed in, compressed
  out: the result stays an EWAH stream (``Not`` by marker-type flipping on
  numpy, on-device recompression on torch), backed by an LRU result cache keyed by the canonical
  plan root with content-digested leaves, so cascaded / overlapping
  predicates reuse sub-plan results.

This module is a copy of the reference package's planner
(``repro.core.query``) with its JAX backend replaced by ``TorchBackend``.
Backends agree bit-for-bit with each other and with the reference's
backends; tests assert it (tests/test_torch_query.py).
"""

from __future__ import annotations

import hashlib
import json
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from . import ewah, ewah_stream
from .ewah_stream import EwahStream
from ..analysis.runtime import make_lock, maybe_validate

# ---------------------------------------------------------------------------
# Predicate algebra
# ---------------------------------------------------------------------------


class Predicate:
    """Base class; supports ``&``, ``|``, ``~`` sugar."""

    __slots__ = ()

    def __and__(self, other):
        return And(self, other)

    def __or__(self, other):
        return Or(self, other)

    def __invert__(self):
        return Not(self)


class Eq(Predicate):
    """column == value.  ``col`` is the *original* table column (int
    position or, when the index carries names, a column name)."""

    __slots__ = ("col", "value")

    def __init__(self, col, value):
        self.col = col
        self.value = int(value)

    def __repr__(self):
        return f"Eq({self.col!r}, {self.value})"


class In(Predicate):
    """column in values (OR of equalities)."""

    __slots__ = ("col", "values")

    def __init__(self, col, values):
        self.col = col
        self.values = tuple(int(v) for v in values)

    def __repr__(self):
        return f"In({self.col!r}, {self.values})"


class Range(Predicate):
    """lo <= column <= hi over dense value ids (both ends inclusive)."""

    __slots__ = ("col", "lo", "hi")

    def __init__(self, col, lo, hi):
        self.col = col
        self.lo = int(lo)
        self.hi = int(hi)

    def __repr__(self):
        return f"Range({self.col!r}, {self.lo}, {self.hi})"


class And(Predicate):
    __slots__ = ("children",)

    def __init__(self, *children):
        if not children:
            raise ValueError("And() needs at least one child predicate")
        self.children = tuple(children)

    def __repr__(self):
        return f"And{self.children!r}"


class Or(Predicate):
    __slots__ = ("children",)

    def __init__(self, *children):
        if not children:
            raise ValueError("Or() needs at least one child predicate")
        self.children = tuple(children)

    def __repr__(self):
        return f"Or{self.children!r}"


class Not(Predicate):
    __slots__ = ("child",)

    def __init__(self, child):
        self.child = child

    def __repr__(self):
        return f"Not({self.child!r})"


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------
#
# Node encodings (nested tuples, hashable for jit caching):
#   ("leaf", i)                 -> plan.streams[i]
#   ("not", child)              -> complement (XOR with all-ones)
#   ("and"|"or", (children...)) -> fan-in, children cost-ordered
#   ("fold", ops, (children...))-> sequential left fold with a per-step op
#                                  (ops[i] combines the running result with
#                                  children[i + 1]); child order is
#                                  SEMANTIC — the bit-sliced comparison
#                                  circuit — so it is never cost-reordered
#   ("cfold", ops, (cids...), est) -> left fold over plan.containers[cid]
#                                  Roaring container sets (core/containers);
#                                  est is the estimated compressed word cost.
#                                  Backends replace every cfold with a
#                                  canonical-EWAH leaf via lower_containers()
#                                  BEFORE stream evaluation, so caches,
#                                  tombstone ANDs, fan-out, and sanitizers
#                                  only ever see leaf streams

# The closed set of plan-node kinds.  Every backend must dispatch on all
# of these (repro.analysis enforces it: `backend/missing-kind`), and any
# new kind constructed below must be added here (`backend/undeclared-kind`)
# *and* handled by every backend before it ships.
PLAN_NODE_KINDS = ("leaf", "not", "and", "or", "fold", "cfold")


@dataclass
class Plan:
    """A compiled, cost-ordered op tree over leaf EWAH streams.

    ``scope`` tags every result this plan lands in a backend cache with the
    source index's ``cache_scope`` (segments set ``("segment", generation)``)
    so :func:`invalidate_scope` can evict exactly one retired segment's
    entries; None means unscoped (only content-digest staleness protection).
    """

    streams: list
    root: tuple
    n_rows: int
    scope: tuple | None = None
    # Roaring container sets referenced by ("cfold", ...) nodes; None once
    # lower_containers() has rewritten every cfold into a leaf stream.
    containers: list | None = None
    # per-predicate telemetry events (column, shape, width, encoding,
    # merges) — what WorkloadStats aggregates into cost-model samples
    workload: tuple = ()

    @property
    def n_words(self) -> int:
        return (self.n_rows + ewah.WORD_BITS - 1) // ewah.WORD_BITS

    def leaf_words(self) -> int:
        """Total compressed words across leaves (the torch-backend scan cost)."""
        return int(sum(len(s) for s in self.streams))

    def signature(self) -> tuple:
        """Structural shape (ops + leaf placeholders).  ``compile_plan``
        renumbers leaves in tree-traversal order, so two compiled plans with
        equal signatures have *identical* roots and can batch into one padded
        device dispatch."""
        return _sig(self.root)


def _sig(node):
    kind = node[0]
    if kind == "leaf":
        return ("L",)
    if kind == "not":
        return ("not", _sig(node[1]))
    if kind == "fold":
        return ("fold", node[1], tuple(_sig(c) for c in node[2]))
    if kind == "cfold":
        # container ids are per-plan positions (like leaf numbering), so
        # the structural shape is the op list + fan-in width
        return ("cfold", node[1], len(node[2]))
    return (kind, tuple(_sig(c) for c in node[1]))


def count_merges(node) -> int:
    """Binary stream merges (including ``not`` marker flips) a plan node
    executes — the machine-independent cost the encoding benchmarks and
    the bit-sliced merge-bound acceptance tests gate on.  Walks every node
    kind, so it is the one place to extend when a new kind lands."""
    kind = node[0]
    if kind == "leaf":
        return 0
    if kind == "not":
        return 1 + count_merges(node[1])
    if kind == "fold":
        return len(node[2]) - 1 + sum(count_merges(c) for c in node[2])
    if kind == "cfold":
        # container-wise merges inside the fold, plus nothing per leaf —
        # the lowered EWAH bridge is accounted as part of the fold
        return max(len(node[2]) - 1, 0)
    if kind not in ("and", "or"):
        raise ValueError(f"unknown plan-node kind {kind!r}")
    return len(node[1]) - 1 + sum(count_merges(c) for c in node[1])


# Instruction-tape opcodes, mirrored from kernels/planfuse.py (kept as
# plain ints here so the numpy-only import path never pulls torch;
# tests/test_torch_kernels.py asserts the two definitions agree).
TAPE_PUSH, TAPE_NOT, TAPE_OP = 0, 1, 2
_TAPE_OP_IDS = {"and": 0, "or": 1, "xor": 2}


def lower_plan(root) -> tuple:
    """Linearize a plan op tree into the static stack-machine tape the
    planfuse CUDA kernel interprets (kernels/planfuse.py); returns
    ``(tape, max_depth)``.

    Instructions are ``(opcode, arg)`` int pairs: ``(TAPE_PUSH, i)``
    pushes leaf plane ``i`` onto the operand stack, ``(TAPE_NOT, 0)``
    complements the top of stack, and ``(TAPE_OP, k)`` pops two operands
    and pushes their combination (k: 0=and, 1=or, 2=xor).  Fan-ins lower
    to left folds and ``fold`` children keep their semantic bit order, so
    the tape visits leaves exactly in the planner's canonical
    tree-traversal numbering and evaluates to the same result as the
    per-stage recursion.  ``max_depth`` is the operand stack's peak — the
    kernel's per-thread stack high-water mark, which the fused-path gate
    checks (``planfuse.fits``).
    """
    tape: list = []

    def rec(node):
        kind = node[0]
        if kind == "leaf":
            tape.append((TAPE_PUSH, node[1]))
            return
        if kind == "not":
            rec(node[1])
            tape.append((TAPE_NOT, 0))
            return
        if kind == "fold":
            _, fops, children = node
            rec(children[0])
            for op, child in zip(fops, children[1:]):
                rec(child)
                tape.append((TAPE_OP, _TAPE_OP_IDS[op]))
            return
        if kind == "cfold":
            raise ValueError(
                "container fold nodes cannot lower to the megakernel tape; "
                "lower_containers() must replace them with leaves first")
        if kind not in ("and", "or"):
            raise ValueError(f"unknown plan-node kind {kind!r}")
        children = node[1]
        rec(children[0])
        for child in children[1:]:
            rec(child)
            tape.append((TAPE_OP, _TAPE_OP_IDS[kind]))

    rec(root)
    depth = max_depth = 0
    for opcode, _ in tape:
        if opcode == TAPE_PUSH:
            depth += 1
            max_depth = max(max_depth, depth)
        elif opcode == TAPE_OP:
            depth -= 1
    assert depth == 1, f"tape leaves {depth} operands on the stack"
    return tuple(tape), max_depth


class PlanStats:
    """Observed plan-shape distribution -> autotuned device capacity buckets.

    The planner feeds it: :func:`compile_plan` records every compiled
    plan's max leaf stream length — the quantity the torch backend pads to
    when batching.  Until :meth:`autotune` derives boundaries (or
    :meth:`load` restores a previous run's), :meth:`capacity_for` falls
    back to power-of-two buckets, so cold processes behave exactly as
    before.  Boundaries are quantiles of the observed distribution
    rounded up to a multiple of 8: buckets hug the live workload instead
    of doubling (less padding per dispatch), while ``max_buckets`` caps
    how many jit variants a shifting query mix can create.
    :meth:`save`/:meth:`load` persist boundaries plus a sample tail, so a
    restarted server warms up with last run's buckets and keeps refining
    them (``serve --plan-stats``).

    Thread-safe: serving records from worker threads while autotune runs
    wherever the operator calls it.
    """

    MAX_SAMPLES = 8192

    def __init__(self):
        self._mutex = make_lock("plan_stats")
        self._max_lens: list = []      # guarded-by: _mutex
        self._boundaries: tuple = ()   # guarded-by: _mutex
        self.recorded = 0              # guarded-by: _mutex

    def record(self, plan) -> None:
        if not plan.streams:
            return
        ml = max(len(s) for s in plan.streams)
        with self._mutex:
            self.recorded += 1
            self._max_lens.append(int(ml))
            if len(self._max_lens) > self.MAX_SAMPLES:
                # keep the newest half: bounded memory, recency-weighted
                self._max_lens = self._max_lens[self.MAX_SAMPLES // 2:]

    def autotune(self, max_buckets: int = 8) -> tuple:
        """Derive bucket boundaries (at most ``max_buckets``) from the
        recorded distribution's quantiles; returns the new boundaries
        (unchanged when nothing was recorded)."""
        with self._mutex:
            lens = sorted(self._max_lens)
            if not lens:
                return self._boundaries
            qs = [lens[min(len(lens) - 1, (i * len(lens)) // max_buckets)]
                  for i in range(1, max_buckets + 1)]
            self._boundaries = tuple(sorted({-(-q // 8) * 8 for q in qs}))
            return self._boundaries

    @property
    def boundaries(self) -> tuple:
        with self._mutex:
            return self._boundaries

    def capacity_for(self, n: int) -> int:
        """Smallest autotuned bucket holding ``n`` stream words; plans
        past the largest boundary use the power-of-two fallback (they are
        the tail the quantiles deliberately don't chase)."""
        with self._mutex:
            bounds = self._boundaries
        for b in bounds:
            if n <= b:
                return b
        return _capacity_bucket(n)

    def stats(self) -> dict:
        with self._mutex:
            return {"recorded": self.recorded,
                    "samples": len(self._max_lens),
                    "boundaries": list(self._boundaries)}

    def save(self, path) -> None:
        with self._mutex:
            payload = {"boundaries": list(self._boundaries),
                       "recorded": self.recorded,
                       "max_lens": self._max_lens[-1024:]}
        with open(path, "w") as fh:
            json.dump(payload, fh)

    def load(self, path) -> bool:
        """Restore persisted boundaries (+ sample tail); returns False
        when the file is missing or unreadable — a cold start, not an
        error."""
        try:
            with open(path) as fh:
                payload = json.load(fh)
        except (OSError, ValueError):
            return False
        with self._mutex:
            self._boundaries = tuple(
                int(b) for b in payload.get("boundaries", []))
            self._max_lens = [int(x) for x in payload.get("max_lens", [])]
        return True


#: Process-wide recorder every ``compile_plan`` feeds and the torch
#: backend's batch grouping reads.  serve --plan-stats persists it.
PLAN_STATS = PlanStats()


@lru_cache(maxsize=32)
def _ones_stream(n_rows: int) -> np.ndarray:
    n_words = (n_rows + ewah.WORD_BITS - 1) // ewah.WORD_BITS
    return ewah.compress(np.full(n_words, ewah.FULL, dtype=np.uint32))


@lru_cache(maxsize=32)
def _zero_stream(n_rows: int) -> np.ndarray:
    n_words = (n_rows + ewah.WORD_BITS - 1) // ewah.WORD_BITS
    return ewah.compress(np.zeros(n_words, dtype=np.uint32))


class PlanContext:
    """What a :class:`~repro.core.encodings.ColumnEncoding` compiles
    against: leaf/container registration plus the constant-result
    streams."""

    __slots__ = ("streams", "n_rows", "containers")

    def __init__(self, n_rows: int):
        self.streams: list = []
        self.containers: list = []
        self.n_rows = n_rows

    def leaf(self, stream) -> tuple:
        self.streams.append(stream)
        return ("leaf", len(self.streams) - 1)

    def container(self, cset) -> int:
        """Register a Roaring container set; returns its cid for a
        ``("cfold", ...)`` node."""
        self.containers.append(cset)
        return len(self.containers) - 1

    def zero(self) -> tuple:
        """Constant-empty leaf (out-of-domain value, empty range)."""
        return self.leaf(_zero_stream(self.n_rows))

    def ones(self) -> tuple:
        """Constant-full leaf (whole-domain range)."""
        return self.leaf(_ones_stream(self.n_rows))


def compile_plan(index, pred: Predicate, names=None) -> Plan:
    """Compile ``pred`` against a materialized ``BitmapIndex``.

    Predicate columns are *original* table positions (pre column-reorder);
    ``names`` optionally maps string column names to those positions.
    Returned row ids live in the index's reordered row space — map back with
    ``index.row_perm[row_ids]``.

    The planner owns the generic steps — name resolution, domain clamping
    (out-of-domain ``Eq``/empty ``Range`` compile to a constant-empty leaf,
    whole-domain to constant-full), fan-in flattening and cost ordering —
    and delegates ``Eq``/``In``/``Range`` on each column to that column's
    :class:`~repro.core.encodings.ColumnEncoding` (equality k-of-N fan-ins,
    bit-sliced comparison folds, or binned coarse-plus-refinement).
    """
    col_perm = np.asarray(index.col_perm)
    inv = np.empty(len(col_perm), dtype=np.int64)
    inv[col_perm] = np.arange(len(col_perm))
    ctx = PlanContext(index.n_rows)

    events: list = []

    def resolve(col):
        if isinstance(col, str):
            if names is None:
                raise ValueError(
                    f"predicate references column {col!r} by name but the "
                    "index has no column names (pass names=...)")
            try:
                col = list(names).index(col)
            except ValueError:
                raise ValueError(
                    f"unknown column {col!r}; known: {', '.join(names)}"
                ) from None
        col = int(col)
        if not 0 <= col < len(col_perm):
            raise ValueError(f"column {col} out of range (0..{len(col_perm) - 1})")
        ci = index.columns[int(inv[col])]
        if ci.streams is None:
            raise ValueError("index built with materialize=False cannot be queried")
        return col, ci.encoding

    def record(col, shape, width, enc, node):
        events.append((col, shape, width, enc.kind, count_merges(node)))
        return node

    def build(p) -> tuple:
        if isinstance(p, Eq):
            col, enc = resolve(p.col)
            if not 0 <= p.value < enc.card:
                return ctx.zero()  # out-of-domain: no rows
            return record(col, "eq", 1, enc, enc.compile_eq(ctx, p.value))
        if isinstance(p, In):
            col, enc = resolve(p.col)
            values = sorted({v for v in p.values if 0 <= v < enc.card})
            if not values:
                return ctx.zero()
            if len(values) == enc.card:
                return ctx.ones()  # every row holds some in-domain value
            return record(col, "in", len(values), enc,
                          enc.compile_in(ctx, values))
        if isinstance(p, Range):
            # clamp to the column domain before any value materializes —
            # Range(col, 0, 10**9) must not iterate a billion values
            col, enc = resolve(p.col)
            lo, hi = max(p.lo, 0), min(p.hi, enc.card - 1)
            if lo > hi:
                return ctx.zero()
            if lo == 0 and hi == enc.card - 1:
                return ctx.ones()
            return record(col, "range", hi - lo + 1, enc,
                          enc.compile_range(ctx, lo, hi))
        if isinstance(p, And):
            return _fanin("and", [build(c) for c in p.children])
        if isinstance(p, Or):
            return _fanin("or", [build(c) for c in p.children])
        if isinstance(p, Not):
            return ("not", build(p.child))
        raise TypeError(f"not a Predicate: {p!r}")

    plan = Plan(streams=ctx.streams, root=build(pred), n_rows=index.n_rows,
                scope=getattr(index, "cache_scope", None),
                containers=ctx.containers or None, workload=tuple(events))
    plan.root = _cost_order(plan.root, plan.streams, plan.n_words)
    _renumber_leaves(plan)
    PLAN_STATS.record(plan)
    _WORKLOAD.record(plan.workload)
    return plan


def evaluate_mask(pred: Predicate, columns, names=None) -> np.ndarray:
    """Evaluate a predicate directly over uncompressed integer columns.

    ``columns`` is the usual per-column array list in **original** order (no
    index, no reordering); returns an (n,) boolean row mask.  This is the
    open-buffer path of :class:`~repro.core.segment.SegmentedIndex` — rows a
    writer has appended but not yet sealed evaluate densely — and doubles
    as the oracle the compressed paths are tested against.
    """
    columns = [np.asarray(c) for c in columns]

    def resolve(col):
        if isinstance(col, str):
            if names is None:
                raise ValueError(
                    f"predicate references column {col!r} by name but no "
                    "names were given")
            try:
                return columns[list(names).index(col)]
            except ValueError:
                raise ValueError(
                    f"unknown column {col!r}; known: {', '.join(names)}"
                ) from None
        col = int(col)
        if not 0 <= col < len(columns):
            raise ValueError(f"column {col} out of range (0..{len(columns) - 1})")
        return columns[col]

    def rec(p) -> np.ndarray:
        if isinstance(p, Eq):
            return resolve(p.col) == p.value
        if isinstance(p, In):
            return np.isin(resolve(p.col), np.asarray(p.values, dtype=np.int64))
        if isinstance(p, Range):
            c = resolve(p.col)
            return (c >= p.lo) & (c <= p.hi)
        if isinstance(p, And):
            m = rec(p.children[0])
            for child in p.children[1:]:
                m = m & rec(child)
            return m
        if isinstance(p, Or):
            m = rec(p.children[0])
            for child in p.children[1:]:
                m = m | rec(child)
            return m
        if isinstance(p, Not):
            return ~rec(p.child)
        raise TypeError(f"not a Predicate: {p!r}")

    return rec(pred)


def _renumber_leaves(plan: Plan) -> None:
    """Renumber leaves in tree-traversal order and permute ``plan.streams``
    to match.  Cost-ordering permutes leaves per-plan, so without this two
    plans of equal structural signature could assign leaf indices to
    different tree positions — and the torch backend, which runs one
    program per batch group, would evaluate every non-first plan with the
    wrong leaf-to-stream mapping.  After canonicalization, equal signature
    implies an identical root tuple."""
    order: list = []

    def rec(nd):
        if nd[0] == "leaf":
            order.append(nd[1])
            return ("leaf", len(order) - 1)
        if nd[0] == "not":
            return ("not", rec(nd[1]))
        if nd[0] == "fold":
            return ("fold", nd[1], tuple(rec(c) for c in nd[2]))
        if nd[0] == "cfold":
            return nd  # container ids index plan.containers, not streams
        return (nd[0], tuple(rec(c) for c in nd[1]))

    plan.root = rec(plan.root)
    plan.streams = [plan.streams[i] for i in order]


def with_live_mask(plan: Plan, live) -> Plan:
    """AND a segment's live-row stream into a compiled plan root, in place.

    This is the implicit AND-NOT-tombstones rule (docs/query_api.md): a
    segment with tombstones hands the planner the *complement* of its
    tombstone bitmap — computed once at delete time via marker-flip
    ``logical_not``, not per query — so a delete costs exactly **one**
    extra merge per segment at query time (``count_merges`` +1; an
    ``AND(root, NOT(tombstones))`` shape would count two).

    The original root is kept as an interior node (the new AND is *not*
    flattened into an existing root fan-in): backends that memoize interior
    results keep their sub-plan cache hits across deletes, and only the
    final AND recomputes when the tombstone set changes.  Leaves are
    re-canonicalized so equal-signature plans still batch into one padded
    device dispatch.
    """
    if live is None:
        return plan
    plan.streams.append(np.asarray(live, dtype=np.uint32))
    plan.root = ("and", (plan.root, ("leaf", len(plan.streams) - 1)))
    _renumber_leaves(plan)
    return plan


def lower_containers(plan: Plan, fold, cache=None) -> Plan:
    """Rewrite every ``("cfold", ops, cids, est)`` node into a ``("leaf",
    i)`` over its evaluated canonical EWAH stream, in place.

    ``fold(csets, ops, n_rows) -> np.uint32`` is the backend's container
    evaluator (numpy streaming merges or batched device launches — both
    must produce the same canonical stream).  This is the one bridge out
    of container space: after it runs, the plan holds only the closed
    stream-node set, so result caching, tombstone ANDs, fan-out shipping,
    and the sanitizers are untouched by the container engine.  Lowered
    fold results are memoized in ``cache`` (a :class:`ResultCache`) under
    content digests of the container sets, scoped like any other entry.
    No-op for plans without containers.
    """
    if not plan.containers:
        return plan
    from .containers import digest as _container_digest

    digests: dict = {}

    def cdig(i):
        if i not in digests:
            digests[i] = _container_digest(plan.containers[i])
        return digests[i]

    def rec(nd):
        kind = nd[0]
        if kind == "leaf":
            return nd
        if kind == "cfold":
            _, fops, cids, _est = nd
            key = (plan.n_rows, "cfold", fops,
                   tuple(cdig(i) for i in cids))
            stream = cache.get(key) if cache is not None else None
            if stream is None:
                stream = fold([plan.containers[i] for i in cids], fops,
                              plan.n_rows)
                if cache is not None:
                    cache.put(key, stream, plan.scope)
            plan.streams.append(stream)
            return ("leaf", len(plan.streams) - 1)
        if kind == "not":
            return ("not", rec(nd[1]))
        if kind == "fold":
            return ("fold", nd[1], tuple(rec(c) for c in nd[2]))
        return (kind, tuple(rec(c) for c in nd[1]))

    plan.root = rec(plan.root)
    plan.containers = None
    _renumber_leaves(plan)
    return plan


class _WorkloadCounters:
    """Aggregated per-(column, predicate shape, encoding) planner counters.

    :func:`compile_plan` feeds one event per column predicate it delegates
    to an encoding; the public surface is :func:`workload_snapshot` /
    :func:`workload_reset` — the API benchmarks and
    :mod:`repro.workload`'s cost model read instead of private planner
    state.
    """

    def __init__(self):
        self._mutex = make_lock("query_workload", reentrant=False)
        self._counts: dict = {}  # guarded-by: _mutex

    def record(self, events) -> None:
        if not events:
            return
        with self._mutex:
            for col, shape, width, enc_kind, merges in events:
                cell = self._counts.setdefault(
                    (col, shape, enc_kind),
                    {"count": 0, "merges": 0, "width": 0})
                cell["count"] += 1
                cell["merges"] += merges
                cell["width"] += width

    def snapshot(self) -> dict:
        with self._mutex:
            return {k: dict(v) for k, v in self._counts.items()}

    def reset(self) -> None:
        with self._mutex:
            self._counts.clear()


_WORKLOAD = _WorkloadCounters()


def workload_snapshot() -> dict:
    """Per-column predicate-flow counters accumulated by every
    :func:`compile_plan` call in this process.

    Returns ``{(column, shape, encoding): {"count", "merges", "width"}}``
    where ``column`` is the original table position, ``shape`` is the
    predicate kind (``"eq"`` / ``"in"`` / ``"range"``), ``encoding`` the
    :class:`~repro.core.encodings.ColumnEncoding` kind that compiled it,
    ``count`` how many predicates hit that cell, and ``merges`` / ``width``
    the summed :func:`count_merges` cost and value-domain width.  The
    snapshot is a deep copy — callers may mutate it freely.  See
    docs/query_api.md ("Workload telemetry").
    """
    return _WORKLOAD.snapshot()


def workload_reset() -> None:
    """Clear the process-wide workload counters (test/benchmark hygiene)."""
    _WORKLOAD.reset()


def _fanin(op: str, children: list) -> tuple:
    """n-ary node; same-op children flatten into the parent fan-in."""
    flat: list = []
    for c in children:
        if c[0] == op:
            flat.extend(c[1])
        else:
            flat.append(c)
    return flat[0] if len(flat) == 1 else (op, tuple(flat))


def _cost_order(node, streams, n_words: int):
    """Order every and/or fan-in smallest-estimated-stream-first (stable).

    ``fold`` children are a comparison circuit whose order carries the bit
    position — they are recursed into but never reordered."""

    def est(nd) -> int:
        if nd[0] == "leaf":
            return len(streams[nd[1]])
        if nd[0] == "not":
            # marker-type flipping preserves run structure: the complement
            # has exactly the child's compressed size
            return est(nd[1]) + 1
        if nd[0] == "fold":
            return sum(est(c) for c in nd[2])
        if nd[0] == "cfold":
            return nd[3]  # the encoding's estimated compressed word cost
        return sum(est(c) for c in nd[1])

    def rec(nd):
        if nd[0] == "leaf":
            return nd
        if nd[0] == "not":
            return ("not", rec(nd[1]))
        if nd[0] == "fold":
            return ("fold", nd[1], tuple(rec(c) for c in nd[2]))
        if nd[0] == "cfold":
            return nd
        children = sorted((rec(c) for c in nd[1]), key=est)
        return (nd[0], tuple(children))

    return rec(node)


# ---------------------------------------------------------------------------
# Compressed-result cache
# ---------------------------------------------------------------------------


_DIGEST_MEMO: dict = {}  # id(stream) -> (weakref, digest)


def _leaf_digest(stream) -> bytes:
    """Content digest of a leaf stream, memoized per array object.

    Leaf streams are immutable after ``BitmapIndex.build``, so the digest
    is computed once per stream instead of once per query (a cache *hit*
    must not cost O(leaf bytes)).  The memo key is the object's id with a
    weakref identity check, so a recycled id can never alias a dead array.
    """
    key = id(stream)
    hit = _DIGEST_MEMO.get(key)
    if hit is not None and hit[0]() is stream:
        return hit[1]
    s = np.ascontiguousarray(stream, dtype=np.uint32)
    digest = hashlib.blake2b(s.tobytes(), digest_size=12).digest()
    try:
        # the death callback evicts the entry, so the memo's size is
        # bounded by the number of *live* digested arrays — no sweeps
        ref = weakref.ref(stream,
                          lambda _, k=key: _DIGEST_MEMO.pop(k, None))
    except TypeError:
        return digest  # non-weakref-able input: skip memoization
    _DIGEST_MEMO[key] = (ref, digest)
    return digest


def _node_key(node, digests, n_rows: int):
    """Canonical cache key for a (sub-)plan: the op tree with each leaf
    index replaced by a content digest of its stream.  Equal sub-plans hit
    across plans, indexes, and predicate spellings; rebuilding an index
    changes the digests, so stale entries can never be returned."""

    def rec(nd):
        if nd[0] == "leaf":
            return ("L", digests[nd[1]])
        if nd[0] == "not":
            return ("not", rec(nd[1]))
        if nd[0] == "fold":
            return ("fold", nd[1], tuple(rec(c) for c in nd[2]))
        if nd[0] == "cfold":
            raise ValueError(
                "container fold nodes have no stable content key; "
                "lower_containers() must replace them first")
        return (nd[0], tuple(rec(c) for c in nd[1]))

    return (n_rows, rec(node))


class ResultCache:
    """LRU cache of compressed (sub-)plan results, shared across queries.

    Values are EWAH streams, keys come from :func:`_node_key`.  Capacity
    is **entry-count** based (``maxsize`` results, not a byte budget) —
    each entry holds only a compressed stream, but very large results
    count the same as tiny ones.  ``hits`` / ``misses`` feed the
    cache-hit-rate benchmark and capacity tuning.

    Entries may carry a **scope** tag (a hashable; segments use
    ``("segment", generation)``): :meth:`invalidate` evicts exactly one
    scope's entries, the segmented-index compaction contract — appends
    never touch cached state (open-buffer rows are not cached) and
    compaction evicts only the retired segments' entries.

    Thread-safe: backend instances are shared process-wide through
    ``get_backend``, and the serving path queries from worker threads
    while the background compactor invalidates retired scopes.  ``_mutex``
    is reentrant (``stats`` reads ``hit_rate`` under it)."""

    def __init__(self, maxsize: int = 256):
        self.maxsize = maxsize
        self._mutex = make_lock("result_cache")
        self._data: OrderedDict = OrderedDict()  # guarded-by: _mutex
        self._scope_keys: dict = {}              # guarded-by: _mutex
        self.hits = 0                            # guarded-by: _mutex
        self.misses = 0                          # guarded-by: _mutex
        self.invalidated = 0                     # guarded-by: _mutex

    def get(self, key):
        with self._mutex:
            hit = self._data.get(key)
            if hit is not None:
                self._data.move_to_end(key)
                self.hits += 1
                return hit[0]
            self.misses += 1
            return None

    def put(self, key, value, scope=None) -> None:
        with self._mutex:
            old = self._data.pop(key, None)
            if old is not None:
                self._unscope(key, old[1])
            self._data[key] = (value, scope)
            if scope is not None:
                self._scope_keys.setdefault(scope, set()).add(key)
            while len(self._data) > self.maxsize:
                k, (_, s) = self._data.popitem(last=False)
                self._unscope(k, s)

    def _unscope(self, key, scope) -> None:  # holds-lock: _mutex
        if scope is not None:
            keys = self._scope_keys.get(scope)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._scope_keys[scope]

    def invalidate(self, scope) -> int:
        """Evict every entry tagged with ``scope``; returns the count."""
        with self._mutex:
            keys = self._scope_keys.pop(scope, None)
            if not keys:
                return 0
            for k in keys:
                self._data.pop(k, None)
            self.invalidated += len(keys)
            return len(keys)

    def scopes(self) -> tuple:
        """The scopes with live entries (diagnostics / tests)."""
        with self._mutex:
            return tuple(self._scope_keys)

    def clear(self) -> None:
        with self._mutex:
            self._data.clear()
            self._scope_keys.clear()
            self.hits = 0
            self.misses = 0
            self.invalidated = 0

    def __len__(self) -> int:
        with self._mutex:
            return len(self._data)

    @property
    def hit_rate(self) -> float:
        with self._mutex:
            return self.hits / max(self.hits + self.misses, 1)

    def stats(self) -> dict:
        with self._mutex:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._data), "hit_rate": self.hit_rate,
                    "invalidated": self.invalidated}


# ---------------------------------------------------------------------------
# Execution backends
# ---------------------------------------------------------------------------

BACKENDS: dict[str, type] = {}


def register_backend(name: str):
    """Decorator: make a backend class available as ``backend=name``."""

    def deco(cls):
        BACKENDS[name] = cls
        cls.name = name
        return cls

    return deco


def backend_names() -> tuple:
    return tuple(sorted(BACKENDS))


_BACKEND_INSTANCES: dict = {}


def get_backend(name: str, **opts):
    """Backend instance for ``name`` (ValueError lists registered names).

    Instances are cached per (name, opts) so state like the torch backend's
    tape memo and result cache survives across query calls.
    """
    try:
        cls = BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown query backend {name!r}; registered: "
            f"{', '.join(backend_names())}"
        ) from None
    key = (name, tuple(sorted(opts.items())))
    if key not in _BACKEND_INSTANCES:
        _BACKEND_INSTANCES[key] = cls(**opts)
    return _BACKEND_INSTANCES[key]


def invalidate_scope(scope) -> int:
    """Evict one scope's entries from every registered backend instance's
    result cache; returns the total evicted count.

    The segmented-index lifecycle calls this when a segment retires
    (compaction): content-digested keys already guarantee stale results are
    never *returned*, invalidation keeps dead segments' entries from
    squatting in the LRU.  Backends constructed directly (not through
    :func:`get_backend`) manage their own caches —
    ``backend.result_cache.invalidate(scope)``.
    """
    total = 0
    for be in _BACKEND_INSTANCES.values():
        cache = getattr(be, "result_cache", None)
        if cache is not None:
            total += cache.invalidate(scope)
    return total


@register_backend("numpy")
class NumpyBackend:
    """Compressed-domain streaming execution (paper §3, O(|A|+|B|) merges).

    Fan-ins fold through ``ewah_stream.logical_many`` (min-heap on actual
    compressed sizes: cheapest intermediates merge first); ``Not`` is a
    marker-type flip (``ewah_stream.logical_not``), never an XOR against a
    materialized all-ones bitmap.  A bare-leaf root (k=1 equality) costs
    its own stream length — the words a scan touches to materialize the
    answer.

    ``execute`` is the uncached row-id oracle path; ``execute_compressed``
    returns the result as an :class:`EwahStream` and memoizes every
    internal node in ``result_cache``, so cascaded predicates sharing
    sub-plans (the same ``In`` selector AND'd with varying filters, a
    repeated dashboard query) skip the merge entirely.
    """

    def __init__(self, cache_size: int = 256):
        self.result_cache = ResultCache(cache_size)

    def execute(self, plan: Plan):
        plan = lower_containers(plan, self._container_fold)
        stream, scanned = self._eval(plan, plan.root)
        if plan.root[0] == "leaf":
            scanned = len(stream)
        bits = ewah.unpack_bits(ewah.decompress(stream), plan.n_rows)
        return np.flatnonzero(bits), int(scanned)

    def execute_many(self, plans):
        return [self.execute(p) for p in plans]

    def _container_fold(self, csets, fops, n_rows):
        """Streaming container evaluation (core/containers.fold): the
        per-chunk class dispatch raises on unknown container classes."""
        from . import containers
        return containers.fold(csets, fops, n_rows)

    def execute_compressed(self, plan: Plan) -> EwahStream:
        plan = lower_containers(plan, self._container_fold,
                                self.result_cache)
        digests = [_leaf_digest(s) for s in plan.streams]
        stream, scanned = self._eval_cached(plan, plan.root, digests)
        if plan.root[0] == "leaf":
            scanned = len(stream)
        return maybe_validate(
            EwahStream(np.asarray(stream, dtype=np.uint32), plan.n_rows,
                       int(scanned)),
            origin="NumpyBackend.execute_compressed")

    def execute_compressed_many(self, plans):
        return [self.execute_compressed(p) for p in plans]

    def _combine(self, plan: Plan, node, eval_child):
        if node[0] == "cfold":
            raise ValueError(
                "container fold reached the stream evaluator; "
                "lower_containers() must replace it first")
        if node[0] == "not":
            s, scanned = eval_child(node[1])
            r, sc = ewah_stream.logical_not(s, plan.n_words)
            return r, scanned + sc
        if node[0] == "fold":
            # the slice-plane comparison circuit: sequential left fold with
            # a per-step op — child order is the bit order, never reordered
            _, fops, children = node
            parts = [eval_child(c) for c in children]
            scanned = sum(sc for _, sc in parts)
            r = parts[0][0]
            for op, (s, _) in zip(fops, parts[1:]):
                r, sc = ewah_stream.logical_op(r, s, op)
                scanned += sc
            return r, scanned
        op, children = node
        if op not in ("and", "or"):
            raise ValueError(f"unknown plan-node kind {op!r}")
        parts = [eval_child(c) for c in children]
        scanned = sum(sc for _, sc in parts)
        r, sc = ewah_stream.logical_many([s for s, _ in parts], op)
        return r, scanned + sc

    def _eval(self, plan: Plan, node):
        if node[0] == "leaf":
            return plan.streams[node[1]], 0
        return self._combine(plan, node, lambda c: self._eval(plan, c))

    def _eval_cached(self, plan: Plan, node, digests):
        if node[0] == "leaf":
            return plan.streams[node[1]], 0
        key = _node_key(node, digests, plan.n_rows)
        hit = self.result_cache.get(key)
        if hit is not None:
            return hit, 0  # reused: no compressed words visited
        r, scanned = self._combine(
            plan, node, lambda c: self._eval_cached(plan, c, digests))
        self.result_cache.put(key, r, plan.scope)
        return r, scanned


def _resolve_device(device):
    """``None`` means the CUDA device; a CUDA device without CUDA raises.
    The CPU is used only when the caller names it."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "TorchBackend runs on a CUDA device and none is available; "
            "pass device='cpu' to run the kernels' plain versions on the host")
    return dev


@register_backend("torch")
class TorchBackend:
    """Batched execution of many queries at once on a CUDA device.

    Plans are grouped by (root op tree, capacity bucket, row count):
    compiled plans carry canonically numbered leaves, so structurally equal
    plans share one root tuple and hence one device program with a correct
    leaf mapping.  Each group's leaf streams pad on the host into one
    (B, m, C) batch, copy to the device, and decode there with the
    ``ewah_decode`` kernel into (m, B, W) word planes.  With ``fuse=True``
    (the default) the whole op tree then runs as one ``planfuse`` launch:
    the plan root lowers to a stack-machine tape (:func:`lower_plan`) that
    the kernel interprets, writing the root words and their EWAH classes in
    one pass.  Plans the kernel cannot run (``kernels.planfuse.fits``: tape
    too long or operand stack too deep) take the per-stage path instead:
    ``wordops_fold`` per tree level, ``slice_fold`` per comparison and the
    ``recompress`` kernel at the root.  Compressed results re-encode on the
    device (``ewah_torch.compress_from_runs``) up to ``MAX_DIRTY`` words a
    row and on the host above it, exactly as the reference does.

    ``device=None`` is the CUDA device and raises where there is none;
    ``device="cpu"`` runs every kernel's plain PyTorch version instead.
    """

    def __init__(self, device=None, cache_size: int = 256, fuse: bool = True):
        self.device = _resolve_device(device)
        self.fuse = fuse
        self._tape_memo: dict = {}
        self.result_cache = ResultCache(cache_size)

    def execute(self, plan: Plan):
        return self.execute_many([plan])[0]

    def execute_many(self, plans):
        plans = [lower_containers(p, self._container_fold,
                                  self.result_cache) for p in plans]
        out: list = [None] * len(plans)
        for (root, cap, n_rows), idxs in self._group(plans).items():
            batch, lengths = self._pad_group(plans, idxs, cap)
            n_words = (n_rows + ewah.WORD_BITS - 1) // ewah.WORD_BITS
            words = self._run(root, *self._to_device(batch, lengths), n_words)
            words = words.cpu().numpy().view(np.uint32)
            for b, i in enumerate(idxs):
                bits = ewah.unpack_bits(words[b], n_rows)
                out[i] = (np.flatnonzero(bits), plans[i].leaf_words())
        return out

    def execute_compressed(self, plan: Plan) -> EwahStream:
        return self.execute_compressed_many([plan])[0]

    def execute_compressed_many(self, plans):
        """Batched compressed-in/compressed-out execution: uncached plans
        group exactly like ``execute_many``, but the device program ends
        with the re-encode, so results come back as EWAH streams and
        whole-plan results land in ``result_cache``."""
        plans = [lower_containers(p, self._container_fold,
                                  self.result_cache) for p in plans]
        out: list = [None] * len(plans)
        keys: list = [None] * len(plans)
        todo = []
        for i, p in enumerate(plans):
            digests = [_leaf_digest(s) for s in p.streams]
            keys[i] = _node_key(p.root, digests, p.n_rows)
            hit = self.result_cache.get(keys[i])
            if hit is not None:
                out[i] = maybe_validate(
                    EwahStream(hit.data, hit.n_rows, 0),  # cache: no scan
                    origin="TorchBackend.execute_compressed_many[cache]")
            else:
                todo.append(i)
        for (root, cap, n_rows), idxs in self._group(plans, todo).items():
            batch, lengths = self._pad_group(plans, idxs, cap)
            n_words = (n_rows + ewah.WORD_BITS - 1) // ewah.WORD_BITS
            dev_batch = self._to_device(batch, lengths)
            if n_words <= ewah.MAX_DIRTY:
                streams, lens = self._run(root, *dev_batch, n_words,
                                          compressed=True)
                streams = streams.cpu().numpy().view(np.uint32)
                lens = lens.cpu().numpy()
                enc = [streams[b, : lens[b]] for b in range(len(idxs))]
            else:
                # beyond the single-marker-per-group limit of the vectorized
                # emit (~1M rows) the re-encode happens host-side
                words = self._run(root, *dev_batch, n_words)
                words = words.cpu().numpy().view(np.uint32)
                enc = [ewah.compress(words[b]) for b in range(len(idxs))]
            for b, i in enumerate(idxs):
                res = maybe_validate(
                    EwahStream(enc[b], n_rows, plans[i].leaf_words()),
                    origin="TorchBackend.execute_compressed_many")
                self.result_cache.put(keys[i], res, plans[i].scope)
                out[i] = res
        return out

    def _group(self, plans, idxs=None) -> dict:
        groups: dict = {}
        for i in range(len(plans)) if idxs is None else idxs:
            p = plans[i]
            cap = PLAN_STATS.capacity_for(max(len(s) for s in p.streams))
            # key on the full root (leaf indices included), not signature():
            # only plans with an identical leaf-to-stream mapping may share
            # a device program
            groups.setdefault((p.root, cap, p.n_rows), []).append(i)
        return groups

    @staticmethod
    def _pad_group(plans, idxs, cap):
        m = len(plans[idxs[0]].streams)
        batch = np.zeros((len(idxs), m, cap), dtype=np.uint32)
        lengths = np.zeros((len(idxs), m), dtype=np.int32)
        for b, i in enumerate(idxs):
            for j, s in enumerate(plans[i].streams):
                batch[b, j, : len(s)] = s
                lengths[b, j] = len(s)
        return batch, lengths

    def _to_device(self, batch, lengths):
        """Host (B, m, C) uint32 streams and (B, m) lengths -> int32
        bit-view tensors on the backend's device."""
        import torch

        return (torch.from_numpy(batch.view(np.int32)).to(self.device),
                torch.from_numpy(lengths).to(self.device))

    def _container_fold(self, csets, fops, n_rows):
        raise NotImplementedError(
            "Roaring container folds are not ported to the torch backend "
            "yet (ROADMAP.md, queue 1 item 4: container fold on kernels 5-6); "
            "use the numpy backend for Roaring-encoded columns")

    def _fused_tape(self, root):
        """The lowered instruction tape for ``root`` when the planfuse
        kernel can run it, else None: plans past the kernel's tape-length
        or stack-depth limit (``kernels.planfuse.fits``) run per stage."""
        if not self.fuse:
            return None
        if root in self._tape_memo:
            return self._tape_memo[root]
        from ..kernels import planfuse

        tape, depth = lower_plan(root)
        self._tape_memo[root] = tape if planfuse.fits(tape, depth) else None
        return self._tape_memo[root]

    def _run(self, root, batch, lengths, n_words: int,
             compressed: bool = False):
        """The device program of one group: decode, evaluate, and (when
        ``compressed``) re-encode.  ``batch`` (B, m, C) and ``lengths``
        (B, m) lie on the device.  Returns (B, W) words, or (streams
        (B, W + 1), lengths (B,)) when compressed."""
        import torch

        from . import ewah_torch
        from ..kernels import ops as kops

        tape = self._fused_tape(root)
        planes = kops.ewah_decode(batch, lengths, n_words)  # (m, B, W)
        m, B = planes.shape[0], planes.shape[1]

        if tape is not None:
            # fused: the whole op tree + the classification in ONE launch
            flat, kflat = kops.plan_fuse(planes.reshape(m, -1), tape)
            words = flat.reshape(B, n_words)
            if not compressed:
                return words
            kind = kflat.reshape(B, n_words)
            # per-row run starts from the fused classification: word 0
            # always opens a run (recompress_batch's opposite-class
            # sentinel reduces to exactly this), then any class change
            return ewah_torch.compress_from_runs(
                words, kind, ewah_torch.run_starts(kind), n_words + 1)

        def ev(node):
            if node[0] == "leaf":
                return planes[node[1]]
            if node[0] == "cfold":
                raise ValueError(
                    "container fold reached the batched evaluator; "
                    "lower_containers() must replace it first")
            if node[0] == "not":
                return torch.bitwise_not(ev(node[1]))
            if node[0] == "fold":
                # all planes of a slice comparison in ONE slicefold launch
                _, fops, children = node
                parts = torch.stack([ev(c) for c in children])  # (p, B, W)
                folded = kops.slice_fold(parts.reshape(parts.shape[0], -1),
                                         fops)
                return folded.reshape(parts.shape[1:])
            op, children = node
            if op not in ("and", "or"):
                raise ValueError(f"unknown plan-node kind {op!r}")
            parts = torch.stack([ev(c) for c in children])  # (p, B, W)
            folded = kops.wordops_fold(parts.reshape(parts.shape[0], -1), op)
            return folded.reshape(parts.shape[1:])

        words = ev(root)
        if not compressed:
            return words
        # worst-case EWAH size for n words is n + 1 (all-dirty: one
        # marker + n verbatim words; clean groups only shrink it)
        return kops.recompress_batch(words, n_words + 1)


def _capacity_bucket(n: int) -> int:
    return max(8, 1 << (int(n) - 1).bit_length())
