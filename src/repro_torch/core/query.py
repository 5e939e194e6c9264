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
  padded to the power of two that holds a plan's longest one, decoded by
  the ``ewah_decode`` kernel, and the whole plan runs in one ``planfuse``
  kernel launch (or per stage through the ``wordops`` / ``slicefold`` /
  ``recompress`` kernels), many queries per dispatch.  ``words_scanned``
  is the total compressed leaf words read.

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
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from . import ewah, ewah_stream
from .. import tracing
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
# planfuse programs a TorchBackend keeps, least recently used dropped first
TAPE_MEMO_SIZE = 256
# the per-stage path gathers the literals of at most this many bytes of
# alike clauses at once
CLAUSE_CHUNK_BYTES = 1 << 30


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
    with tracing.span("query.plan"):
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
    return lower_containers_many(
        [plan], lambda folds: [fold(*f) for f in folds], cache)[0]


def lower_containers_many(plans, fold_many, cache=None) -> list:
    """:func:`lower_containers` over a list of plans, with every fold of
    the list evaluated in ONE call: ``fold_many([(csets, ops, n_rows),
    ...]) -> [np.uint32 stream, ...]`` (the torch backend folds them all
    in one ``containerops`` launch).

    Folds dedupe by the cache key ``(n_rows, "cfold", ops, digests)``: a
    fold that several nodes share is evaluated once.  The cache sees what
    the per-plan lowering would show it: each distinct uncached key misses
    once and is put with the scope of the first plan that needs it, and
    every later node of the same key is a hit.  Leaves are substituted
    and renumbered exactly as :func:`lower_containers` does.  Returns
    ``plans`` (rewritten in place).
    """
    from .containers import digest as _container_digest

    def walk(nd, visit):
        kind = nd[0]
        if kind == "leaf":
            return nd
        if kind == "cfold":
            return visit(nd)
        if kind == "not":
            return ("not", walk(nd[1], visit))
        if kind == "fold":
            return ("fold", nd[1], tuple(walk(c, visit) for c in nd[2]))
        return (kind, tuple(walk(c, visit) for c in nd[1]))

    keys: list = []            # one per cfold node, in traversal order
    found: dict = {}           # key -> stream
    todo: dict = {}            # key -> (fold arguments, scope)
    for plan in plans:
        if not plan.containers:
            continue
        digests: dict = {}

        def cdig(i, plan=plan, digests=digests):
            if i not in digests:
                digests[i] = _container_digest(plan.containers[i])
            return digests[i]

        def visit(nd, plan=plan, cdig=cdig):
            _, fops, cids, _est = nd
            key = (plan.n_rows, "cfold", fops, tuple(cdig(i) for i in cids))
            keys.append(key)
            if key not in found and key not in todo:
                hit = cache.get(key) if cache is not None else None
                if hit is not None:
                    found[key] = hit
                else:
                    todo[key] = (([plan.containers[i] for i in cids], fops,
                                  plan.n_rows), plan.scope)
            return nd

        walk(plan.root, visit)
    if todo:
        streams = fold_many([args for args, _ in todo.values()])
        for (key, (_, scope)), stream in zip(todo.items(), streams):
            found[key] = stream
            if cache is not None:
                cache.put(key, stream, scope)
    order = iter(keys)
    first = set(todo) | set(found)
    for plan in plans:
        if not plan.containers:
            continue

        def leaf(nd, plan=plan):
            key = next(order)
            if key in first:
                first.discard(key)      # its lookup was made above
                stream = found[key]
            else:                       # the per-plan lowering's later hit
                stream = cache.get(key) if cache is not None else None
                stream = found[key] if stream is None else stream
            plan.streams.append(stream)
            return ("leaf", len(plan.streams) - 1)

        plan.root = walk(plan.root, leaf)
        plan.containers = None
        _renumber_leaves(plan)
    return plans


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

    Plans are grouped by (root op tree, leaf sharing, capacity, row
    count): compiled plans carry canonically numbered leaves, so
    structurally equal plans share one root tuple and hence one device
    program with a correct leaf mapping.  Leaves that reference one stream
    object (the bit-slices of a column, which an IN-list's equalities and a
    range's two ends read again and again) become one plane: each group's
    distinct streams pad on the host into one (B, m, C) batch, copy to the
    device, and decode there with the ``ewah_decode`` kernel into (m, B, W)
    word planes, and leaf i reads plane ``share[i]`` (:func:`_sharing`).
    With ``fuse=True`` (the default) the whole op tree then runs as one
    ``planfuse`` launch: the plan root lowers to a stack-machine tape
    (:func:`lower_plan`) that the kernel interprets, writing the root words
    and their EWAH classes in one pass.  Plans the kernel cannot run
    (``kernels.planfuse.fits``: tape too long or operand stack too deep)
    take the per-stage path instead (:meth:`_stages`): ``wordops_fold``
    per fan-in and ``slice_fold`` per comparison.  Both entries share this
    group loop (:meth:`_groups`, :meth:`_evaluate`) and differ only in
    their finisher on the group's answer words:

    * :meth:`execute_compressed_many` encodes them on the device
      (:meth:`_encode`: the ``ewah_encode`` kernel at any row length, fed
      planfuse's word classes, or the ``recompress`` kernel's per stage),
      the canonical stream ``ewah.compress`` writes, and brings the
      streams and their lengths home in one copy a group; nothing
      re-encodes on the host (the reference does past ``MAX_DIRTY``
      words);
    * :meth:`execute_many` cuts row ids from them on the device with the
      two ``rowids`` kernels and brings the ids home in one copy a group;
      the host unpacks no word.

    Roaring columns' ``("cfold", ...)`` nodes of all the call's plans fold
    first (:func:`lower_containers_many`), every fold of the call in one
    ``containerops`` launch (:meth:`_container_fold_many`).

    ``device=None`` is the CUDA device and raises where there is none;
    ``device="cpu"`` runs every kernel's plain PyTorch version instead.
    """

    def __init__(self, device=None, cache_size: int = 256, fuse: bool = True):
        self.device = _resolve_device(device)
        self.fuse = fuse
        # planfuse programs a (root, share); bounded, so a stream of
        # distinct roots (an IN-list's key sets) cannot grow it for ever
        self._programs = lru_cache(maxsize=TAPE_MEMO_SIZE)(self._program)
        self.result_cache = ResultCache(cache_size)

    def execute(self, plan: Plan):
        return self.execute_many([plan])[0]

    def execute_many(self, plans):
        """Batched execution with row-id answers: each group's answer
        words (:meth:`_groups`), then the ``rowids`` kernels turn them
        into row ids on the device, and the ids of the whole group come
        back in one copy; answer b is a view of it.  Under tracing,
        ``backend.rowid_answers`` counts the answers and
        ``backend.rowid_bytes`` the bytes of ids copied back."""
        from ..kernels import ops as kops

        def count(words, kind, n_rows):
            offsets, totals = kops.rowid_counts(words, n_rows)
            return words, offsets, totals.cpu().numpy()

        with tracing.span("backend.call", device=True):
            plans = lower_containers_many(plans, self._container_fold_many,
                                          self.result_cache)
            out: list = [None] * len(plans)
            for idxs, n_rows, (words, offsets, totals) in self._groups(
                    plans, None, count):
                with tracing.span("backend.unpack", device=True):
                    ids = kops.rowid_write(words, n_rows, offsets,
                                           int(totals.sum()))
                    host = ids.cpu().numpy()
                    ends = np.cumsum(totals)
                    for b, i in enumerate(idxs):
                        out[i] = (host[ends[b] - totals[b]: ends[b]],
                                  plans[i].leaf_words())
                if tracing.enabled():
                    tracing.add("backend.rowid_answers", len(idxs))
                    tracing.add("backend.rowid_bytes", host.nbytes)
            return out

    def execute_compressed(self, plan: Plan) -> EwahStream:
        return self.execute_compressed_many([plan])[0]

    def execute_compressed_many(self, plans):
        """Batched compressed-in/compressed-out execution: uncached plans
        group exactly like ``execute_many``, but each group's answer words
        encode on the device (:meth:`_encode`) and come back as EWAH
        streams, with their lengths, in one copy; whole-plan results land
        in ``result_cache``.  Under tracing, ``backend.encoded`` counts
        the answers the encoder wrote and ``backend.encoded_overflow``
        those among them whose stream splits a run at ``MAX_CLEAN`` or
        ``MAX_DIRTY``."""
        from ..kernels import ops as kops

        def encode(words, kind, n_rows):
            streams = self._encode(words, kind)[0]
            flat = kops.encoded_flat(streams).cpu().numpy().view(np.uint32)
            return kops.split_encoded(flat, *streams.shape)

        with tracing.span("backend.call", device=True):
            plans = lower_containers_many(plans, self._container_fold_many,
                                          self.result_cache)
            out: list = [None] * len(plans)
            keys: list = [None] * len(plans)
            todo = []
            with tracing.span("backend.key"):
                for i, p in enumerate(plans):
                    digests = [_leaf_digest(s) for s in p.streams]
                    keys[i] = _node_key(p.root, digests, p.n_rows)
                    hit = self.result_cache.get(keys[i])
                    if hit is not None:
                        out[i] = maybe_validate(
                            EwahStream(hit.data, hit.n_rows, 0),  # no scan
                            origin="TorchBackend.execute_compressed_many"
                                   "[cache]")
                    else:
                        todo.append(i)
            for idxs, n_rows, (streams, lens, over) in self._groups(
                    plans, todo, encode):
                if tracing.enabled():
                    tracing.add("backend.encoded", len(idxs))
                    tracing.add("backend.encoded_overflow", int(over.sum()))
                for b, i in enumerate(idxs):
                    res = maybe_validate(
                        EwahStream(streams[b, : lens[b]], n_rows,
                                   plans[i].leaf_words()),
                        origin="TorchBackend.execute_compressed_many")
                    self.result_cache.put(keys[i], res, plans[i].scope)
                    out[i] = res
            return out

    def _groups(self, plans, idxs, fetch):
        """The group loop of both entries.  Each group of the plans
        ``idxs`` (all where None) that shares one device program
        (:meth:`_group`) is padded, copied and evaluated
        (:meth:`_evaluate`), then ``fetch(words, kind, n_rows)``, the
        entry's finisher, takes its answer words until what the host needs
        of them is there.  Yields (the group's plan indices, n_rows, what
        ``fetch`` returned).  The span ``backend.device`` runs from the
        fused program's enqueue to ``fetch``'s return; on the per-stage
        path the span ``backend.stages`` takes the decode and every stage,
        and ``backend.device`` the finisher."""
        for (root, share, cap, n_rows), group in self._group(
                plans, idxs).items():
            batch, lengths = self._to_device(
                *self._pad_group(plans, group, cap, share))
            n_words = (n_rows + ewah.WORD_BITS - 1) // ewah.WORD_BITS
            prog = self._fused_program(root, share)
            args = (prog, root, share, batch, lengths, n_words)
            if prog is None:
                with tracing.span("backend.stages", device=True):
                    words, kind = self._evaluate(*args)
                with tracing.span("backend.device", device=True):
                    got = fetch(words, kind, n_rows)
            else:
                with tracing.span("backend.device", device=True):
                    got = fetch(*self._evaluate(*args), n_rows)
            yield group, n_rows, got

    def _group(self, plans, idxs=None) -> dict:
        """``{(root, share, cap, n_rows): plan indices}``: the plans that
        share one device program.  ``cap`` is the power of two (at least
        8) that holds the plan's longest leaf stream."""
        with tracing.span("backend.pad"):
            groups: dict = {}
            for i in range(len(plans)) if idxs is None else idxs:
                p = plans[i]
                cap = _capacity_bucket(max(len(s) for s in p.streams))
                # key on the full root (leaf indices included), not
                # signature(), and on the leaf sharing: only plans with an
                # identical leaf-to-plane mapping may share a device program
                key = (p.root, _sharing(p), cap, p.n_rows)
                groups.setdefault(key, []).append(i)
        tracing.add("backend.groups", len(groups))
        return groups

    @staticmethod
    def _pad_group(plans, idxs, cap, share):
        """One group's distinct leaf streams padded to ``cap`` words:
        (B, m, cap) uint32 and their (B, m) lengths, plane k of a plan
        being its first leaf with ``share[i] == k``.  Under tracing,
        ``backend.leaf_refs`` counts the group's leaf references and
        ``backend.planes`` the planes padded for them."""
        with tracing.span("backend.pad"):
            n_refs = len(plans[idxs[0]].streams)
            first = _first_refs(share)
            m = len(first)
            batch = np.zeros((len(idxs), m, cap), dtype=np.uint32)
            lengths = np.zeros((len(idxs), m), dtype=np.int32)
            for b, i in enumerate(idxs):
                streams = plans[i].streams
                for k, j in enumerate(first):
                    s = streams[j]
                    batch[b, k, : len(s)] = s
                    lengths[b, k] = len(s)
        if tracing.enabled():
            tracing.add("backend.leaf_refs", len(idxs) * n_refs)
            tracing.add("backend.planes", len(idxs) * m)
        return batch, lengths

    def _to_device(self, batch, lengths):
        """Host (B, m, C) uint32 streams and (B, m) lengths -> int32
        bit-view tensors on the backend's device.  Counts the bytes copied
        (``backend.h2d_bytes``) and the stream words among them
        (``backend.stream_bytes``); the rest is padding."""
        if tracing.enabled():
            tracing.add("backend.h2d_bytes", batch.nbytes + lengths.nbytes)
            tracing.add("backend.stream_bytes", 4 * int(lengths.sum()))
        with tracing.span("backend.h2d", device=True):
            return self._tensor(batch), self._tensor(lengths)

    def _container_fold_many(self, folds):
        """Device evaluation of ``("cfold", ...)`` nodes: ``[(csets, ops,
        n_rows), ...]`` -> their canonical EWAH streams, bit-identical to
        the numpy streaming path (``containers.fold``).

        Every non-empty fold, whatever its ops, goes into ONE
        ``containerops`` launch (:meth:`_fold_one_launch`): an "and" step
        intersects on the card inside that launch (an array with a bitmap
        included; a chunk the "and" set lacks reads as zero), so no round
        comes back to the host.  Unknown ops raise.
        """
        from . import containers as C

        out: list = [None] * len(folds)
        one = []
        for i, (csets, fops, n_rows) in enumerate(folds):
            for op in fops:
                if op not in C._MERGE_OPS:
                    raise ValueError(f"unknown container merge op {op!r}")
            if csets:
                one.append(i)
            else:
                out[i] = C.fold(csets, fops, n_rows)
        if one:
            streams = self._fold_one_launch([folds[i] for i in one])
            for i, stream in zip(one, streams):
                out[i] = stream
        return out

    def _fold_one_launch(self, folds):
        """Folds in one ``containerops`` launch: the sets go up once in
        compact form (``kernels.containers.pack_folds``: arrays and runs
        expand on the card, a chunk an "and" set lacks is an ``ABSENT``
        step), the kernel writes each fold's dense plane, and the
        ``ewah_encode`` kernel encodes each plane on the device, at any
        width.  Streams and lengths come back in one copy.  ``to_stream``
        depends only on the set bits, so the streams equal
        ``containers.fold``'s."""
        import torch

        from . import ewah_torch
        from ..kernels import containers as kc
        from ..kernels import ops as kops

        order = sorted(range(len(folds)), key=lambda i: folds[i][2])
        packed = kc.pack_folds([folds[i] for i in order])
        planes = kops.container_fold(self._tensor(packed.buf), packed)
        parts, groups = [], []       # groups: (F, capacity) a plane width
        f = 0
        while f < len(order):
            off, W = packed.planes[f]
            F = sum(1 for g in packed.planes[f:] if g[1] == W)
            group = planes[off: off + F * W].reshape(F, W)
            cap = ewah_torch.stream_capacity(W)
            streams, _, _ = kops.ewah_encode(group, ewah_torch.classify(group),
                                             cap)
            parts.append(kops.encoded_flat(streams))
            groups.append((F, cap))
            f += F
        host = torch.cat(parts).cpu().numpy().view(np.uint32)
        out: list = [None] * len(folds)
        at = f = 0
        for F, cap in groups:
            streams, lens, _ = kops.split_encoded(
                host[at: at + F * (cap + 2)], F, cap)
            for j in range(F):
                out[order[f + j]] = streams[j, : lens[j]].copy()
            at += F * (cap + 2)
            f += F
        return out

    def _tensor(self, arr):
        """A host int32 or uint32 array -> an int32 (bit-view) tensor on
        the backend's device."""
        import torch

        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int32)).to(self.device)

    def _fused_program(self, root, share):
        """The planfuse program for ``root`` whose leaf i reads plane
        ``share[i]``: its tape and the tape's host split,
        ``kernels.planfuse.Program``, memoised per (root, share), when the
        kernel can run it, else None: plans past the kernel's tape-length
        or stack-depth limit (``kernels.planfuse.fits``) run per stage."""
        if not self.fuse:
            return None
        from ..kernels import planfuse

        # a push a leaf and an op a leaf past the first: too long for the
        # kernel whatever the tree, so not lowered (nor memoised) at all
        if 2 * len(share) - 1 > planfuse.MAX_TAPE_LEN:
            return None
        return self._programs(root, share)

    @staticmethod
    def _program(root, share):
        from ..kernels import planfuse

        tape, depth = lower_plan(root)
        if not planfuse.fits(tape, depth):
            return None
        return planfuse.split(tuple((op, share[a] if op == TAPE_PUSH else a)
                                    for op, a in tape))

    def _evaluate(self, prog, root, share, batch, lengths, n_words: int):
        """One group's answer words on the device: the planes decoded from
        ``batch`` (B, m, C) and ``lengths`` (B, m), leaf i of ``root``
        reading plane ``share[i]``, then the fused program ``prog``
        (:meth:`_fused_program`) or, where it is None, the per-stage
        evaluator (:meth:`_stages`).  Returns (words (B, W), kind): kind is
        planfuse's EWAH class of each word on the fused path, None per
        stage."""
        from ..kernels import ops as kops

        planes = kops.ewah_decode(batch, lengths, n_words)  # (m, B, W)
        if prog is None:
            return self._stages(root, share, planes), None
        m, B = planes.shape[0], planes.shape[1]
        # the whole op tree + the classification in ONE launch
        flat, kind = kops.plan_fuse(planes.reshape(m, -1), prog)
        return flat.reshape(B, n_words), kind.reshape(B, n_words)

    @staticmethod
    def _encode(words, kind):
        """The compressed entry's finisher on the device: (B, W) answer
        words -> ``ops.ewah_encode``'s (streams (B,
        ``ewah_torch.stream_capacity(W)``), lengths (B,), overflow (B,)),
        views of one buffer.  The fused program's word classes ``kind``
        feed the encoder; where there are none (per stage) the
        ``recompress`` kernel classifies the words first."""
        from . import ewah_torch
        from ..kernels import ops as kops

        cap = ewah_torch.stream_capacity(words.shape[1])
        if kind is None:
            return kops.recompress_batch(words, cap)
        return kops.ewah_encode(words, kind, cap)

    def _stages(self, root, share, planes):
        """The per-stage evaluator: ``root`` over the decoded (m, B, W)
        ``planes``, leaf i reading plane ``share[i]`` -> (B, W) words.
        ``slice_fold`` per comparison and ``wordops_fold`` per fan-in; a
        fan-in's children that are fan-ins of leaves and complemented
        leaves alike in op and width (an IN-list's equalities) gather
        their planes and fold together (:func:`_clauses`)."""
        import torch

        from ..kernels import ops as kops

        if planes.is_cuda:
            kops.build_per_stage()
        m = planes.shape[0]
        lits: list = []   # filled by the first _clauses call

        def ev(node):
            if node[0] == "leaf":
                return planes[share[node[1]]]
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
            rows = [_literal(c, share, m) for c in children]
            if None not in rows:          # a clause: an equality's slices
                return _clauses(op, [rows], planes, lits)[0][0]
            # children that are clauses alike (an IN-list's equalities) go
            # together, the rest one by one; and/or take them in any order
            parts, alike = [], {}
            for c in children:
                r = [_literal(g, share, m) for g in c[1]] \
                    if c[0] in ("and", "or") else [None]
                if None in r:
                    parts.append(ev(c)[None])
                else:
                    alike.setdefault((c[0], len(r)), []).append(r)
            for (cop, _), group in alike.items():
                parts += _clauses(cop, group, planes, lits)
            stacked = torch.cat(parts)                    # (p, B, W)
            folded = kops.wordops_fold(stacked.reshape(len(stacked), -1), op)
            return folded.reshape(stacked.shape[1:])

        return ev(root)


def _literal(node, share, m: int):
    """The row of the per-stage literals (the m planes, then their
    complements) that a leaf or a complemented leaf reads, else None."""
    neg = node[0] == "not"
    leaf = node[1] if neg else node
    if leaf[0] != "leaf":
        return None
    k = share[leaf[1]]
    return k + m if neg else k


def _clauses(op, rows, planes, lits: list):
    """Fan-ins of ``op`` over the per-stage literals, ``rows[j]`` the
    literal rows (:func:`_literal`) of the j-th, all of one width w: one
    gather and one ``wordops_fold`` per chunk of them -> [(k, B, W), ...]
    in ``rows`` order.  ``lits`` holds the literals, the (m, B, W)
    ``planes`` then their complements, once the first call made them."""
    import torch

    from ..kernels import ops as kops

    if not lits:
        lits.append(torch.cat([planes, torch.bitwise_not(planes)]))
    # (w, clauses) in row-major order: the gather's result takes the
    # index's layout, and wordops_fold wants it contiguous
    idx = torch.from_numpy(np.ascontiguousarray(
        np.asarray(rows, dtype=np.int64).T)).to(planes.device)
    w = idx.shape[0]
    step = max(1, CLAUSE_CHUNK_BYTES // max(1, w * planes[0].numel() * 4))
    out = []
    for c in range(0, idx.shape[1], step):
        part = lits[0][idx[:, c: c + step]]           # (w, k, B, W)
        folded = kops.wordops_fold(part.view(w, -1), op)
        out.append(folded.reshape(part.shape[1:]))
    return out


def _sharing(plan) -> tuple:
    """The plane of each leaf of ``plan`` when each distinct leaf stream
    (by identity, as the plan holds it) is decoded once: a tuple numbering
    the streams in order of first reference (``range(n)`` where no two
    leaves share one)."""
    seen: dict = {}
    return tuple(seen.setdefault(id(s), len(seen)) for s in plan.streams)


def _first_refs(share) -> list:
    """The first leaf of each plane of :func:`_sharing`'s ``share``."""
    first: list = []
    for i, k in enumerate(share):
        if k == len(first):
            first.append(i)
    return first


def _capacity_bucket(n: int) -> int:
    return max(8, 1 << (int(n) - 1).bit_length())
