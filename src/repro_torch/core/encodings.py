"""Pluggable per-column bitmap encodings behind one ``ColumnEncoding`` API.

The paper's index hardwires one representation — an EWAH equality bitmap per
attribute value (k-of-N codes).  That makes a ``Range`` spanning w values a
w-wide OR fan-in: range cost scales with cardinality.  The Roaring line of
work (Chambi et al. 2014; Lemire et al. 2016) shows that picking the
representation *per container/column* is what keeps compressed bitmaps
consistently fast, and the attribute-value histogram this repo already
computes for row ordering is exactly the statistic the chooser needs.

Three encodings implement the protocol:

* :class:`EqualityEncoding` — the paper's k-of-N value bitmaps (extracted
  from the old hardwired path, bit-for-bit identical).
* :class:`BitSlicedEncoding` — ``m = ceil(log2(card))`` EWAH *slice planes*
  (plane i = rows whose value has bit i set).  Any range compiles to the
  textbook slice-plane comparison circuit — at most ``2m`` stream merges
  regardless of range width — emitted as sequential ``("fold", ops, ...)``
  plan nodes the backends execute in one pass (one ``slice_fold``
  kernel launch on the torch backend).  With ``gray=True`` the planes hold the
  Gray code of the value (``encoding.to_gray``, the transform
  ``kernels/gray.py`` implements on-device): adjacent values then differ in
  exactly one plane, which compresses sorted runs better; the comparison
  circuit decodes binary bits in-plan as XOR fan-ins over the Gray planes.
* :class:`BinnedEncoding` — histogram-equalized contiguous value bins (one
  EWAH bitmap per bin, ~equal rows each) plus a lazy candidate-check
  refinement over the per-row value surface (one int32 per row, kept in
  sorted-row order).  A range is the OR of its fully-covered bins' bitmaps
  plus one exact leaf for the partial boundary values — the classic binned
  "coarse plan + refinement", with the refinement resolved densely at
  compile time so both backends execute the result unchanged, and without
  ever reading the segment's raw columns (``keep_columns=False`` safe).

* :class:`RoaringEncoding` — one Roaring-style container set per value
  (:mod:`repro.core.containers`): array / bitmap / run containers per
  aligned 2^16-row chunk, chosen by the classic cardinality/run-count
  thresholds at seal time.  Predicates compile to ``("cfold", ...)`` plan
  nodes evaluated container-wise (galloping intersections, batched device
  word merges) and lowered to one canonical ``EwahStream`` leaf at the
  plan root — see docs/containers.md.

Which encoding a column gets is decided by an ``encoding`` *strategy*
(:mod:`repro.core.strategies`) reading the column histogram — the built-in
``"auto"`` chooser sends high-cardinality columns to bit-sliced, skewed
low-cardinality ones to equality, and mid-cardinality flat ones to binned.
See docs/encodings.md.
"""

from __future__ import annotations

import math

import numpy as np

from . import ewah
from .encoding import choose_N, clamp_k, to_gray
from .index_size import column_bitmap_sizes

__all__ = [
    "ColumnEncoding", "EqualityEncoding", "BitSlicedEncoding",
    "BinnedEncoding", "RoaringEncoding", "assign_codes", "build_encoding",
    "encoding_kinds",
]


def assign_codes(
    n_values: int, k: int, code_order: str = "gray", value_policy: str = "alpha",
    hist: np.ndarray | None = None,
) -> tuple[np.ndarray, int, int]:
    """Build the (n_values, k) bitmap-position code table for one column.

    code_order / value_policy are registry strategy names (built-ins:
    'gray'/'lex' enumeration, 'alpha'/'freq' value policy); unknown names
    raise ValueError listing what is registered.
    Returns (codes, N, k_effective).
    """
    from .strategies import get_strategy

    k_eff = clamp_k(n_values, k)
    N = choose_N(n_values, k_eff)
    enum = get_strategy("code_order", code_order)
    policy = get_strategy("value_policy", value_policy)
    ordered_codes = enum(N, k_eff, n_values)
    order = np.arange(n_values) if hist is None else np.asarray(policy(hist))
    codes = np.empty((n_values, k_eff), dtype=np.int32)
    codes[order] = ordered_codes
    return codes, N, k_eff


def _positions_to_stream(positions: np.ndarray, n_rows: int) -> np.ndarray:
    """Sorted row positions -> compressed EWAH stream over n_rows."""
    if len(positions):
        return ewah.compress(ewah.positions_to_words(positions, n_rows))
    return ewah.compress(np.zeros((n_rows + ewah.WORD_BITS - 1)
                                 // ewah.WORD_BITS, dtype=np.uint32))


def _one_bitmap_size(indicator: np.ndarray, n_rows: int) -> int:
    """Exact EWAH word count of the bitmap set by ``indicator == 1``,
    without emitting the stream (O(n) vectorized run accounting via
    ``column_bitmap_sizes`` over the two-value indicator column)."""
    sizes, _, _ = column_bitmap_sizes(
        indicator, np.asarray([[0], [1]], dtype=np.int64), 2)
    return int(sizes[1])


class ColumnEncoding:
    """One column's bitmap representation + its predicate compiler.

    Concrete encodings expose:

    * ``kind`` — registry name (``"equality"`` / ``"bitsliced"`` /
      ``"bitsliced-gray"`` / ``"binned"``);
    * ``card`` / ``n_rows`` — the column's dense value domain and length;
    * ``streams`` — the per-bitmap EWAH uint32 arrays (None when built with
      ``materialize=False``) and ``sizes`` — their word counts;
    * ``compile_eq / compile_in / compile_range`` — emit plan nodes against
      a :class:`~repro.core.query.PlanContext`.  The planner has already
      clamped inputs to the domain: ``0 <= value < card``, ``values`` is a
      sorted non-empty in-domain tuple, ``0 <= lo <= hi < card``.
    """

    kind = "abstract"

    card: int
    n_rows: int
    streams: list | None
    sizes: np.ndarray

    @property
    def n_streams(self) -> int:
        return len(self.sizes)

    def size_words(self) -> int:
        return int(self.sizes.sum())

    def compile_eq(self, ctx, value: int):
        raise NotImplementedError

    def compile_in(self, ctx, values):
        return _or_node([self.compile_eq(ctx, v) for v in values])

    def compile_range(self, ctx, lo: int, hi: int):
        return self.compile_in(ctx, range(lo, hi + 1))


def _and_node(nodes):
    return nodes[0] if len(nodes) == 1 else ("and", tuple(nodes))


def _or_node(nodes):
    return nodes[0] if len(nodes) == 1 else ("or", tuple(nodes))


class EqualityEncoding(ColumnEncoding):
    """k-of-N value bitmaps (the paper's encoding, extracted).

    ``Eq`` is the AND of the value's k bitmaps, ``In``/``Range`` OR those
    fan-ins; a range wider than half the domain compiles through the
    compressed-domain complement (``Not(In(complement))`` — a marker-type
    flip, no densification) so its fan-in never exceeds card/2.
    """

    kind = "equality"

    def __init__(self, codes, N, k, sizes, streams, card, n_rows):
        self.codes = codes
        self.N = N
        self.k = k
        self.sizes = sizes
        self.streams = streams
        self.card = card
        self.n_rows = n_rows

    @classmethod
    def build(cls, col, card, hist, spec, materialize: bool = True):
        codes, N, k_eff = assign_codes(
            card, spec.k, spec.code_order, spec.resolved_value_policy(), hist)
        sizes, _, _ = column_bitmap_sizes(col, codes, N)
        streams = (_materialize_streams(col, codes, N, len(col))
                   if materialize else None)
        return cls(codes, N, k_eff, sizes, streams, card, len(col))

    def compile_eq(self, ctx, value: int):
        return _and_node([ctx.leaf(self.streams[int(b)])
                          for b in self.codes[value]])

    def compile_range(self, ctx, lo: int, hi: int):
        width = hi - lo + 1
        if width == self.card:
            return ctx.ones()
        # a range spanning more than half the domain compiles through the
        # compressed-domain complement: rows hold exactly one dense value
        # id, so Not(In(complement)) is exact and halves the OR fan-in
        if width > self.card - width:
            return ("not", self.compile_in(
                ctx, [*range(0, lo), *range(hi + 1, self.card)]))
        return self.compile_in(ctx, range(lo, hi + 1))


class RoaringEncoding(ColumnEncoding):
    """Roaring-style chunked containers, one container set per value.

    Each attribute value's row set is a :class:`~repro.core.containers.
    ContainerSet`: per aligned 2^16-row chunk, a sorted-array / bitmap /
    run container chosen by the Roaring cardinality/run-count thresholds
    at seal time (docs/containers.md).  ``Eq`` compiles to a single
    ``("cfold", ...)`` node, ``In``/``Range`` to a container-wise OR fold
    over the member values, and a range wider than half the domain goes
    through the compressed-domain complement exactly like the equality
    encoding.  Backends evaluate the fold container-wise — galloping
    array∩array / array∩bitmap intersection, batched word-space device
    merges — and lower the result to one canonical ``EwahStream`` leaf,
    so everything downstream of the plan root (caching, tombstones,
    fan-out, sanitizers) is unchanged.  Raw columns are not needed at
    query time (``keep_columns=False`` safe).
    """

    kind = "roaring"

    def __init__(self, csets, sizes, card, n_rows):
        self.csets = csets
        self.streams = csets  # non-None marks the column queryable
        self.sizes = sizes
        self.card = card
        self.n_rows = n_rows

    @classmethod
    def build(cls, col, card, hist, spec, materialize: bool = True):
        from . import containers
        order = np.argsort(col, kind="stable")
        sorted_vals = col[order]
        boundaries = np.flatnonzero(np.diff(sorted_vals)) + 1
        groups = np.split(order, boundaries)
        vals = (sorted_vals[np.concatenate(([0], boundaries))]
                if len(col) else [])
        pos_per_value = {int(v): g for v, g in zip(vals, groups)}
        empty = np.empty(0, dtype=np.int64)
        csets = [containers.from_positions(
            np.sort(pos_per_value.get(v, empty)), len(col))
            for v in range(card)]
        sizes = np.asarray([cs.size_words() for cs in csets],
                           dtype=np.int64)
        return cls(csets if materialize else None, sizes, card, len(col))

    def _cfold(self, ctx, csets):
        cids = tuple(ctx.container(cs) for cs in csets)
        est = int(sum(cs.size_words() for cs in csets))
        return ("cfold", ("or",) * (len(cids) - 1), cids, est)

    def compile_eq(self, ctx, value: int):
        return self._cfold(ctx, [self.csets[int(value)]])

    def compile_in(self, ctx, values):
        return self._cfold(ctx, [self.csets[int(v)] for v in values])

    def compile_range(self, ctx, lo: int, hi: int):
        width = hi - lo + 1
        if width == self.card:
            return ctx.ones()
        # same complement trick as EqualityEncoding: over half the domain,
        # fold the complement values and marker-flip the result
        if width > self.card - width:
            return ("not", self.compile_in(
                ctx, [*range(0, lo), *range(hi + 1, self.card)]))
        return self.compile_in(ctx, range(lo, hi + 1))


class BitSlicedEncoding(ColumnEncoding):
    """``m = ceil(log2(card))`` EWAH slice planes; ranges in O(m) merges.

    Plane i holds the rows whose (optionally Gray-coded) value has bit i
    set.  ``x >= c`` is the textbook slice comparison fold, processed
    lsb -> msb::

        G = plane[j]                   # j = lowest set bit of c
        for i in j+1 .. m-1:
            G = (G AND plane[i]) if c_i else (G OR plane[i])

    emitted as one ``("fold", ops, children)`` plan node — ``m - 1`` binary
    merges however wide the range; ``lo <= x <= hi`` is
    ``Geq(lo) AND NOT Geq(hi + 1)`` (<= ``2m`` merges total, vs up to
    card/2 ORs for the equality encoding).  With ``gray=True`` the circuit
    first decodes binary bit i as the XOR suffix of the Gray planes
    (``b_i = g_i ^ g_{i+1} ^ ... ^ g_{m-1}``), again as fold nodes.
    """

    kind = "bitsliced"

    def __init__(self, n_bits, gray, sizes, streams, card, n_rows):
        self.n_bits = n_bits
        self.gray = gray
        self.sizes = sizes
        self.streams = streams
        self.card = card
        self.n_rows = n_rows

    @classmethod
    def build(cls, col, card, hist, spec, materialize: bool = True,
              gray: bool = False):
        col = np.asarray(col)
        m = max(1, int(math.ceil(math.log2(card))) if card > 1 else 1)
        keys = to_gray(col).astype(np.uint64) if gray else \
            col.astype(np.uint64)
        bits = [((keys >> np.uint64(i)) & np.uint64(1)).astype(np.int64)
                for i in range(m)]
        if not materialize:
            # size-only: exact per-plane EWAH sizes without emitting
            # streams (index_size_report's contract) — each plane is the
            # "value 1" bitmap of its bit column
            sizes = np.asarray([_one_bitmap_size(b, len(col))
                                for b in bits], dtype=np.int64)
            return cls(m, gray, sizes, None, card, len(col))
        streams = [_positions_to_stream(np.flatnonzero(b), len(col))
                   for b in bits]
        sizes = np.asarray([len(s) for s in streams], dtype=np.int64)
        return cls(m, gray, sizes, streams, card, len(col))

    def _key(self, value: int) -> int:
        return int(to_gray(np.uint64(value))) if self.gray else int(value)

    def _bit_node(self, ctx, i: int):
        """Plan node for "binary bit i of the row's value is set".

        Gray mode re-emits the full XOR suffix per bit (plans are trees —
        no shared sub-expressions), so a Gray range circuit carries O(m^2)
        leaves vs the binary circuit's m; the numpy cached path dedups the
        suffixes in the result cache, but Gray planes remain the
        size-biased variant ('auto' never picks them, docs/encodings.md).
        """
        if not self.gray or i == self.n_bits - 1:
            return ctx.leaf(self.streams[i])
        children = tuple(ctx.leaf(self.streams[j])
                         for j in range(i, self.n_bits))
        return ("fold", ("xor",) * (len(children) - 1), children)

    def compile_eq(self, ctx, value: int):
        key = self._key(value)
        nodes = []
        for i in range(self.n_bits):
            leaf = ctx.leaf(self.streams[i])
            nodes.append(leaf if (key >> i) & 1 else ("not", leaf))
        return _and_node(nodes)

    def _geq_node(self, ctx, c: int):
        """Node for ``value >= c`` (``None`` = all rows, for c == 0)."""
        if c <= 0:
            return None
        j = (c & -c).bit_length() - 1            # lowest set bit of c
        children = [self._bit_node(ctx, j)]
        ops = []
        for i in range(j + 1, self.n_bits):
            ops.append("and" if (c >> i) & 1 else "or")
            children.append(self._bit_node(ctx, i))
        if not ops:
            return children[0]
        return ("fold", tuple(ops), tuple(children))

    def compile_range(self, ctx, lo: int, hi: int):
        lower = self._geq_node(ctx, lo)
        upper = (None if hi >= self.card - 1
                 else ("not", self._geq_node(ctx, hi + 1)))
        if lower is None and upper is None:
            return ctx.ones()
        if upper is None:
            return lower
        if lower is None:
            return upper
        return ("and", (lower, upper))

    def compile_in(self, ctx, values):
        # contiguous runs compile as O(log card) range circuits, isolated
        # values as plane-AND equalities
        values = list(values)
        nodes, start, prev = [], values[0], values[0]
        for v in values[1:] + [None]:
            if v is not None and v == prev + 1:
                prev = v
                continue
            if prev - start + 1 >= 3:
                nodes.append(self.compile_range(ctx, start, prev))
            else:
                nodes.extend(self.compile_eq(ctx, u)
                             for u in range(start, prev + 1))
            if v is not None:
                start = prev = v
        return _or_node(nodes)


class BitSlicedGrayEncoding(BitSlicedEncoding):
    kind = "bitsliced-gray"

    @classmethod
    def build(cls, col, card, hist, spec, materialize: bool = True):
        return super().build(col, card, hist, spec, materialize=materialize,
                             gray=True)


class BinnedEncoding(ColumnEncoding):
    """Histogram-equalized value bins + lazy candidate-check refinement.

    The value domain partitions into ``n_bins`` contiguous bins holding
    ~equal row counts (boundaries read off the cumulative histogram — the
    histogram-aware part), one EWAH bitmap per bin.  A range is the OR of
    its fully-covered bins plus one *exact* leaf for the partial boundary
    values (the binned literature's candidate check); ``Eq``/``In`` always
    refine — exact results on every backend.

    Refinement is a **lazy post-filter on the row-value surface**: the
    build keeps each row's value in sorted-row order (``_values``, one
    narrow integer per row — the row-id surface an exact candidate check
    needs, since bins merge values and the coarse bitmaps alone cannot
    tell boundary values apart) and each query materializes only its own
    boundary spans from it.  Nothing here reaches back into the segment's
    raw-column row store, so binned columns work unchanged on
    ``Segment.seal(keep_columns=False)`` segments (dist fan-out shards);
    the former value->rows CSR resolved the same spans from 2 int64 words
    per row of retained base data — 4x the memory — and silently pinned
    that base data to supposedly raw-column-free segments.

    ``sizes``/``size_words`` count only the compressed EWAH bin words, so
    binned sizes compare like-for-like against the other encodings'
    compressed footprints; the value surface is *base-data access*, the
    same role as a segment's retained ingest-order columns, and like those
    it is deliberately outside the compressed-size accounting
    (docs/encodings.md lists it as the encoding's extra state).
    """

    kind = "binned"

    def __init__(self, edges, sizes, streams, values, card, n_rows):
        self.edges = edges        # (n_bins + 1,) value boundaries
        self.sizes = sizes
        self.streams = streams
        self._values = values     # per-row values, sorted-row order
        self.card = card
        self.n_rows = n_rows

    @property
    def n_bins(self) -> int:
        return len(self.edges) - 1

    @classmethod
    def build(cls, col, card, hist, spec, materialize: bool = True):
        col = np.asarray(col)
        n_bins = max(2, min(64, int(round(math.sqrt(card)))))
        n_bins = min(n_bins, card)
        hist = np.asarray(hist, dtype=np.int64)
        cum = np.cumsum(hist)
        total = int(cum[-1]) if len(cum) else 0
        # histogram-equalized boundaries: split the cumulative mass evenly
        targets = total * np.arange(1, n_bins) / n_bins
        inner = np.searchsorted(cum, targets, side="left") + 1
        edges = np.unique(np.concatenate(([0], inner, [card])))
        edges = edges[edges <= card].astype(np.int64)
        bin_of = np.searchsorted(edges, np.arange(card), side="right") - 1
        if not materialize:
            # size-only: exact per-bin sizes from the bin-id column (one
            # identity-coded size pass, no streams, no CSR)
            sizes, _, _ = column_bitmap_sizes(
                bin_of[col], np.arange(len(edges) - 1,
                                       dtype=np.int64)[:, None],
                len(edges) - 1)
            return cls(edges, sizes, None, None, card, len(col))
        values = col.astype(np.int32 if card <= np.iinfo(np.int32).max
                            else np.int64)
        streams = []
        for b in range(len(edges) - 1):
            mask = (values >= edges[b]) & (values < edges[b + 1])
            streams.append(_positions_to_stream(np.flatnonzero(mask),
                                                len(col)))
        sizes = np.asarray([len(s) for s in streams], dtype=np.int64)
        return cls(edges, sizes, streams, values, card, len(col))

    def _exact_leaf(self, ctx, mask):
        """One leaf holding exactly the rows whose value-surface ``mask``
        is set — the lazy candidate-check refinement."""
        pos = np.flatnonzero(mask)
        if not len(pos):
            return ctx.zero()
        return ctx.leaf(_positions_to_stream(pos, self.n_rows))

    def compile_eq(self, ctx, value: int):
        return self._exact_leaf(ctx, self._values == value)

    def compile_in(self, ctx, values):
        return self._exact_leaf(
            ctx, np.isin(self._values,
                         np.asarray(values, dtype=self._values.dtype)))

    def compile_range(self, ctx, lo: int, hi: int):
        if lo == 0 and hi == self.card - 1:
            return ctx.ones()
        # fully-covered bins ship their coarse bitmaps as-is
        b_lo = int(np.searchsorted(self.edges, lo, side="right")) - 1
        b_hi = int(np.searchsorted(self.edges, hi, side="right")) - 1
        nodes, refine = [], None
        for b in range(b_lo, b_hi + 1):
            v0, v1 = int(self.edges[b]), int(self.edges[b + 1]) - 1
            if lo <= v0 and v1 <= hi:
                nodes.append(ctx.leaf(self.streams[b]))
            else:  # partial boundary bin -> candidate-check refinement
                s_lo, s_hi = max(lo, v0), min(hi, v1)
                span = (self._values >= s_lo) & (self._values <= s_hi)
                refine = span if refine is None else refine | span
        if refine is not None:
            nodes.append(self._exact_leaf(ctx, refine))
        return _or_node(nodes)


ENCODINGS: dict[str, type] = {
    EqualityEncoding.kind: EqualityEncoding,
    BitSlicedEncoding.kind: BitSlicedEncoding,
    BitSlicedGrayEncoding.kind: BitSlicedGrayEncoding,
    BinnedEncoding.kind: BinnedEncoding,
    RoaringEncoding.kind: RoaringEncoding,
}


def encoding_kinds() -> tuple:
    """The registered concrete encoding kinds (chooser return values)."""
    return tuple(sorted(ENCODINGS))


def build_encoding(kind: str, col, card, hist, spec,
                   materialize: bool = True) -> ColumnEncoding:
    """Construct one column's encoding by kind name (ValueError lists the
    registered kinds on a miss — e.g. an ``encoding`` strategy returning a
    name no encoding class claims)."""
    try:
        cls = ENCODINGS[kind]
    except KeyError:
        raise ValueError(
            f"unknown column encoding {kind!r}; registered: "
            f"{', '.join(encoding_kinds())}") from None
    return cls.build(col, card, hist, spec, materialize=materialize)


def _materialize_streams(col, codes, N, n_rows):
    """Per-bitmap compressed streams in O(n*k + sum of stream sizes)."""
    order = np.argsort(col, kind="stable")
    sorted_vals = col[order]
    # row positions per value, grouped
    boundaries = np.flatnonzero(np.diff(sorted_vals)) + 1
    groups = np.split(order, boundaries)
    vals = sorted_vals[np.concatenate(([0], boundaries))] if len(col) else []
    pos_per_value = {int(v): g for v, g in zip(vals, groups)}
    per_bitmap_positions = [[] for _ in range(N)]
    for v, pos in pos_per_value.items():
        for b in codes[v]:
            per_bitmap_positions[int(b)].append(pos)
    streams = []
    for plist in per_bitmap_positions:
        if plist:
            pos = np.sort(np.concatenate(plist))
            words = ewah.positions_to_words(pos, n_rows)
        else:
            words = np.zeros((n_rows + 31) // 32, dtype=np.uint32)
        streams.append(ewah.compress(words))
    return streams
