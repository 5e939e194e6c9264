"""Roaring-style chunked containers: array / bitmap / run per 2^16-row chunk.

The paper's EWAH bitmaps pick one representation for a whole column.  The
Roaring line of work (Chambi et al. 2014, "Better bitmap performance with
Roaring bitmaps"; Lemire et al. 2016, "Consistently faster and smaller
compressed bitmaps with Roaring") shows the consistent win comes from
choosing the representation **per aligned 2^16-row chunk**:

* ``array``   — sorted uint16 local positions; chosen for sparse chunks
  (at most :data:`ARRAY_MAX` = 4096 set rows, the classic boundary where a
  position list stops being smaller than a dense bitmap).
* ``bitmap``  — 2048 dense uint32 words (65536 bits); chosen for dense
  scattered chunks.
* ``run``     — sorted ``(start, end)`` inclusive intervals; chosen when
  ``2*runs + 1 < min(n, ARRAY_MAX)`` (the Roaring run-container rule), so
  long contiguous stretches — exactly what the paper's histogram-aware row
  ordering produces — coalesce to a handful of intervals.

A :class:`ContainerSet` is one compressed row set: parallel arrays of chunk
keys, container classes, and payloads.  Classes are re-chosen after every
merge, so ORing two adjacent run containers re-coalesces rather than
degrading to arrays.  The numpy merge path here is the streaming oracle a
device backend must match bit-for-bit (the torch backend's container fold
is not ported yet; see ROADMAP.md).  Container sets convert to the canonical
:class:`~repro.core.ewah_stream.EwahStream` word format via
:func:`to_stream` at plan roots, so caching, tombstone ANDs, fan-out
shipping, and the ``REPRO_SANITIZE=1`` validators never see a container.

Container-class dispatch is exhaustiveness-checked by
``repro.analysis.containercheck``: every function that branches on a class
constant must either cover all of :data:`CONTAINER_CLASSES` or end in a
``raise`` — an unknown class is a hard error, never a silent fall-through.
"""

from __future__ import annotations

import hashlib

import numpy as np

from . import ewah

CHUNK_BITS = 16
CHUNK_ROWS = 1 << CHUNK_BITS          # rows per aligned container chunk
CHUNK_WORDS = CHUNK_ROWS // ewah.WORD_BITS  # 2048 uint32 words per chunk
ARRAY_MAX = 4096                      # array/bitmap cardinality boundary

# Declared container classes — repro.analysis.containercheck requires every
# dispatch site to cover all of them (or raise).  Index into this tuple IS
# the class id stored in ContainerSet.classes.
CONTAINER_CLASSES = ("array", "bitmap", "run")
ARRAY, BITMAP, RUN = range(len(CONTAINER_CLASSES))

_MERGE_OPS = ("and", "or", "andnot")


class ContainerSet:
    """One compressed row set over ``n_rows`` rows as per-chunk containers.

    ``keys[i]`` is the aligned chunk index (``row >> 16``), ``classes[i]``
    the container class id, ``payloads[i]`` the class-specific numpy
    payload.  Chunks with no set rows are absent.  Instances are immutable
    by convention — every operation returns a new set.
    """

    __slots__ = ("n_rows", "keys", "classes", "payloads")

    def __init__(self, n_rows, keys, classes, payloads):
        self.n_rows = int(n_rows)
        self.keys = np.asarray(keys, dtype=np.int64)
        self.classes = np.asarray(classes, dtype=np.uint8)
        self.payloads = list(payloads)

    def __len__(self):
        return len(self.keys)

    def n_set(self) -> int:
        """Total number of set rows across all chunks."""
        return sum(int(chunk_cardinality(c, p))
                   for c, p in zip(self.classes, self.payloads))

    def size_words(self) -> int:
        """Serialized footprint in uint32 words (1 header word per chunk +
        the per-class payload cost in packed uint16 units)."""
        total = 0
        for c, p in zip(self.classes, self.payloads):
            total += 1 + (_chunk_cost_u16(int(c), p) + 1) // 2
        return total


def _chunk_cost_u16(cls: int, payload) -> int:
    """Payload cost in uint16 units (the Roaring accounting unit)."""
    if cls == ARRAY:
        return len(payload)
    if cls == BITMAP:
        return 2 * CHUNK_WORDS
    if cls == RUN:
        return 2 * len(payload) + 1
    raise ValueError(f"unknown container class {cls!r}")


def chunk_cardinality(cls: int, payload) -> int:
    """Number of set rows in one container."""
    if cls == ARRAY:
        return len(payload)
    if cls == BITMAP:
        return int(np.sum(np.unpackbits(payload.view(np.uint8))))
    if cls == RUN:
        return int(np.sum(payload[:, 1].astype(np.int64)
                          - payload[:, 0].astype(np.int64) + 1))
    raise ValueError(f"unknown container class {cls!r}")


def make_chunk(pos16: np.ndarray):
    """Choose the cheapest container class for sorted local positions.

    Implements the Roaring selection rule: run when ``2r + 1`` uint16 units
    undercut both alternatives, else array up to :data:`ARRAY_MAX`
    positions, else bitmap.  Returns ``(class_id, payload)``.
    """
    pos = np.asarray(pos16, dtype=np.int64)
    n = len(pos)
    if n == 0:
        raise ValueError("empty chunks are dropped, not stored")
    breaks = np.nonzero(np.diff(pos) > 1)[0]
    r = len(breaks) + 1
    if 2 * r + 1 < min(n, ARRAY_MAX):
        starts = pos[np.concatenate(([0], breaks + 1))]
        ends = pos[np.concatenate((breaks, [n - 1]))]
        return RUN, np.stack([starts, ends], axis=1).astype(np.uint16)
    if n <= ARRAY_MAX:
        return ARRAY, pos.astype(np.uint16)
    return BITMAP, ewah.positions_to_words(pos, CHUNK_ROWS)


def chunk_positions(cls: int, payload) -> np.ndarray:
    """Expand one container to sorted local int64 positions."""
    if cls == ARRAY:
        return payload.astype(np.int64)
    if cls == BITMAP:
        bits = ewah.unpack_bits(payload, CHUNK_ROWS)
        return np.nonzero(bits)[0].astype(np.int64)
    if cls == RUN:
        starts = payload[:, 0].astype(np.int64)
        ends = payload[:, 1].astype(np.int64)
        return np.concatenate(
            [np.arange(s, e + 1, dtype=np.int64)
             for s, e in zip(starts, ends)]) if len(payload) else \
            np.empty(0, dtype=np.int64)
    raise ValueError(f"unknown container class {cls!r}")


def chunk_words(cls: int, payload) -> np.ndarray:
    """Expand one container to its dense 2048-word uint32 form."""
    if cls == BITMAP:
        return payload
    if cls == ARRAY or cls == RUN:
        return ewah.positions_to_words(chunk_positions(cls, payload),
                                       CHUNK_ROWS)
    raise ValueError(f"unknown container class {cls!r}")


def from_positions(positions: np.ndarray, n_rows: int) -> ContainerSet:
    """Build a :class:`ContainerSet` from sorted global row positions."""
    pos = np.asarray(positions, dtype=np.int64)
    if len(pos) and (pos[0] < 0 or pos[-1] >= n_rows):
        raise ValueError("positions out of range")
    keys, classes, payloads = [], [], []
    if len(pos):
        chunk_ids = pos >> CHUNK_BITS
        bounds = np.nonzero(np.diff(chunk_ids))[0] + 1
        for local in np.split(pos, bounds):
            keys.append(int(local[0]) >> CHUNK_BITS)
            cls, payload = make_chunk(local & (CHUNK_ROWS - 1))
            classes.append(cls)
            payloads.append(payload)
    return ContainerSet(n_rows, keys, classes, payloads)


def to_positions(cs: ContainerSet) -> np.ndarray:
    """Expand a container set to sorted global int64 row positions."""
    parts = [chunk_positions(int(c), p) + (int(k) << CHUNK_BITS)
             for k, c, p in zip(cs.keys, cs.classes, cs.payloads)]
    return (np.concatenate(parts) if parts
            else np.empty(0, dtype=np.int64))


def to_words(cs: ContainerSet) -> np.ndarray:
    """Expand a container set to the dense uint32 word array covering
    ``n_rows`` rows (the EWAH pre-compression form)."""
    n_words = (cs.n_rows + ewah.WORD_BITS - 1) // ewah.WORD_BITS
    words = np.zeros(n_words, dtype=np.uint32)
    for k, c, p in zip(cs.keys, cs.classes, cs.payloads):
        off = int(k) * CHUNK_WORDS
        cw = chunk_words(int(c), p)
        words[off:off + CHUNK_WORDS] = cw[:max(0, n_words - off)]
    return words


def to_stream(cs: ContainerSet) -> np.ndarray:
    """Canonical EWAH stream of the container set (the plan-root bridge:
    everything downstream — caches, tombstone ANDs, fan-out, sanitizers —
    sees only this)."""
    return ewah.compress(to_words(cs))


def digest(cs: ContainerSet) -> bytes:
    """Stable content digest (cache key for lowered container folds)."""
    h = hashlib.blake2b(digest_size=12)
    h.update(np.int64(cs.n_rows).tobytes())
    h.update(cs.keys.tobytes())
    h.update(cs.classes.tobytes())
    for p in cs.payloads:
        h.update(np.ascontiguousarray(p).tobytes())
    return h.digest()


def gallop_intersect(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersect two sorted position arrays by galloping the smaller one
    into the larger (each probe is an exponential/binary search — O(n log
    m) instead of the O(n + m) linear merge, the Roaring array∩array
    kernel)."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    if len(a) > len(b):
        a, b = b, a
    if not len(a) or not len(b):
        return np.empty(0, dtype=np.int64)
    idx = np.searchsorted(b, a)
    hit = idx < len(b)
    hit[hit] = b[idx[hit]] == a[hit]
    return a[hit]


def array_bitmap_intersect(pos: np.ndarray, words: np.ndarray) -> np.ndarray:
    """Galloping array∩bitmap: each position jumps straight to its word
    (``pos >> 5``) and tests one bit — no scan of the dense side."""
    pos = np.asarray(pos, dtype=np.int64)
    looked = words[pos >> 5]
    hit = (looked >> (pos & 31).astype(np.uint32)) & np.uint32(1)
    return pos[hit.astype(bool)]


def _merge_chunk(cls_a: int, pa, cls_b: int, pb, op: str):
    """Merge two same-chunk containers; returns ``(class, payload)`` with
    the class re-chosen, or ``None`` for an empty result."""
    if op == "and" and cls_a == ARRAY and cls_b == BITMAP:
        out = array_bitmap_intersect(chunk_positions(cls_a, pa), pb)
    elif op == "and" and cls_a == BITMAP and cls_b == ARRAY:
        out = array_bitmap_intersect(chunk_positions(cls_b, pb), pa)
    elif op == "and" and cls_a == ARRAY and cls_b == ARRAY:
        out = gallop_intersect(pa, pb)
    elif cls_a == BITMAP and cls_b == BITMAP:
        if op == "and":
            wa = pa & pb
        elif op == "or":
            wa = pa | pb
        elif op == "andnot":
            wa = pa & ~pb
        else:
            raise ValueError(f"unknown container merge op {op!r}")
        bits = ewah.unpack_bits(wa, CHUNK_ROWS)
        out = np.nonzero(bits)[0].astype(np.int64)
    else:
        # Mixed/run general path: expand both sides to positions.
        a = chunk_positions(cls_a, pa)
        b = chunk_positions(cls_b, pb)
        if op == "and":
            out = gallop_intersect(a, b)
        elif op == "or":
            out = np.union1d(a, b)
        elif op == "andnot":
            out = np.setdiff1d(a, b, assume_unique=True)
        else:
            raise ValueError(f"unknown container merge op {op!r}")
    if not len(out):
        return None
    return make_chunk(out)


def merge(a: ContainerSet, b: ContainerSet, op: str) -> ContainerSet:
    """Container-wise logical merge (``"and"``, ``"or"``, ``"andnot"``).

    Chunks present on only one side short-circuit by op semantics; chunk
    pairs dispatch per container class (galloping for array∩array and
    array∩bitmap, word ops for bitmap∩bitmap, positional expansion
    otherwise) and the result class is re-chosen per chunk.
    """
    if op not in _MERGE_OPS:
        raise ValueError(f"unknown container merge op {op!r}")
    if a.n_rows != b.n_rows:
        raise ValueError("container sets cover different row spans")
    keys, classes, payloads = [], [], []
    ia = ib = 0
    while ia < len(a) or ib < len(b):
        ka = int(a.keys[ia]) if ia < len(a) else None
        kb = int(b.keys[ib]) if ib < len(b) else None
        if kb is None or (ka is not None and ka < kb):
            if op in ("or", "andnot"):  # right side absent: keep left
                keys.append(ka)
                classes.append(int(a.classes[ia]))
                payloads.append(a.payloads[ia])
            ia += 1
        elif ka is None or kb < ka:
            if op == "or":  # left side absent: keep right
                keys.append(kb)
                classes.append(int(b.classes[ib]))
                payloads.append(b.payloads[ib])
            ib += 1
        else:
            merged = _merge_chunk(int(a.classes[ia]), a.payloads[ia],
                                  int(b.classes[ib]), b.payloads[ib], op)
            if merged is not None:
                keys.append(ka)
                classes.append(merged[0])
                payloads.append(merged[1])
            ia += 1
            ib += 1
    return ContainerSet(a.n_rows, keys, classes, payloads)


def fold(csets, ops, n_rows: int) -> np.ndarray:
    """Left-fold container sets through ``ops`` and return the canonical
    EWAH stream — the numpy streaming evaluator for ``("cfold", ...)``
    plan nodes (a device backend's batched counterpart must match this
    bit-for-bit)."""
    if not csets:
        return ewah.compress(
            np.zeros((n_rows + ewah.WORD_BITS - 1) // ewah.WORD_BITS,
                     dtype=np.uint32))
    acc = csets[0]
    for op, nxt in zip(ops, csets[1:]):
        acc = merge(acc, nxt, op)
    return to_stream(acc)
