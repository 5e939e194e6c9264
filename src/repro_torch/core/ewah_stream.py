"""The compressed-domain stream engine: one public cursor/appender core.

Every layer that touches EWAH streams — the numpy logical ops, the query
backends' compressed execution path, the dist-shard result merge — runs on
the same two primitives defined here:

  * :class:`Cursor`   — iterates a compressed stream as
    (clean_rem, ctype, dirty_rem) runs without decompressing;
  * :class:`Appender` — re-compresses words/runs fed to it, coalescing
    adjacent clean runs of equal type.

On top of them:

  * :func:`logical_op` / :func:`logical_many` — the paper's §3 streaming
    merges, O(|A| + |B|) in *compressed* words;
  * :func:`logical_not` — compressed-domain complement by *marker-type
    flipping*: clean runs flip their type bit, verbatim words complement in
    place.  One pass over the stream itself; the dense n/32-word complement
    is never materialized (a dirty word's complement is still dirty, so the
    output has exactly the input's run structure);
  * :func:`concat_streams` — bit-concatenation of word-aligned streams with
    clean-run coalescing across the seams (the dist-shard merge protocol);
  * :class:`EwahStream` — the compressed result value object the query
    backends' ``execute_compressed`` returns.

The dual-cursor walk (:func:`and_popcount`, :func:`and_popcount_many`)
is the reference's in-graph ``lax.while_loop`` as a batch of walks on
the card, one thread a stream pair (the ``ewah_and_popcount`` kernel),
with the reference's iteration count.

``ewah.py`` keeps the codec primitives (compress / decompress / marker
arithmetic) and re-exports the names below for backwards compatibility.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from .ewah import (FULL, MAX_CLEAN, MAX_DIRTY, WORD_BITS, _emit_group,
                   unpack_marker)

__all__ = [
    "Cursor", "Appender", "EwahStream", "EwahValidationError",
    "logical_op", "logical_many", "logical_not", "concat_streams",
    "and_popcount", "and_popcount_many", "pack_pairs",
]


class EwahValidationError(ValueError):
    """An EWAH stream violated the structural/canonical-form contract."""


# Wire format (little-endian, 24-byte header + payload):
#   magic   4s   b"EWAH"
#   version u16  1
#   flags   u16  0 (reserved)
#   n_rows  u64  rows the stream covers
#   n_words u32  compressed stream words that follow
#   crc     u32  CRC-32 of the payload bytes
#   payload n_words * 4 bytes of uint32 stream words
_WIRE_MAGIC = b"EWAH"
_WIRE_VERSION = 1
_WIRE_HEADER = struct.Struct("<4sHHQII")


class Cursor:
    """Iterates a compressed stream as (clean_rem, ctype, dirty_rem) runs.

    ``scanned`` counts compressed words visited — the paper's
    machine-independent query cost.
    """

    __slots__ = ("s", "i", "clean_rem", "ctype", "dirty_rem", "scanned")

    def __init__(self, stream: np.ndarray):
        self.s = np.asarray(stream, dtype=np.uint32)
        self.i = 0
        self.clean_rem = 0
        self.ctype = 0
        self.dirty_rem = 0
        self.scanned = 0
        self._load()

    def _load(self) -> None:
        while (
            self.clean_rem == 0
            and self.dirty_rem == 0
            and self.i < len(self.s)
        ):
            self.ctype, self.clean_rem, self.dirty_rem = unpack_marker(self.s[self.i])
            self.i += 1
            self.scanned += 1

    def exhausted(self) -> bool:
        return self.clean_rem == 0 and self.dirty_rem == 0 and self.i >= len(self.s)

    def take_clean(self, n: int) -> None:
        self.clean_rem -= n
        self._load()

    def take_dirty(self) -> int:
        w = int(self.s[self.i])
        self.i += 1
        self.scanned += 1
        self.dirty_rem -= 1
        self._load()
        return w

    def skip_dirty(self, n: int) -> None:
        self.i += n
        self.scanned += n
        self.dirty_rem -= n
        self._load()


class Appender:
    """Re-compresses a stream of words/runs fed to it.

    Adjacent clean runs of equal type merge; words that classify as clean
    (0x0 / 0xFFFFFFFF) join clean runs even when fed through ``add_word`` —
    so feeding one stream's runs through an Appender canonicalizes it.
    """

    def __init__(self):
        self.out: list[int] = []
        self.ctype = 0
        self.n_clean = 0
        self.dirty: list[int] = []
        self.n_words = 0  # uncompressed words represented so far

    def _flush(self) -> None:
        if self.n_clean or self.dirty:
            _emit_group(self.out, self.ctype, self.n_clean,
                        np.asarray(self.dirty, dtype=np.uint32))
            self.ctype, self.n_clean, self.dirty = 0, 0, []

    def add_clean(self, ctype: int, n: int) -> None:
        if n == 0:
            return
        if self.dirty or (self.n_clean and self.ctype != ctype):
            self._flush()
        self.ctype = ctype
        self.n_clean += n
        self.n_words += n

    def add_word(self, w: int) -> None:
        if w == 0:
            self.add_clean(0, 1)
        elif w == 0xFFFFFFFF:
            self.add_clean(1, 1)
        else:
            self.dirty.append(w)
            self.n_words += 1

    def add_cursor(self, cur: Cursor) -> None:
        """Drain a cursor into this appender run-at-a-time (coalescing)."""
        while not cur.exhausted():
            if cur.clean_rem:
                n = cur.clean_rem
                self.add_clean(cur.ctype, n)
                cur.take_clean(n)
            else:
                self.add_word(cur.take_dirty())

    def finish(self) -> np.ndarray:
        self._flush()
        if not self.out:
            self.out.append(0)  # make_marker(0, 0, 0)
        return np.asarray(self.out, dtype=np.uint32)


@dataclass(frozen=True, eq=False)
class EwahStream:
    """A compressed query result: EWAH words + the row count they cover.

    The value object ``execute_compressed`` returns and the dist fan-out
    ships between shards.  ``data`` encodes exactly
    ``ceil(n_rows / 32)`` uncompressed words; bits at positions >= n_rows
    (the final word's padding) are unspecified and truncated by the
    row-materializing accessors.

    Equality/hash are by content (stream words + row count;
    ``words_scanned`` is a measurement, not identity) — the generated
    dataclass comparison would choke on the ndarray field.
    """

    data: np.ndarray
    n_rows: int
    words_scanned: int = field(default=0, compare=False)

    def __eq__(self, other):
        if not isinstance(other, EwahStream):
            return NotImplemented
        return (self.n_rows == other.n_rows
                and np.array_equal(self.data, other.data))

    def __hash__(self):
        return hash((self.n_rows,
                     np.asarray(self.data, dtype=np.uint32).tobytes()))

    @property
    def n_words(self) -> int:
        return (self.n_rows + WORD_BITS - 1) // WORD_BITS

    def __len__(self) -> int:
        return len(self.data)

    def to_words(self) -> np.ndarray:
        from . import ewah

        return ewah.decompress(self.data, self.n_words)

    def to_bits(self) -> np.ndarray:
        from . import ewah

        return ewah.unpack_bits(self.to_words(), self.n_rows)

    def to_rows(self) -> np.ndarray:
        return np.flatnonzero(self.to_bits())

    def validate(self, *, dense_check: bool = True, origin: str = ""):
        """Assert the stream is well-formed *canonical* EWAH; returns self.

        Structural: begins with a marker, every marker's verbatim words
        are present, decoded word count equals ``ceil(n_rows / 32)`` (the
        word-alignment contract).  Canonical form: verbatim words are
        never 0x0/0xFFFFFFFF, adjacent same-type clean runs are coalesced
        (the ``concat_streams`` seam contract), dirty runs are split
        across markers only at MAX_DIRTY, clean runs only at MAX_CLEAN,
        and the empty marker appears only as the sole word of a zero-row
        stream.  With ``dense_check`` the compressed-domain :meth:`count`
        must agree with the dense popcount.

        The ``REPRO_SANITIZE=1`` backends call this on every
        ``execute_compressed`` result; raises
        :class:`EwahValidationError`.
        """

        def fail(i, msg):
            where = f"{origin}: " if origin else ""
            raise EwahValidationError(
                f"{where}word {i}: {msg} "
                f"(n_rows={self.n_rows}, {len(self.data)} stream words)")

        data = np.asarray(self.data)
        if data.ndim != 1 or data.dtype != np.uint32:
            fail(0, f"stream must be 1-D uint32, got "
                    f"{data.dtype} ndim={data.ndim}")
        n_words = self.n_words
        if len(data) == 0:
            if n_words:
                fail(0, "empty stream for a non-empty bitmap")
            return self

        total = 0
        i = 0
        prev = None  # (ctype, n_clean, n_dirty) of the previous marker
        while i < len(data):
            ctype, n_clean, n_dirty = unpack_marker(data[i])
            if n_clean == 0 and n_dirty == 0:
                if len(data) > 1 or n_words or int(data[i]) != 0:
                    fail(i, "empty marker inside a stream (legal only as "
                            "the sole word of a zero-row stream)")
            if prev is not None:
                p_type, p_clean, p_dirty = prev
                if p_dirty == 0 and p_clean < MAX_CLEAN:
                    if n_clean > 0 and p_clean > 0 and ctype == p_type:
                        fail(i, f"uncoalesced clean runs (type {ctype}: "
                                f"{p_clean} then {n_clean})")
                    if n_clean == 0 and n_dirty > 0:
                        fail(i, "dirty run split from a marker with spare "
                                "capacity")
                elif 0 < p_dirty < MAX_DIRTY and n_clean == 0 and n_dirty:
                    fail(i, f"dirty continuation after a non-full dirty "
                            f"run ({p_dirty} < {MAX_DIRTY})")
            if i + 1 + n_dirty > len(data):
                fail(i, f"marker claims {n_dirty} verbatim words, only "
                        f"{len(data) - i - 1} remain")
            seg = data[i + 1 : i + 1 + n_dirty]
            if n_dirty and bool(((seg == 0) | (seg == FULL)).any()):
                j = int(np.flatnonzero((seg == 0) | (seg == FULL))[0])
                fail(i + 1 + j, "verbatim word is 0x0/0xFFFFFFFF (must be "
                                "encoded as a clean run)")
            total += n_clean + n_dirty
            prev = (ctype, n_clean, n_dirty)
            i += 1 + n_dirty
        if total != n_words:
            fail(len(data) - 1,
                 f"stream decodes {total} words, bitmap needs {n_words}")
        if dense_check and self.n_rows:
            dense = int(self.to_bits().sum())
            got = self.count()
            if dense != got:
                fail(0, f"compressed popcount {got} != dense popcount "
                        f"{dense}")
        return self

    def count(self) -> int:
        """Popcount of the valid bits (rows matching), compressed-domain:
        clean-1 runs count 32*n without expansion; only dirty words and the
        final padded word are inspected."""
        total = 0
        pos = 0  # uncompressed word position
        cur = Cursor(self.data)
        last = self.n_words - 1
        tail_bits = self.n_rows - last * WORD_BITS
        tail_mask = (1 << tail_bits) - 1 if self.n_rows else 0
        while not cur.exhausted():
            if cur.clean_rem:
                n = cur.clean_rem
                if cur.ctype:
                    total += n * WORD_BITS
                    if pos + n - 1 == last:
                        total -= WORD_BITS - tail_bits
                pos += n
                cur.take_clean(n)
            else:
                w = cur.take_dirty()
                if pos == last:
                    w &= tail_mask
                total += bin(w).count("1")
                pos += 1
        return total

    def to_bytes(self) -> bytes:
        """Serialize for the wire: versioned little-endian header + CRC +
        the compressed stream words, never the dense bitmap.  The inverse
        of :meth:`from_bytes`."""
        payload = np.ascontiguousarray(
            np.asarray(self.data, dtype=np.uint32)).astype(
                "<u4", copy=False).tobytes()
        header = _WIRE_HEADER.pack(
            _WIRE_MAGIC, _WIRE_VERSION, 0, self.n_rows,
            len(self.data), zlib.crc32(payload))
        return header + payload

    @classmethod
    def from_bytes(cls, buf: bytes) -> "EwahStream":
        """Deserialize a :meth:`to_bytes` buffer.

        Always checks magic/version/length/CRC; under ``REPRO_SANITIZE=1``
        additionally runs the full canonical-form :meth:`validate` walk on
        the decoded stream.  Raises :class:`EwahValidationError` on any
        mismatch.
        """
        if len(buf) < _WIRE_HEADER.size:
            raise EwahValidationError(
                f"wire buffer truncated: {len(buf)} bytes < "
                f"{_WIRE_HEADER.size}-byte header")
        magic, version, _flags, n_rows, n_words, crc = _WIRE_HEADER.unpack_from(buf)
        if magic != _WIRE_MAGIC:
            raise EwahValidationError(f"bad wire magic {magic!r}")
        if version != _WIRE_VERSION:
            raise EwahValidationError(
                f"unsupported wire version {version} (expected "
                f"{_WIRE_VERSION})")
        payload = buf[_WIRE_HEADER.size:]
        if len(payload) != n_words * 4:
            raise EwahValidationError(
                f"wire payload is {len(payload)} bytes, header claims "
                f"{n_words} words ({n_words * 4} bytes)")
        if zlib.crc32(payload) != crc:
            raise EwahValidationError(
                f"wire CRC mismatch (header {crc:#010x}, payload "
                f"{zlib.crc32(payload):#010x})")
        data = np.frombuffer(payload, dtype="<u4").astype(np.uint32,
                                                          copy=False)
        stream = cls(data=data, n_rows=n_rows)
        from ..analysis.runtime import sanitize_enabled

        if sanitize_enabled():
            stream.validate(origin="EwahStream.from_bytes")
        return stream


# ---------------------------------------------------------------------------
# Streaming logical operations (compressed domain, O(|A| + |B|)).
# ---------------------------------------------------------------------------

_OPS = {
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b,
}
# (op, clean_type) -> clean run dominates (result is clean of known type)
_DOMINATES = {("and", 0): 0, ("or", 1): 1}


def logical_op(a: np.ndarray, b: np.ndarray, op: str = "and"):
    """Streaming merge of two EWAH streams; returns (stream, words_scanned).

    Never decompresses: runs are consumed run-at-a-time so the work is
    O(|a| + |b|) in *compressed* words (the paper's Section 3 claim).
    """
    fn = _OPS[op]
    ca, cb = Cursor(a), Cursor(b)
    res = Appender()
    while not ca.exhausted() and not cb.exhausted():
        if ca.clean_rem and cb.clean_rem:
            n = min(ca.clean_rem, cb.clean_rem)
            ta = fn(ca.ctype, cb.ctype) & 1
            res.add_clean(ta, n)
            ca.take_clean(n)
            cb.take_clean(n)
        elif ca.clean_rem or cb.clean_rem:
            clean, other = (ca, cb) if ca.clean_rem else (cb, ca)
            n = min(clean.clean_rem, other.dirty_rem)
            dom = _DOMINATES.get((op, clean.ctype))
            if dom is not None:
                res.add_clean(dom, n)
                other.skip_dirty(n)
            else:
                pat = 0xFFFFFFFF if clean.ctype else 0
                for _ in range(n):
                    res.add_word(fn(other.take_dirty(), pat) & 0xFFFFFFFF)
            clean.take_clean(n)
        else:  # both dirty
            n = min(ca.dirty_rem, cb.dirty_rem)
            for _ in range(n):
                res.add_word(fn(ca.take_dirty(), cb.take_dirty()) & 0xFFFFFFFF)
    # tail: the paper's bitmaps all have equal (uncompressed) length; if one
    # stream ends early the remainder ops against implicit zeros.
    for tail in (ca, cb):
        while not tail.exhausted():
            if tail.clean_rem:
                n = tail.clean_rem
                t = fn(tail.ctype, 0) & 1
                res.add_clean(t, n)
                tail.take_clean(n)
            else:
                w = tail.take_dirty()
                res.add_word(fn(w, 0) & 0xFFFFFFFF)
    return res.finish(), ca.scanned + cb.scanned


def logical_many(streams, op: str = "and"):
    """Fold ``op`` over many compressed bitmaps; returns (stream, scanned).

    ``and``/``or`` fold smallest-pair-first through a min-heap on actual
    compressed sizes (the paper's smallest-streams-first cost model);
    ``xor`` — associative and commutative but size-agnostic (a xor can grow
    past both inputs) — folds the same way, which keeps one code path for
    all three ops instead of the former binary-only left fold.
    """
    import heapq

    assert streams
    if len(streams) == 1:
        return np.asarray(streams[0], dtype=np.uint32), 0
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}; supported: {', '.join(_OPS)}")
    heap = [(len(s), i, s) for i, s in enumerate(streams)]
    heapq.heapify(heap)
    tiebreak = len(heap)
    total = 0
    while len(heap) > 1:
        _, _, a = heapq.heappop(heap)
        _, _, b = heapq.heappop(heap)
        r, scanned = logical_op(a, b, op)
        total += scanned
        heapq.heappush(heap, (len(r), tiebreak, r))
        tiebreak += 1
    return heap[0][2], total


def logical_not(stream: np.ndarray, n_words: int | None = None):
    """Compressed-domain complement; returns (stream, words_scanned).

    Marker-type flipping: every clean run re-emits with its type bit
    flipped, every verbatim word complements in place (a dirty word's
    complement is neither 0x0 nor 0xFFFFFFFF, so it stays dirty).  One pass
    over the compressed words — the dense complement is never materialized
    and the output has exactly the input's run structure (same size).

    ``n_words`` pads a short stream's implicit zero tail to clean-1s so the
    complement covers the full bitmap length.
    """
    cur = Cursor(stream)
    res = Appender()
    while not cur.exhausted():
        if cur.clean_rem:
            n = cur.clean_rem
            res.add_clean(1 - cur.ctype, n)
            cur.take_clean(n)
        else:
            res.add_word(~cur.take_dirty() & 0xFFFFFFFF)
    if n_words is not None and res.n_words < n_words:
        res.add_clean(1, n_words - res.n_words)
    return res.finish(), cur.scanned


def concat_streams(parts) -> np.ndarray:
    """Bit-concatenate compressed streams with clean-run coalescing.

    ``parts`` is an iterable of EWAH uint32 arrays.  Every part except the
    last must cover a multiple-of-32 rows (word alignment — the dist
    fan-out's shard splitter guarantees it), so concatenating in word space
    is concatenating in row space.  Runs feed through one shared
    :class:`Appender`, so a clean run ending one shard and starting the next
    merges into a single marker ("concatenation with clean-run coalescing",
    the shard merge protocol).
    """
    res = Appender()
    for s in parts:
        res.add_cursor(Cursor(s))
    if not res.n_words:
        # canonical empty: byte-identical to ewah.compress of zero words,
        # so concatenating any all-empty partition equals the whole
        return np.zeros(0, dtype=np.uint32)
    return res.finish()


# ---------------------------------------------------------------------------
# Dual-cursor AND-popcount walk (the ewah_and_popcount kernel).
# ---------------------------------------------------------------------------


def _stream_words(s) -> np.ndarray:
    """A stream as uint32 words, from numpy or a torch tensor (int32 bit
    views included)."""
    if hasattr(s, "detach"):
        s = s.detach().cpu().numpy()
    return np.asarray(s).astype(np.uint32, copy=False).reshape(-1)


def pack_pairs(pairs, device=None):
    """``pairs`` of ``(sa, la, sb, lb)`` as the kernel's batch: ``(sa, la,
    na, sb, lb, nb)`` tensors on ``device`` (None: the CUDA device) —
    the streams right-padded into (B, Ca) and (B, Cb) int32 rows, their
    lengths, and their arrays' own sizes."""
    import torch

    from .query import _resolve_device

    dev = _resolve_device(device)
    a = [_stream_words(p[0]) for p in pairs]
    b = [_stream_words(p[2]) for p in pairs]

    def rows(streams):
        out = np.zeros((len(streams), max([len(s) for s in streams] + [1])),
                       dtype=np.uint32)
        for row, s in zip(out, streams):
            row[: len(s)] = s
        return torch.from_numpy(out.view(np.int32)).to(dev)

    def ints(values):
        return torch.tensor([int(v) for v in values], dtype=torch.int32,
                            device=dev)

    return (rows(a), ints(p[1] for p in pairs), ints(len(s) for s in a),
            rows(b), ints(p[3] for p in pairs), ints(len(s) for s in b))


def and_popcount_many(pairs, device=None):
    """Popcount of (A AND B) for many stream pairs, all on the card at once.

    ``pairs`` holds ``(sa, la, sb, lb)`` tuples: two EWAH streams (numpy
    arrays or tensors) and their lengths.  Counts and iteration counts are
    the reference walk's: it consumes at least one compressed word (or one
    clean-run overlap) a step and is capped at ``len(sa) + len(sb) + 4``
    steps, the arrays' own sizes.  Short streams take one launch (a thread
    walks a pair); wide rows take two, which sum each pair's count and
    steps over its words in parallel (``kernels/ops.py``
    ``ewah_and_popcount``).  Streams of a pair must
    encode the same number of words.  ``device=None`` is the CUDA device
    and raises where there is none; ``device="cpu"`` walks with the plain
    version.  Returns ``(counts, iterations)``, int64 arrays.
    """
    from ..kernels import ops

    counts, iters = ops.ewah_and_popcount(*pack_pairs(pairs, device))
    return (counts.cpu().numpy().astype(np.int64),
            iters.cpu().numpy().astype(np.int64))


def and_popcount(sa, la, sb, lb, device=None):
    """Popcount of (A AND B) over two EWAH streams (uint32 words or their
    int32 bit-views, with their lengths), by the reference's dual-cursor
    walk; returns ``(count, iterations)`` as ints.  The iteration count is
    the reference's: at most ``|A| + |B| + 4``, the paper's §3
    O(|A| + |B|) claim.  See :func:`and_popcount_many` for ``device``."""
    counts, iters = and_popcount_many([(sa, la, sb, lb)], device=device)
    return int(counts[0]), int(iters[0])
