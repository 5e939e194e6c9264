"""EWAH (Enhanced Word-Aligned Hybrid) bitmap compression — numpy reference.

Format (paper Fig. 1, 32-bit words):
  * verbatim ("dirty") words: 32 literal bitmap bits;
  * marker words: bit 31 = clean type (0 -> 0x00000000 runs, 1 -> 0xFFFFFFFF
    runs), bits 30..15 = number of clean words (16 bits), bits 14..0 = number
    of verbatim words that follow the marker (15 bits).
  A compressed stream always begins with a marker word.

This module is the *oracle*: simple, obviously-correct numpy/python code that
the torch implementation (``ewah_torch.py``) and the CUDA kernels are tested
against.  It is also used directly by the paper-table benchmarks, where the
numbers of interest are compressed sizes, not device throughput.
"""

from __future__ import annotations

import numpy as np

WORD_BITS = 32
FULL = np.uint32(0xFFFFFFFF)
MAX_CLEAN = (1 << 16) - 1  # per-marker clean-run capacity
MAX_DIRTY = (1 << 15) - 1  # per-marker verbatim-count capacity


def make_marker(clean_type: int, n_clean: int, n_dirty: int) -> int:
    assert 0 <= n_clean <= MAX_CLEAN and 0 <= n_dirty <= MAX_DIRTY
    return (int(clean_type) << 31) | (int(n_clean) << 15) | int(n_dirty)


def unpack_marker(word: int):
    word = int(word)
    return (word >> 31) & 1, (word >> 15) & 0xFFFF, word & 0x7FFF


def _emit_group(out: list, ctype: int, n_clean: int, dirty: np.ndarray) -> None:
    """Append markers + verbatim words for one (clean-run, dirty-run) group."""
    n_dirty = len(dirty)
    # clean overflow markers (no dirty words attached)
    while n_clean > MAX_CLEAN:
        out.append(make_marker(ctype, MAX_CLEAN, 0))
        n_clean -= MAX_CLEAN
    # first dirty chunk rides on the last clean marker
    chunk = min(n_dirty, MAX_DIRTY)
    out.append(make_marker(ctype, n_clean, chunk))
    out.extend(int(w) for w in dirty[:chunk])
    done = chunk
    while done < n_dirty:
        chunk = min(n_dirty - done, MAX_DIRTY)
        out.append(make_marker(0, 0, chunk))
        out.extend(int(w) for w in dirty[done : done + chunk])
        done += chunk


def compress(words: np.ndarray) -> np.ndarray:
    """Compress an array of uint32 bitmap words into an EWAH stream."""
    words = np.asarray(words, dtype=np.uint32)
    n = len(words)
    out: list[int] = []
    i = 0
    while i < n:
        ctype, n_clean = 0, 0
        if words[i] == 0 or words[i] == FULL:
            ctype = 1 if words[i] == FULL else 0
            pat = FULL if ctype else np.uint32(0)
            j = i
            while j < n and words[j] == pat:
                j += 1
            n_clean = j - i
            i = j
        j = i
        while j < n and words[j] != 0 and words[j] != FULL:
            j += 1
        _emit_group(out, ctype, n_clean, words[i:j])
        i = j
    return np.asarray(out, dtype=np.uint32)


def decompress(stream: np.ndarray, n_words: int | None = None) -> np.ndarray:
    """Expand an EWAH stream back into uint32 bitmap words."""
    stream = np.asarray(stream, dtype=np.uint32)
    out: list[int] = []
    i = 0
    while i < len(stream):
        ctype, n_clean, n_dirty = unpack_marker(stream[i])
        i += 1
        out.extend([0xFFFFFFFF if ctype else 0] * n_clean)
        out.extend(int(w) for w in stream[i : i + n_dirty])
        i += n_dirty
    arr = np.asarray(out, dtype=np.uint32)
    if n_words is not None:
        assert len(arr) == n_words, (len(arr), n_words)
    return arr


def compressed_size(words: np.ndarray) -> int:
    return len(compress(words))


# ---------------------------------------------------------------------------
# Streaming logical operations — now in ewah_stream (the public cursor /
# appender engine).  Lazy re-exports keep ``ewah.logical_op`` etc. working;
# the import is deferred because ewah_stream imports this module's
# primitives (PEP 562 module __getattr__, no cycle at load time).
# ---------------------------------------------------------------------------

_STREAM_COMPAT = {
    "_Cursor": "Cursor",
    "_Appender": "Appender",
    "logical_op": "logical_op",
    "logical_many": "logical_many",
    "logical_not": "logical_not",
    "concat_streams": "concat_streams",
    "EwahStream": "EwahStream",
}


def __getattr__(name: str):
    if name in _STREAM_COMPAT:
        from . import ewah_stream

        return getattr(ewah_stream, _STREAM_COMPAT[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# ---------------------------------------------------------------------------
# Bit/word helpers shared by tests and benchmarks.
# ---------------------------------------------------------------------------


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Pack a boolean vector (len multiple-of-32 padded) into uint32 words.

    Bit j of word i corresponds to row 32*i + j (little-endian within word).
    """
    bits = np.asarray(bits, dtype=bool)
    n = len(bits)
    n_words = (n + WORD_BITS - 1) // WORD_BITS
    padded = np.zeros(n_words * WORD_BITS, dtype=bool)
    padded[:n] = bits
    m = padded.reshape(n_words, WORD_BITS).astype(np.uint32)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    return (m << shifts).sum(axis=1, dtype=np.uint32)


def unpack_bits(words: np.ndarray, n: int | None = None) -> np.ndarray:
    words = np.asarray(words, dtype=np.uint32)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    bits = ((words[:, None] >> shifts) & 1).astype(bool).reshape(-1)
    return bits if n is None else bits[:n]


def positions_to_words(positions: np.ndarray, n_rows: int) -> np.ndarray:
    """Sorted 1-bit row positions -> packed uint32 words (sparse friendly)."""
    n_words = (n_rows + WORD_BITS - 1) // WORD_BITS
    words = np.zeros(n_words, dtype=np.uint32)
    positions = np.asarray(positions, dtype=np.int64)
    np.bitwise_or.at(
        words, positions // WORD_BITS, (np.uint32(1) << (positions % WORD_BITS).astype(np.uint32))
    )
    return words
