"""EWAH streams from the format's definition (32-bit words).

A stream is a sequence of groups.  Each group is one marker word, then the
verbatim words it announces.  Marker: bit 31 is the type of its clean run
(0: all-zero words, 1: all-one words), bits 30..15 the number of clean
words (at most 65,535), bits 14..0 the number of verbatim words that follow
(at most 32,767).  The canonical stream of a word array takes each maximal
clean run with the maximal dirty run after it as one group, splitting only
where a count would overflow.
"""

from __future__ import annotations

import numpy as np

FULL = 0xFFFFFFFF
MAX_CLEAN = (1 << 16) - 1
MAX_DIRTY = (1 << 15) - 1


class MalformedStream(ValueError):
    """A stream whose markers do not describe exactly ``n_words`` words."""


def marker(ctype: int, n_clean: int, n_dirty: int) -> int:
    return (ctype << 31) | (n_clean << 15) | n_dirty


def decode(stream, n_words: int) -> np.ndarray:
    """The ``n_words`` uint32 words a stream describes; raises
    :class:`MalformedStream` where it describes more, fewer or runs past
    its own end."""
    stream = np.asarray(stream, dtype=np.uint32)
    out = np.empty(n_words, dtype=np.uint32)
    pos = i = 0
    while i < len(stream):
        m = int(stream[i])
        ctype, n_clean, n_dirty = m >> 31, (m >> 15) & 0xFFFF, m & 0x7FFF
        i += 1
        if pos + n_clean + n_dirty > n_words or i + n_dirty > len(stream):
            raise MalformedStream(
                f"group at word {i - 1} runs past the stream or the bitmap")
        out[pos: pos + n_clean] = FULL if ctype else 0
        pos += n_clean
        out[pos: pos + n_dirty] = stream[i: i + n_dirty]
        pos += n_dirty
        i += n_dirty
    if pos != n_words:
        raise MalformedStream(f"stream describes {pos} words, not {n_words}")
    return out


def _group(out: list, ctype: int, n_clean: int, dirty: np.ndarray) -> None:
    while n_clean > MAX_CLEAN:
        out.append(np.array([marker(ctype, MAX_CLEAN, 0)], dtype=np.uint32))
        n_clean -= MAX_CLEAN
    first = min(len(dirty), MAX_DIRTY)
    out.append(np.array([marker(ctype, n_clean, first)], dtype=np.uint32))
    out.append(dirty[:first])
    for at in range(first, len(dirty), MAX_DIRTY):
        chunk = dirty[at: at + MAX_DIRTY]
        out.append(np.array([marker(0, 0, len(chunk))], dtype=np.uint32))
        out.append(chunk)


def encode(words) -> np.ndarray:
    """The canonical stream of a uint32 word array."""
    words = np.asarray(words, dtype=np.uint32)
    if not len(words):
        return np.zeros(0, dtype=np.uint32)
    kind = np.where(words == 0, 0, np.where(words == FULL, 1, 2))
    starts = np.flatnonzero(np.r_[True, kind[1:] != kind[:-1]])
    runs = list(zip(kind[starts].tolist(), starts.tolist(),
                    np.r_[starts[1:], len(words)].tolist()))
    out: list = []
    r = 0
    while r < len(runs):
        ctype = n_clean = 0
        if runs[r][0] != 2:
            ctype, n_clean = runs[r][0], runs[r][2] - runs[r][1]
            r += 1
        dirty = words[:0]
        if r < len(runs) and runs[r][0] == 2:
            dirty = words[runs[r][1]: runs[r][2]]
            r += 1
        _group(out, ctype, n_clean, dirty)
    return np.concatenate(out)


def encode_blocks(words, block: int = 1024) -> np.ndarray:
    """A stream of the same words that is not canonical: each block of
    ``block`` words is encoded on its own, so runs that cross a block edge
    split (what a block-parallel encoder without a merge pass emits).  The
    canonical-form control."""
    words = np.asarray(words, dtype=np.uint32)
    return np.concatenate([encode(words[at: at + block])
                           for at in range(0, len(words), block)])


def pack(mask: np.ndarray) -> np.ndarray:
    """A boolean row mask -> uint32 words, row ``32 w + b`` in bit ``b`` of
    word ``w``; rows past the end are 0."""
    by = np.packbits(np.asarray(mask, dtype=bool), bitorder="little")
    by = np.concatenate([by, np.zeros(-len(by) % 4, dtype=np.uint8)])
    return by.view("<u4").astype(np.uint32)


def rows_only(words: np.ndarray, n_rows: int) -> np.ndarray:
    """A copy of the words with the padding past row ``n_rows - 1``
    cleared."""
    out = np.array(words, dtype=np.uint32, copy=True)
    if n_rows % 32:
        out[-1] &= np.uint32((1 << (n_rows % 32)) - 1)
    return out


def rows_of(words: np.ndarray, n_rows: int) -> np.ndarray:
    """Set row positions of a word array, rows past ``n_rows`` dropped."""
    bits = np.unpackbits(np.asarray(words, dtype="<u4").view(np.uint8),
                         bitorder="little")
    return np.flatnonzero(bits[:n_rows])
