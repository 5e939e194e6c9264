"""Batched EWAH codec on torch tensors: classify / compress / size / decode.

Port of the reference package's in-graph codec (``repro.core.ewah_jax``).
Torch has no ``vmap``, so every function here takes a batch of rows
``(B, n)`` and returns one result per row.  Compression is the
hand-written ``ewah_encode`` CUDA kernel on the device
(``kernels.ops.ewah_encode``); its plain version here
(:func:`compress_from_runs`) writes each word's part of the stream from
its run (class, offset, length, and the dirty run after a clean one) at
an exclusive scan of the counts.  Unlike the reference, which holds one
marker a (clean, dirty) group and so at most ``MAX_DIRTY`` words a row,
both split a clean run at ``MAX_CLEAN`` and a dirty run at ``MAX_DIRTY``
as ``ewah.compress`` does, so any row length encodes.  Decompression is
the hand-written ``ewah_decode`` CUDA kernel on the device
(``kernels.ops.ewah_decode``); the reference's ``lax.scan`` has no torch
counterpart.

Words are ``int32`` bit-views of the uint32 EWAH words: all-ones is -1,
and every right shift is masked.  Offsets and indices are int64.
"""

from __future__ import annotations

import torch

from .ewah import MAX_CLEAN, MAX_DIRTY

# clean-1 word as an int32 bit-view
FULL = -1


def classify(words: torch.Tensor) -> torch.Tensor:
    """0 = clean-0, 1 = clean-1, 2 = dirty (int32, same shape)."""
    kind = torch.full_like(words, 2, dtype=torch.int32)
    kind[words == 0] = 0
    kind[words == FULL] = 1
    return kind


def run_starts(kind: torch.Tensor) -> torch.Tensor:
    """Run-start flags of each row: word 0 always opens a run, then any
    change of class."""
    start = torch.ones_like(kind, dtype=torch.int32)
    start[:, 1:] = (kind[:, 1:] != kind[:, :-1]).to(torch.int32)
    return start


def compress(words: torch.Tensor, capacity: int):
    """EWAH-compress each row of ``words`` (B, n) int32: the
    ``ewah_encode`` kernel on a CUDA tensor, its plain version
    (:func:`compress_from_runs`) on a CPU tensor.

    Returns (streams (B, capacity) int32, lengths (B,) int32).
    """
    from ..kernels import ops

    streams, lengths, _ = ops.ewah_encode(words, classify(words), capacity)
    return streams, lengths


def stream_capacity(n: int) -> int:
    """Words that hold the EWAH stream of any n-word row: every word
    verbatim, one marker, and one more marker each ``MAX_DIRTY`` words."""
    return n + 1 + n // MAX_DIRTY


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """Wrap int64 values in [0, 2**32) to their int32 bit-view."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def compress_from_runs(words: torch.Tensor, kind: torch.Tensor,
                       capacity: int):
    """The canonical EWAH stream of each row, batched: the plain version
    of the ``ewah_encode`` kernel, bit-identical to ``ewah.compress``.

    ``words`` and ``kind`` (0/1/2 per word: :func:`classify`, the
    recompress kernel's, or the fused planfuse kernel's) are (B, n).  Each
    word's output is a function of its class c, its offset r inside its
    run, its run's length L and, for a clean run, the length nd of the
    dirty run right after it (0 if none):

    * a clean word writes one marker where ``r % MAX_CLEAN == 0``:
      ``(c, L - r, min(nd, MAX_DIRTY))`` for the run's last chunk,
      ``(c, MAX_CLEAN, 0)`` before it;
    * a dirty word writes itself, after a marker ``(0, 0, min(MAX_DIRTY,
      L - r))`` where ``r % MAX_DIRTY == 0`` and either ``r > 0`` or the
      run opens the row;

    at the exclusive prefix sum of those counts in its row.  Words past
    ``capacity`` are dropped; the length is the whole stream's.  Returns
    (streams (B, capacity) int32, lengths (B,) int32, overflow (B,)
    int32), where ``overflow`` is 1 for a row with a clean run longer than
    ``MAX_CLEAN`` or a dirty run longer than ``MAX_DIRTY``: the markers a
    single marker a group could not write.
    """
    B, n = words.shape
    dev = words.device
    i64 = torch.int64
    if n == 0:
        zero = torch.zeros(B, dtype=torch.int32, device=dev)
        return (torch.zeros(B, capacity, dtype=torch.int32, device=dev),
                zero, zero.clone())
    idx = torch.arange(n, device=dev, dtype=i64).expand(B, n)
    k = kind.to(i64)
    start = run_starts(kind).bool()
    end = torch.ones_like(start)
    end[:, :-1] = start[:, 1:]
    s = torch.cummax(torch.where(start, idx, 0), dim=1).values
    e = torch.cummin(torch.where(end, idx, n).flip(1), dim=1).values.flip(1)
    L = e - s + 1
    r = idx - s
    clean = k < 2
    nxt = torch.clamp(e + 1, max=n - 1)
    nd = torch.where(clean & (e + 1 < n) & (k.gather(1, nxt) == 2),
                     L.gather(1, nxt), 0)

    cmark = clean & (r % MAX_CLEAN == 0)
    dmark = ~clean & (r % MAX_DIRTY == 0) & ((r > 0) | (s == 0))
    emit = torch.where(clean, cmark.to(i64), 1 + dmark.to(i64))
    off = torch.cumsum(emit, dim=1) - emit
    total = emit.sum(dim=1)

    last = r + MAX_CLEAN >= L
    marker = torch.where(
        clean,
        (k << 31) | (torch.where(last, L - r, MAX_CLEAN) << 15)
        | torch.where(last, torch.clamp(nd, max=MAX_DIRTY), 0),
        torch.clamp(L - r, max=MAX_DIRTY))
    out = torch.zeros(B, capacity + 1, dtype=torch.int32, device=dev)
    # slot ``capacity`` is the spare that takes every dropped write
    mpos = torch.where((cmark | dmark) & (off < capacity), off, capacity)
    out.scatter_(1, mpos, _to_int32_bits(marker))
    dpos = off + dmark.to(i64)
    dpos = torch.where(~clean & (dpos < capacity), dpos, capacity)
    out.scatter_(1, dpos, words.to(torch.int32))
    overflow = (torch.where(clean, L > MAX_CLEAN, L > MAX_DIRTY)).any(dim=1)
    return (out[:, :capacity], total.to(torch.int32),
            overflow.to(torch.int32))


def compressed_size(words: torch.Tensor) -> torch.Tensor:
    """Compressed size in words of each row (markers + dirty), (B,) int64.

    Exact for rows within the single-marker-per-group restriction.
    """
    kind = classify(words)
    start = run_starts(kind).bool()
    n_clean_runs = (start & (kind < 2)).sum(dim=1)
    lead_dirty = (kind[:, 0] == 2).to(torch.int64)
    n_groups = torch.clamp(n_clean_runs + lead_dirty, min=1)
    return n_groups + (kind == 2).sum(dim=1)


def decompress(streams: torch.Tensor, lengths: torch.Tensor, n_words: int):
    """Expand EWAH streams (R, C) int32 with lengths (R,) into (R, n_words)
    int32 words: the ``ewah_decode`` kernel on a CUDA tensor, its plain
    version on a CPU tensor."""
    from ..kernels import ops

    R = streams.shape[0]
    planes = ops.ewah_decode(streams.reshape(R, 1, -1),
                             lengths.reshape(R, 1), n_words)
    return planes.reshape(R, n_words)
