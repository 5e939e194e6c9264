"""Launcher of the rowids CUDA kernels (``csrc/rowids.cu``).

Not a port of a TPU kernel: it replaces the host's ``ewah.unpack_bits``
and ``np.flatnonzero`` on the row-id entry.  Two launches turn a (B, W)
batch of answer words into the row ids of every answer, ascending, the
answers back to back in one flat int64 output:

1. ``rowids_kernel_count`` counts each tile of :data:`TILE` words (bits
   at or past ``n_rows`` masked off), and its last block scans the counts
   into each tile's offset in the flat output, ``offsets`` (B, T) int64,
   and each answer's total, ``totals`` (B,) int64;
2. ``rowids_kernel_write`` writes each tile's ids at its offset.

The caller reads the totals between the two, to size the output.
"""

from __future__ import annotations

import ctypes
from functools import cache

import torch

#: Words a block of either kernel reads (kTile in the kernel source).
TILE = 1024


def n_tiles(n_words: int) -> int:
    return -(-n_words // TILE)


@cache
def _entries():
    from . import build

    p = ctypes.c_void_p
    i = ctypes.c_int
    ll = ctypes.c_longlong
    count = build.function("rowids", "launch_rowids_count",
                           [i, p, i, i, ll, p, p, p, p])
    write = build.function("rowids", "launch_rowids_write",
                           [i, p, i, i, ll, p, p, p])
    tile = build.function("rowids", "rowids_tile_words", [])()
    if tile != TILE:
        raise RuntimeError(f"rowids: the library's tile is {tile} words, "
                           f"kernels/rowids.TILE {TILE}")
    return count, write


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_count(words: torch.Tensor, n_rows: int, offsets: torch.Tensor,
                 totals: torch.Tensor, done: torch.Tensor) -> None:
    """words (B, W) int32 with B, W >= 1; writes offsets (B, n_tiles(W))
    and totals (B,) int64; ``done`` is one int64 of scratch."""
    from . import build

    B, W = words.shape
    code = _entries()[0](words.device.index, words.data_ptr(), B, W, n_rows,
                         offsets.data_ptr(), totals.data_ptr(),
                         done.data_ptr(), _stream(words))
    build.check("rowids", code)


def launch_write(words: torch.Tensor, n_rows: int, offsets: torch.Tensor,
                 ids: torch.Tensor) -> None:
    """words (B, W) int32 and the count launch's offsets; writes ids
    (offsets' total,) int64."""
    from . import build

    B, W = words.shape
    code = _entries()[1](words.device.index, words.data_ptr(), B, W, n_rows,
                         offsets.data_ptr(), ids.data_ptr(), _stream(words))
    build.check("rowids", code)
