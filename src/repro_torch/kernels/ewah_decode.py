"""Launcher of the ewah_decode CUDA kernels (``csrc/ewah_decode.cu``).

Not a port of a TPU kernel: it takes over from the reference's
``lax.scan`` decoder (``src/repro/core/ewah_jax.py`` ``decompress``).
Two launches expand a (B, m, C) batch of EWAH streams into the
(m, B, n_words) plane stack the plan kernels read:

1. ``ewah_decode_kernel_markers`` resolves every stream's marker chain
   (a bounded warp walk for short streams; for the rest, pointer jumping
   to window exits across a cluster of blocks) into a marker table:
   ``tab`` (R, C, 2) int32 (position, output offset) of the markers whose
   offset is below n_words, their count ``tab_n`` (R,), and
   ``tile_first`` (R, n_tiles), the last marker starting at or before
   each tile of :data:`TILE` output words (-1 for an empty stream);
2. ``ewah_decode_kernel_expand`` writes every (stream, tile) of the
   output from that table.

Rows r = b * m + j follow the batch.  Table entries at or past a row's
count are unspecified.
"""

from __future__ import annotations

import ctypes
import itertools
from functools import cache

import torch

#: Output words a block of the expansion writes (2^DEC_TILE_SHIFT in the
#: kernel source).
TILE = 2048


#: A new tag for every markers launch: the kernel marks a long stream's
#: count with -2 tag while the stream waits for a cluster to claim it, so
#: no value left in a reused buffer reads as such a mark.
_TAGS = itertools.count()


def n_tiles(n_words: int) -> int:
    return -(-n_words // TILE)


@cache
def _entries():
    from . import build

    p = ctypes.c_void_p
    i = ctypes.c_int
    markers = build.function(
        "ewah_decode", "launch_ewah_markers",
        [i, p, i, p, i, i, i, i, i, p, p, p, p, p])
    expand = build.function(
        "ewah_decode", "launch_ewah_expand",
        [i, p, i, p, i, i, i, i, i, p, p, p, p, p])
    scratch = build.function("ewah_decode", "ewah_markers_scratch_words",
                             [i, i])
    scratch.restype = ctypes.c_longlong
    return markers, expand, scratch


def table(batch: torch.Tensor, n_words: int):
    """Empty (tab, tab_n, tile_first) for ``batch`` on its device."""
    B, m, C = batch.shape
    R = B * m
    dev = batch.device
    return (torch.empty(R, C, 2, dtype=torch.int32, device=dev),
            torch.empty(R, dtype=torch.int32, device=dev),
            torch.empty(R, n_tiles(n_words), dtype=torch.int32, device=dev))


def launch_markers(batch, lengths, n_words: int, tab, tab_n,
                   tile_first) -> None:
    """Phase 1: batch (B, m, C), lengths (B, m) int32 -> the marker table
    (written into ``tab``, ``tab_n``, ``tile_first``)."""
    from . import build

    B, m, C = batch.shape
    R = B * m
    dev = batch.device.index
    markers, _, scratch_words = _entries()
    words = int(scratch_words(C, R))
    if words < 0:
        raise ValueError(f"ewah_decode: no marker table for C={C}, R={R}")
    scratch = (torch.empty(words, dtype=torch.int32, device=batch.device)
               if words else None)
    code = markers(dev, batch.data_ptr(), C, lengths.data_ptr(), R, n_words,
                   TILE, n_tiles(n_words), next(_TAGS) % ((1 << 29) - 1) + 1,
                   tab.data_ptr(), tab_n.data_ptr(),
                   tile_first.data_ptr(),
                   None if scratch is None else scratch.data_ptr(),
                   torch.cuda.current_stream(batch.device).cuda_stream)
    build.check("ewah_decode", code)


def launch_expand(batch, lengths, n_words: int, tab, tab_n, tile_first,
                  out) -> None:
    """Phase 2: the marker table -> out (m, B, n_words) int32."""
    from . import build

    B, m, C = batch.shape
    _, expand, _ = _entries()
    code = expand(batch.device.index, batch.data_ptr(), C,
                  lengths.data_ptr(), m, B, n_words, TILE, n_tiles(n_words),
                  tab.data_ptr(), tab_n.data_ptr(), tile_first.data_ptr(),
                  out.data_ptr(),
                  torch.cuda.current_stream(batch.device).cuda_stream)
    build.check("ewah_decode", code)


def launch(batch: torch.Tensor, lengths: torch.Tensor, n_words: int,
           out: torch.Tensor) -> None:
    """batch (B, m, C) int32, lengths (B, m) int32; writes out
    (m, B, n_words) int32 with both launches."""
    tab, tab_n, tile_first = table(batch, n_words)
    launch_markers(batch, lengths, n_words, tab, tab_n, tile_first)
    launch_expand(batch, lengths, n_words, tab, tab_n, tile_first, out)
