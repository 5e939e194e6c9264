"""Launchers of the ewah_and_popcount CUDA kernels
(``csrc/ewah_and_popcount.cu``).

Not a port of a TPU kernel: they take over from the reference's in-graph
dual-cursor walk (``src/repro/core/ewah_stream.py`` ``and_popcount``, a
``lax.while_loop``).  Two routes, by the batch's padded row widths:

- rows at most :data:`SHORT_WIDTH` words wide: one launch, one thread
  walks one stream pair (:func:`launch`);
- wider rows: two launches.  :func:`launch_chain` resolves every
  stream's marker chain into a table (a block a stream);
  :func:`launch_tiles` sums each pair's count and steps over tiles of
  :data:`TILE` stream positions (a block a pair, side and tile).  A pair
  that is not well formed (a length past its array size, a dirty run past
  its length, or :data:`N_WORDS` words or more) is walked serially inside
  the second launch.

A side's table is ``(tab (B, C, 2), wtab (B, C), meta (B, 3), ptile (B,
cdiv(C, TILE)))``: (position, offset) and word of each marker whose
offset is below :data:`N_WORDS` (entries past the count are unspecified),
``meta`` = (table count, W, a dirty run past the length), where W is the
stream's word total up to its first empty marker (N_WORDS where the
table is cut), and ``ptile[t]`` the marker whose span holds position
``t * TILE`` (-1 past the table).
"""

from __future__ import annotations

import ctypes
from functools import cache

import torch

#: Stream positions a block of the second phase takes (AP_TILE).
TILE = 2048
#: Table offsets saturate here (the kernels take n_words below 2**30).
N_WORDS = (1 << 30) - 1
#: Widest padded rows (either side) that take the one-thread-a-pair route.
SHORT_WIDTH = 1024


def n_tiles(C: int) -> int:
    return -(-C // TILE)


def is_short(sa, sb) -> bool:
    """Whether a batch takes the one-launch route: no row wider than
    :data:`SHORT_WIDTH`, or an empty side."""
    widths = (sa.shape[1], sb.shape[1])
    return max(widths) <= SHORT_WIDTH or min(widths) == 0


@cache
def _entries():
    from . import build

    p = ctypes.c_void_p
    i = ctypes.c_int
    side = [p, i, p, p, p, p, p, i]
    walk = build.function("ewah_and_popcount", "launch_ewah_and_popcount",
                          [i, i, p, i, p, p, p, i, p, p, p, p, p])
    chain = build.function("ewah_and_popcount", "launch_ewah_pair_chain",
                           [i, i, i, i, *side, *side, p])
    tile_side = [p, i, p, p, p, p, p, p, i]
    tiles = build.function("ewah_and_popcount", "launch_ewah_pair_tiles",
                           [i, i, i, i, *tile_side, *tile_side, p, p, p])
    return walk, chain, tiles


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(sa, la, na, sb, lb, nb, count, iters) -> None:
    """The short route: sa (B, Ca), sb (B, Cb) int32 streams; la, na, lb,
    nb (B,) int32 lengths and array sizes; writes count and iters (B,)
    int32."""
    from . import build

    B = sa.shape[0]
    code = _entries()[0](sa.device.index, B, sa.data_ptr(), sa.shape[1],
                         la.data_ptr(), na.data_ptr(), sb.data_ptr(),
                         sb.shape[1], lb.data_ptr(), nb.data_ptr(),
                         count.data_ptr(), iters.data_ptr(), _stream(sa))
    build.check("ewah_and_popcount", code)


def tables(s):
    """An empty table for the (B, C) streams ``s`` on their device."""
    B, C = s.shape
    dev = s.device
    return (torch.empty(B, C, 2, dtype=torch.int32, device=dev),
            torch.empty(B, C, dtype=torch.int32, device=dev),
            torch.empty(B, 3, dtype=torch.int32, device=dev),
            torch.empty(B, n_tiles(C), dtype=torch.int32, device=dev))


def _side(s, length, table, size=None):
    tab, wtab, meta, ptile = table
    head = [s.data_ptr(), s.shape[1], length.data_ptr()]
    if size is not None:
        head.append(size.data_ptr())
    return [*head, tab.data_ptr(), wtab.data_ptr(), meta.data_ptr(),
            ptile.data_ptr(), ptile.shape[1]]


def launch_chain(sa, la, sb, lb, table_a, table_b) -> None:
    """Phase 1: both sides' marker tables, written into ``table_a`` and
    ``table_b`` (see :func:`tables`)."""
    from . import build

    code = _entries()[1](sa.device.index, sa.shape[0], N_WORDS, TILE,
                         *_side(sa, la, table_a), *_side(sb, lb, table_b),
                         _stream(sa))
    build.check("ewah_and_popcount", code)


def launch_tiles(sa, la, na, sb, lb, nb, table_a, table_b, count,
                 iters) -> None:
    """Phase 2: adds each pair's count and steps into ``count`` and
    ``iters`` (B,) int32, which must be zero."""
    from . import build

    code = _entries()[2](sa.device.index, sa.shape[0], N_WORDS, TILE,
                         *_side(sa, la, table_a, na),
                         *_side(sb, lb, table_b, nb), count.data_ptr(),
                         iters.data_ptr(), _stream(sa))
    build.check("ewah_and_popcount", code)
