"""Launcher of the ewah_encode CUDA kernels (``csrc/ewah_encode.cu``).

Not a port of a TPU kernel: it takes over from the reference's ``jnp``
compressor (``src/repro/core/ewah_jax.py`` ``compress``), which holds one
marker a (clean, dirty) group and so at most ``MAX_DIRTY`` words a row,
and from the host's ``ewah.compress`` past that.  Two launches write the
canonical EWAH stream of each row of a (B, n) batch, any n, from its
words and their classes:

1. ``ewah_encode_kernel_tiles`` reduces each tile of 4,096 words of a
   row to a summary of its run starts (five int32 a tile, in scratch
   sized by the library's own ``ewah_encode_tile_words`` and
   ``ewah_encode_summary_words``);
2. ``ewah_encode_kernel_write`` combines the summaries of the tiles before
   each tile, which places the tile's first word in the stream, and writes
   the tile's verbatim words and the markers of the runs that end in it.
"""

from __future__ import annotations

import ctypes
from functools import cache

import torch


@cache
def _entries():
    """The launch entry point, the words of a tile and the int32 words of
    a tile's summary."""
    from . import build

    p = ctypes.c_void_p
    i = ctypes.c_int
    launch_fn = build.function("ewah_encode", "launch_ewah_encode",
                               [i, p, p, i, i, i, p, p, p, p, p])
    tile = build.function("ewah_encode", "ewah_encode_tile_words", [])
    summary = build.function("ewah_encode", "ewah_encode_summary_words", [])
    return launch_fn, tile(), summary()


def launch(words: torch.Tensor, kind: torch.Tensor, capacity: int,
           streams: torch.Tensor, lengths: torch.Tensor,
           overflow: torch.Tensor) -> None:
    """words, kind (B, n) int32 with B, n >= 1; writes streams (B,
    capacity), lengths (B,) and overflow (B,) int32."""
    from . import build

    B, n = words.shape
    launch_fn, tile, summary = _entries()
    tiles = -(-n // tile)
    sums = torch.empty(B * tiles * summary, dtype=torch.int32,
                       device=words.device)
    code = launch_fn(words.device.index, words.data_ptr(), kind.data_ptr(),
                     B, n, capacity, streams.data_ptr(), lengths.data_ptr(),
                     overflow.data_ptr(), sums.data_ptr(),
                     torch.cuda.current_stream(words.device).cuda_stream)
    build.check("ewah_encode", code)
