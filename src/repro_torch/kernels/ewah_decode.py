"""Launcher of the ewah_decode CUDA kernel (``csrc/ewah_decode.cu``).

Not a port of a TPU kernel: it takes over from the reference's
``lax.scan`` decoder (``src/repro/core/ewah_jax.py`` ``decompress``).
One block per stream expands a (B, m, C) batch of EWAH streams into the
(m, B, n_words) plane stack the plan kernels read.
"""

from __future__ import annotations

import ctypes
from functools import cache

import torch


@cache
def _entry():
    from . import build

    p = ctypes.c_void_p
    i = ctypes.c_int
    return build.function("ewah_decode", "launch_ewah_decode",
                          [i, p, i, p, i, i, i, p, p])


def launch(batch: torch.Tensor, lengths: torch.Tensor, n_words: int,
           out: torch.Tensor) -> None:
    """batch (B, m, C) int32, lengths (B, m) int32; writes out
    (m, B, n_words) int32."""
    from . import build

    B, m, C = batch.shape
    code = _entry()(batch.device.index, batch.data_ptr(), C,
                    lengths.data_ptr(), m, B, n_words, out.data_ptr(),
                    torch.cuda.current_stream(batch.device).cuda_stream)
    build.check("ewah_decode", code)
