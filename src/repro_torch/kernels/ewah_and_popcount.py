"""Launcher of the ewah_and_popcount CUDA kernel
(``csrc/ewah_and_popcount.cu``).

Not a port of a TPU kernel: it takes over from the reference's in-graph
dual-cursor walk (``src/repro/core/ewah_stream.py`` ``and_popcount``, a
``lax.while_loop``).  One thread walks one stream pair of the batch.
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
    return build.function("ewah_and_popcount", "launch_ewah_and_popcount",
                          [i, i, p, i, p, p, p, i, p, p, p, p, p])


def launch(sa, la, na, sb, lb, nb, count, iters) -> None:
    """sa (B, Ca), sb (B, Cb) int32 streams; la, na, lb, nb (B,) int32
    lengths and array sizes; writes count and iters (B,) int32."""
    from . import build

    B = sa.shape[0]
    code = _entry()(sa.device.index, B, sa.data_ptr(), sa.shape[1],
                    la.data_ptr(), na.data_ptr(), sb.data_ptr(), sb.shape[1],
                    lb.data_ptr(), nb.data_ptr(), count.data_ptr(),
                    iters.data_ptr(),
                    torch.cuda.current_stream(sa.device).cuda_stream)
    build.check("ewah_and_popcount", code)
