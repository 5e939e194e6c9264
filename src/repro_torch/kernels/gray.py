"""Launcher of the gray CUDA kernel (``csrc/gray.cu``).

Replaces the TPU kernel ``gray_kernel`` (``src/repro/kernels/gray.py``):
binary to Gray code ``x ^ (x >> 1)`` or back (prefix-xor cascade), with
logical shifts on the words.
"""

from __future__ import annotations

import ctypes
from functools import cache

import torch


@cache
def _entry():
    from . import build

    p = ctypes.c_void_p
    return build.function("gray", "launch_gray",
                          [ctypes.c_int, p, ctypes.c_longlong, ctypes.c_int,
                           p, p])


def launch(x: torch.Tensor, inverse: bool, out: torch.Tensor) -> None:
    """x int32 words; writes out (same shape) int32."""
    from . import build

    code = _entry()(x.device.index, x.data_ptr(), x.numel(), int(inverse),
                    out.data_ptr(),
                    torch.cuda.current_stream(x.device).cuda_stream)
    build.check("gray", code)
