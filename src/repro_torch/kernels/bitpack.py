"""Launcher of the bitpack CUDA kernel (``csrc/bitpack.cu``).

Replaces the TPU kernel ``bitpack_kernel`` (``src/repro/kernels/bitpack.py``):
(R, C) booleans packed into (ceil(R/32), C) words, bit j of word w from
row 32w + j.
"""

from __future__ import annotations

import ctypes
from functools import cache

import torch


@cache
def _entry():
    from . import build

    p = ctypes.c_void_p
    return build.function("bitpack", "launch_bitpack",
                          [ctypes.c_int, p, ctypes.c_longlong,
                           ctypes.c_longlong, p, p])


def launch(bits: torch.Tensor, words: torch.Tensor) -> None:
    """bits (R, C) bool; writes words (ceil(R/32), C) int32."""
    from . import build

    R, C = bits.shape
    code = _entry()(bits.device.index, bits.data_ptr(), R, C,
                    words.data_ptr(),
                    torch.cuda.current_stream(bits.device).cuda_stream)
    build.check("bitpack", code)
