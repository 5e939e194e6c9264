"""Launcher of the histogram CUDA kernel (``csrc/histmm.cu``).

Replaces the TPU kernel ``histmm_kernel`` (``src/repro/kernels/histmm.py``):
float32 counts of int32 values in [0, V), out-of-range values dropped.
Counts accumulate in a uint32 scratch vector and are converted once.
"""

from __future__ import annotations

import ctypes
from functools import cache

import torch


@cache
def _entry():
    from . import build

    p = ctypes.c_void_p
    return build.function("histmm", "launch_histogram",
                          [ctypes.c_int, p, ctypes.c_longlong, ctypes.c_int,
                           p, p, p])


def launch(vals: torch.Tensor, counts: torch.Tensor,
           out: torch.Tensor) -> None:
    """vals (T,) int32; counts (V,) int32 scratch (zeroed by the launch);
    writes out (V,) float32."""
    from . import build

    code = _entry()(vals.device.index, vals.data_ptr(), vals.numel(),
                    out.numel(), counts.data_ptr(), out.data_ptr(),
                    torch.cuda.current_stream(vals.device).cuda_stream)
    build.check("histmm", code)
