"""Launcher of the slicefold CUDA kernel (``csrc/slicefold.cu``).

Replaces the TPU kernel ``slicefold_kernel``
(``src/repro/kernels/slicefold.py``): a left fold over m slice planes with
one op per step, in plane order (the bit-sliced comparison circuit).
"""

from __future__ import annotations

import ctypes
from functools import cache

import torch

OPS = {"and": 0, "or": 1, "xor": 2}


@cache
def _entry():
    from . import build

    p = ctypes.c_void_p
    return build.function("slicefold", "launch_slicefold",
                          [ctypes.c_int, p, ctypes.c_int, ctypes.c_longlong,
                           p, p, p])


def launch(x: torch.Tensor, ops: torch.Tensor, r: torch.Tensor) -> None:
    """x (m, n) int32 planes, ops (m - 1,) int8 op ids on the same device;
    writes r (n,)."""
    from . import build

    code = _entry()(x.device.index, x.data_ptr(), x.shape[0], x.shape[1],
                    ops.data_ptr(), r.data_ptr(),
                    torch.cuda.current_stream(x.device).cuda_stream)
    build.check("slicefold", code)
