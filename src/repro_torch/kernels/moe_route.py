"""Launcher of the moe_route CUDA kernel (``csrc/moe_route.cu``).

Replaces the TPU kernel ``moe_route_kernel``
(``src/repro/kernels/moe_route.py``): (T, k) top-k expert ids packed into
(ceil(T/32), E) k-of-E dispatch words, in one launch.
"""

from __future__ import annotations

import ctypes
from functools import cache

import torch


@cache
def _entry():
    from . import build

    p = ctypes.c_void_p
    return build.function("moe_route", "launch_moe_route",
                          [ctypes.c_int, p, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, p, p])


def launch(eids: torch.Tensor, words: torch.Tensor) -> None:
    """eids (T, k) int32; writes words (ceil(T/32), E) int32."""
    from . import build

    T, k = eids.shape
    code = _entry()(eids.device.index, eids.data_ptr(), T, k, words.shape[1],
                    words.data_ptr(),
                    torch.cuda.current_stream(eids.device).cuda_stream)
    build.check("moe_route", code)
