"""Launcher of the wordops CUDA kernel (``csrc/wordops.cu``).

Replaces the TPU kernel ``wordops_kernel`` (``src/repro/kernels/wordops.py``):
``r = a op b`` plus the EWAH class of each result word.
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
    return build.function("wordops", "launch_wordops",
                          [ctypes.c_int, p, p, ctypes.c_longlong,
                           ctypes.c_int, p, p, p])


def launch(a: torch.Tensor, b: torch.Tensor, op: str, r: torch.Tensor,
           cls: torch.Tensor) -> None:
    """a, b (n,) int32 words; writes r (n,) int32 and cls (n,) int32."""
    from . import build

    code = _entry()(a.device.index, a.data_ptr(), b.data_ptr(), a.numel(),
                    OPS[op], r.data_ptr(), cls.data_ptr(),
                    torch.cuda.current_stream(a.device).cuda_stream)
    build.check("wordops", code)
