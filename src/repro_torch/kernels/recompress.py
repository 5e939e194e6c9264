"""Launcher of the recompress CUDA kernel (``csrc/recompress.cu``).

Replaces the TPU kernel ``recompress_kernel``
(``src/repro/kernels/recompress.py``): per-word EWAH class of w and the
run-start flag ``class(w) != class(p)``, where p is each word's
predecessor (with an opposite-class sentinel before each row's word 0).
"""

from __future__ import annotations

import ctypes
from functools import cache

import torch


@cache
def _entry():
    from . import build

    p = ctypes.c_void_p
    return build.function("recompress", "launch_recompress",
                          [ctypes.c_int, p, p, ctypes.c_longlong, p, p, p])


def launch(w: torch.Tensor, p: torch.Tensor, kind: torch.Tensor,
           start: torch.Tensor) -> None:
    """w, p (n,) int32 words; writes kind and start (n,) int32."""
    from . import build

    code = _entry()(w.device.index, w.data_ptr(), p.data_ptr(), w.numel(),
                    kind.data_ptr(), start.data_ptr(),
                    torch.cuda.current_stream(w.device).cuda_stream)
    build.check("recompress", code)
