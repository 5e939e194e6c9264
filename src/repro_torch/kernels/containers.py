"""Launchers of the container kernels (``csrc/containers.cu``).

Replace the TPU kernels ``containerops_kernel`` and ``member_kernel``
(``src/repro/kernels/containers.py``): the batched and / or / and-not over
expanded container pairs, and the bit test of the array-with-bitmap
intersection, with the ``pos >> 5`` word gather folded into the kernel.
"""

from __future__ import annotations

import ctypes
from functools import cache

import torch

OPS = {"and": 0, "or": 1, "andnot": 2}


@cache
def _pairs_entry():
    from . import build

    p = ctypes.c_void_p
    return build.function("containers", "launch_containerops",
                          [ctypes.c_int, p, p, ctypes.c_longlong,
                           ctypes.c_int, p, p])


@cache
def _member_entry():
    from . import build

    p = ctypes.c_void_p
    return build.function("containers", "launch_member",
                          [ctypes.c_int, p, ctypes.c_longlong, ctypes.c_int,
                           p, ctypes.c_int, p, p])


def launch_pairs(a: torch.Tensor, b: torch.Tensor, op: str,
                 out: torch.Tensor) -> None:
    """a, b int32 words of one shape; writes out = a op b."""
    from . import build

    code = _pairs_entry()(a.device.index, a.data_ptr(), b.data_ptr(),
                          a.numel(), OPS[op], out.data_ptr(),
                          torch.cuda.current_stream(a.device).cuda_stream)
    build.check("containers", code)


def launch_member(pos: torch.Tensor, words: torch.Tensor,
                  out: torch.Tensor) -> None:
    """pos (P, L) int32 positions, words (P, W) int32 bitmap rows; writes
    out (P, L) int32 0/1 flags."""
    from . import build

    P, L = pos.shape
    code = _member_entry()(pos.device.index, pos.data_ptr(), P, L,
                           words.data_ptr(), words.shape[1], out.data_ptr(),
                           torch.cuda.current_stream(pos.device).cuda_stream)
    build.check("containers", code)
