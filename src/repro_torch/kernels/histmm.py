"""Launcher of the histogram CUDA kernel (``csrc/histmm.cu``).

Replaces the TPU kernel ``histmm_kernel`` (``src/repro/kernels/histmm.py``):
float32 counts of int32 values in [0, V), out-of-range values dropped, in
one launch a call.  :func:`plan` chooses where the counts live from n and
V; it is plain Python so that the CPU tests can check the choice.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from dataclasses import dataclass
from functools import cache

import torch

REGIMES = ("shared", "global")
VALUES_PER_BLOCK = 8192   # fewer values a block only adds partial copies
FLUSH_FACTOR = 0.5        # partial copies x V kept to at most n / this
EXACT_VALUES = 1 << 24    # from here on counts may pass float32's integers
GLOBAL_VALUES_PER_BLOCK = 3072  # more blocks issue the global adds faster
GLOBAL_ZEROED_PER_BLOCK = 65_536  # and zero the next call's V floats
STATIC_SMEM = 1024        # room left beside a block's bins
H100_SMS = 132
H100_SMEM_OPTIN = 232_448  # shared memory a block may opt into (227 KB)
POOLED_OUTPUTS = 16       # zeroed outputs kept, one each (device, stream, V)


@dataclass(frozen=True)
class Plan:
    """One launch of ``blocks`` blocks of ``threads``; ``smem`` dynamic
    shared bytes a block (shared regime).  ``exact``: counts meet as uint32
    in a zero-kept scratch behind a grid barrier (from 2**24 values), else
    as float32 adds into an output handed over zeroed."""

    regime: str
    threads: int
    blocks: int
    smem: int = 0
    exact: bool = False


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(n: int, V: int, sms: int = H100_SMS,
         smem_optin: int = H100_SMEM_OPTIN) -> Plan:
    """Where the counts of n values over V bins live, and the grid.

    One block for each ``VALUES_PER_BLOCK`` values, at most one an SM (the
    exact path's grid is cooperative, so all its blocks must be resident).
    V that fits in a block's shared memory keeps a private histogram a
    block, and no more blocks than n / (``FLUSH_FACTOR`` x V), since each
    flushes its copy bin by bin.  Larger V adds into device memory, on
    more blocks, since there the adds' issue rate bounds the time."""
    if n < 0 or V < 1:
        raise ValueError(f"histogram plan: n={n}, V={V}")
    exact = n >= EXACT_VALUES
    target = max(1, min(sms, _cdiv(n, VALUES_PER_BLOCK)))
    smem = 16 * _cdiv(V, 4)               # whole 16-byte groups of bins
    if smem <= smem_optin - STATIC_SMEM:
        copies = max(1, int(n // (FLUSH_FACTOR * V)))
        return Plan("shared", threads=1024, blocks=min(copies, target),
                    smem=smem, exact=exact)
    blocks = max(1, min(sms, max(_cdiv(n, GLOBAL_VALUES_PER_BLOCK),
                                 _cdiv(V, GLOBAL_ZEROED_PER_BLOCK))))
    return Plan("global", threads=1024, blocks=blocks, exact=exact)


@cache
def _entries():
    from . import build

    p = ctypes.c_void_p
    i = ctypes.c_int
    launch = build.function("histmm", "launch_histogram",
                            [i, p, ctypes.c_longlong, i, i, i, i, i, p, p, p,
                             p])
    limits = build.function("histmm", "histogram_device_limits",
                            [i, ctypes.POINTER(i), ctypes.POINTER(i)])
    return launch, limits


@cache
def device_limits(device: int) -> tuple:
    """(SMs, shared memory a block may opt into) of a CUDA device."""
    from . import build

    sms, optin = ctypes.c_int(), ctypes.c_int()
    build.check("histmm", _entries()[1](device, ctypes.byref(sms),
                                        ctypes.byref(optin)))
    return sms.value, optin.value


_SCRATCH: dict = {}
_ZEROED: OrderedDict = OrderedDict()


def scratch(device: torch.device, stream: int, words: int) -> torch.Tensor:
    """The exact path's zero-kept uint32 scratch of (device, stream), at
    least ``words`` long.  Allocated zeroed, and grown, on that stream;
    every launch leaves it zero, so two streams never share one."""
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(words, dtype=torch.int32, device=device)
        _SCRATCH[key] = buf
    return buf


def launch(vals: torch.Tensor, V: int) -> torch.Tensor:
    """vals (T,) int32 -> (V,) float32 counts in one launch of
    :func:`plan`'s choice.

    Below 2**24 values the output is one the previous launch on this
    (device, stream) zeroed for this V (the first call of a key allocates
    it zeroed), and this launch zeroes the next one, kept only once the
    launch is accepted; at most ``POOLED_OUTPUTS`` keys are kept."""
    from . import build

    dev = vals.device.index
    n = vals.numel()
    how = plan(n, V, *device_limits(dev))
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    key = (dev, stream, V)
    if how.exact:
        out = torch.empty(V, dtype=torch.float32, device=vals.device)
        nxt, buf = None, scratch(vals.device, stream, V)
    else:
        out = _ZEROED.pop(key, None)
        if out is None:
            out = torch.zeros(V, dtype=torch.float32, device=vals.device)
        nxt = torch.empty(V, dtype=torch.float32, device=vals.device)
        buf = None
    code = _entries()[0](dev, vals.data_ptr(), n, V,
                         REGIMES.index(how.regime), how.blocks,
                         how.threads, how.smem,
                         None if buf is None else buf.data_ptr(),
                         out.data_ptr(),
                         None if nxt is None else nxt.data_ptr(), stream)
    build.check("histmm", code)
    if nxt is not None:
        _ZEROED[key] = nxt
        while len(_ZEROED) > POOLED_OUTPUTS:
            _ZEROED.popitem(last=False)
    return out
