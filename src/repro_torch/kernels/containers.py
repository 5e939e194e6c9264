"""Launchers of the container kernels (``csrc/containers.cu``) and the host
packer of the one-launch container fold.

Replace the TPU kernels ``containerops_kernel`` and ``member_kernel``
(``src/repro/kernels/containers.py``): the and / or / and-not over
containers, and the bit test of the array-with-bitmap intersection, with
the ``pos >> 5`` word gather folded into the kernel.

``containerops`` takes whole folds, whatever their ops: :func:`pack_folds`
turns a list of ``(container sets, ops, n_rows)`` left folds into one flat
int32 buffer, uploaded once, that holds

* the chunk table, ``(out offset, words to write, first step, end step)``
  per output chunk (one (fold, chunk key) with a row set in some set the
  fold ORs in);
* the step table, ``(class | op << 2 | pool << 4, offset, length, 0)`` per
  step of a chunk's left fold (class ``ARRAY`` / ``BITMAP`` / ``RUN`` as in
  ``core.containers``, or ``ABSENT``, which reads as zero; op 0 and, 1 or,
  2 and-not; the first step ORs onto zero);
* the payloads: bitmap words (2048 a container, 16-byte aligned), then
  array positions and run (start, end) pairs as uint16, two a word.

The kernel writes each fold's dense plane at its offset in one zeroed
output.  An "and" step with an array container is the array-with-bitmap
intersection that ``member`` computes for one round (:func:`launch_member`,
``ops.container_gallop``): inside the fold the array's bits meet the
accumulated words on the card, so ``TorchBackend`` never launches
``member``.  A chunk only an "and" set holds gets no output chunk, as its
result is empty.  The pairwise form (:func:`launch_pairs`) is the same
kernel with two bitmap steps a chunk and no tables.
"""

from __future__ import annotations

import ctypes
from functools import cache
from typing import NamedTuple

import numpy as np
import torch

from ..core import containers as C

OPS = {"and": 0, "or": 1, "andnot": 2}
ABSENT = 3


class Packed(NamedTuple):
    """The one-launch fold's input (see the module docstring)."""

    buf: np.ndarray       # int32: chunks | steps | bitmap words | uint16 pool
    n_chunks: int
    n_steps: int
    steps_at: int         # int32 offsets into ``buf``
    words_at: int
    u16_at: int
    n_out: int            # words of the flat output
    planes: tuple         # (offset, W) of each fold's plane in the output


def pack_folds(folds) -> Packed:
    """``folds``: ``(csets, ops, n_rows)`` left folds, ops from ``OPS``.
    Planes are laid out in the given order, each W = ceil(n_rows / 32)
    words; a set held by several folds is uploaded once."""
    chunks, steps, planes = [], [], []
    bitmaps, u16 = [], []
    n_bitmap = n_u16 = 0
    refs: dict = {}           # (id(set), chunk index) -> step code bits
    held = []                 # keeps every set alive while ids are keys
    out_at = 0
    for csets, fops, n_rows in folds:
        W = -(-int(n_rows) // 32)
        planes.append((out_at, W))
        ops = ("or",) + tuple(fops)[: max(len(csets) - 1, 0)]
        index = [dict(zip((int(k) for k in cs.keys), range(len(cs))))
                 for cs in csets]
        live = sorted({k for cs, op in zip(index, ops) if op == "or"
                       for k in cs})
        for key in live:
            first = len(steps)
            for cs, op, idx in zip(csets, ops, index):
                i = idx.get(key)
                if i is None:
                    if op == "and":   # an absent container zeroes the chunk
                        steps.append((ABSENT | OPS[op] << 2, 0, 0, 0))
                    continue
                ref = refs.get((id(cs), i))
                if ref is None:
                    held.append(cs)
                    cls, payload = int(cs.classes[i]), cs.payloads[i]
                    if cls == C.BITMAP:
                        bitmaps.append(np.asarray(payload, np.uint32))
                        ref = (C.BITMAP, n_bitmap, C.CHUNK_WORDS)
                        n_bitmap += C.CHUNK_WORDS
                    elif cls == C.ARRAY or cls == C.RUN:
                        flat = np.asarray(payload, np.uint16).reshape(-1)
                        u16.append(flat)
                        ref = (cls, n_u16, len(payload))
                        n_u16 += len(flat)
                    else:
                        raise ValueError(f"unknown container class {cls!r}")
                    refs[(id(cs), i)] = ref
                cls, off, length = ref
                steps.append((cls | OPS[op] << 2, off, length, 0))
            chunks.append((out_at + key * C.CHUNK_WORDS,
                           min(C.CHUNK_WORDS, W - key * C.CHUNK_WORDS),
                           first, len(steps)))
        out_at += W
    if out_at >= 2**31:
        raise ValueError(f"container fold output of {out_at} words exceeds "
                         "the kernel's int32 offsets")
    pool = np.concatenate(u16) if u16 else np.zeros(0, np.uint16)
    if len(pool) % 2:
        pool = np.append(pool, np.uint16(0))
    parts = [np.asarray(chunks, np.int32).reshape(-1, 4).reshape(-1),
             np.asarray(steps, np.int32).reshape(-1, 4).reshape(-1),
             *(b.view(np.int32) for b in bitmaps), pool.view(np.int32)]
    steps_at = 4 * len(chunks)
    words_at = steps_at + 4 * len(steps)
    return Packed(np.concatenate(parts), len(chunks), len(steps), steps_at,
                  words_at, words_at + n_bitmap, out_at, tuple(planes))


@cache
def _fold_entry():
    from . import build

    p = ctypes.c_void_p
    return build.function("containers", "launch_containerops",
                          [ctypes.c_int, p, p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, p, p, p, p, p])


@cache
def _member_entry():
    from . import build

    p = ctypes.c_void_p
    return build.function("containers", "launch_member",
                          [ctypes.c_int, p, ctypes.c_longlong, ctypes.c_int,
                           p, ctypes.c_int, p, p])


def launch_fold(buf: torch.Tensor, packed: Packed, out: torch.Tensor) -> None:
    """buf: ``packed.buf`` on the device; writes the planes into the
    zeroed out (``packed.n_out``,)."""
    from . import build

    base, i32 = buf.data_ptr(), 4
    words = base + i32 * packed.words_at
    code = _fold_entry()(buf.device.index, base,
                         base + i32 * packed.steps_at, packed.n_chunks,
                         C.CHUNK_WORDS, 0, words, words,
                         base + i32 * packed.u16_at, out.data_ptr(),
                         torch.cuda.current_stream(buf.device).cuda_stream)
    build.check("containers", code)


def launch_pairs(a: torch.Tensor, b: torch.Tensor, op: str,
                 out: torch.Tensor) -> None:
    """a, b (P, W) int32 words; writes out = a op b (two bitmap steps a
    chunk)."""
    from . import build

    P, W = a.shape
    code = _fold_entry()(a.device.index, None, None, P, W, OPS[op],
                         a.data_ptr(), b.data_ptr(), None, out.data_ptr(),
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
