"""Wrappers around the CUDA kernels: check, allocate, launch, count.

Each wrapper takes the kernel's plain PyTorch version (``ref``) only when
its tensors lie on the CPU.  For CUDA tensors it launches the hand-written
kernel or raises: there is no fallback.  Every launch adds one to
``LAUNCHES[name]``, so a run can show which kernels its path went through.

Words are int32 bit-views of the uint32 EWAH words.  The reference's
padding to (8, 128) TPU tiles has no counterpart: the kernels take flat
word vectors of any length and pick 16-byte or 4-byte accesses themselves.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..core import ewah_torch
from . import ewah_decode as _decode
from . import planfuse as _planfuse
from . import recompress as _recompress
from . import ref
from . import slicefold as _slicefold
from . import wordops as _wordops

#: Launches of each kernel since the last :func:`reset_launches`.
LAUNCHES = {"planfuse": 0, "recompress": 0, "wordops": 0, "slicefold": 0,
            "ewah_decode": 0}

_OP_NAMES = ("and", "or", "xor")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_cuda(name: str, *tensors) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must all lie on the CPU or all "
                             f"on one CUDA device, got {t.device}")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on {tensors[0].device} and "
                             f"{t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: int32 word tensors expected, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: contiguous tensors expected")


@lru_cache(maxsize=256)
def _device_table(values: tuple, dtype: torch.dtype, device: torch.device):
    """A small constant table (a tape or an op list) on the device,
    copied once per distinct value."""
    return torch.tensor(values, dtype=dtype, device=device)


def wordops(a, b, op="and"):
    """(n,) word vectors -> (a op b, class of each result word)."""
    if op not in _OP_NAMES:
        raise ValueError(f"unknown word op {op!r}")
    if a.shape != b.shape:
        raise ValueError(f"wordops: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    if _on_cpu(a, b):
        return ref.wordops(a, b, op)
    _check_cuda("wordops", a, b)
    r = torch.empty_like(a)
    cls = torch.empty_like(a)
    if a.numel():
        _wordops.launch(a, b, op, r, cls)
        LAUNCHES["wordops"] += 1
    return r, cls


def wordops_fold(stacked, op="and"):
    """Fold ``op`` across axis 0 of (m, n) word vectors -> (n,).

    Tree reduction: each level combines all of its pairs in one flattened
    ``wordops`` launch, so m planes fold in ceil(log2 m) launches.
    """
    m, n = stacked.shape
    while m > 1:
        even = (m // 2) * 2
        a = stacked[0:even:2].reshape(-1)
        b = stacked[1:even:2].reshape(-1)
        r, _ = wordops(a, b, op)
        merged = r.reshape(even // 2, n)
        if m % 2:
            merged = torch.cat([merged, stacked[-1:]], dim=0)
        stacked = merged
        m = stacked.shape[0]
    return stacked[0]


def slice_fold(stacked, ops):
    """Left-fold (m, n) word vectors with a per-step op -> (n,).

    ``ops`` is a tuple of m - 1 names from {'and', 'or', 'xor'}, applied in
    plane order: the bit-sliced comparison circuit.
    """
    m, n = stacked.shape
    if len(ops) != m - 1:
        raise ValueError(f"slice_fold got {m} planes but {len(ops)} ops "
                         "(need exactly m - 1)")
    if any(op not in _OP_NAMES for op in ops):
        raise ValueError(f"unknown word op in {ops!r}")
    if m == 1:
        return stacked[0]
    if _on_cpu(stacked):
        return ref.slice_fold(stacked, ops)
    _check_cuda("slice_fold", stacked)
    ids = _device_table(tuple(_slicefold.OPS[o] for o in ops), torch.int8,
                        stacked.device)
    r = torch.empty(n, dtype=torch.int32, device=stacked.device)
    if n:
        _slicefold.launch(stacked, ids, r)
        LAUNCHES["slicefold"] += 1
    return r


def plan_fuse(stacked, tape):
    """Evaluate a lowered plan tape over (m, n) word planes in one launch
    -> (result (n,), kind (n,)).

    ``tape`` is the stack-machine program from ``core.query.lower_plan``;
    ``kind`` is the EWAH class of each result word (0 clean-0, 1 clean-1,
    2 dirty).  Raises for a tape the kernel cannot run (see
    ``planfuse.fits``).
    """
    m, n = stacked.shape
    tape = tuple((int(o), int(a)) for o, a in tape)
    depth = max_depth = 0
    for opcode, arg in tape:
        if opcode == _planfuse.PUSH:
            if not 0 <= arg < m:
                raise ValueError(f"tape pushes plane {arg} of {m}")
            depth += 1
            max_depth = max(max_depth, depth)
        elif opcode == _planfuse.OP:
            depth -= 1
        if depth < 1:
            raise ValueError("tape pops an empty operand stack")
    if depth != 1:
        raise ValueError(f"tape leaves {depth} operands on the stack")
    if not _planfuse.fits(tape, max_depth):
        raise ValueError(
            f"tape of length {len(tape)} and depth {max_depth} exceeds the "
            f"kernel's limits ({_planfuse.MAX_TAPE_LEN}, "
            f"{_planfuse.MAX_STACK_DEPTH})")
    if _on_cpu(stacked):
        return ref.plan_fuse(stacked, tape)
    _check_cuda("plan_fuse", stacked)
    tape_t = _device_table(tape, torch.int32, stacked.device)
    r = torch.empty(n, dtype=torch.int32, device=stacked.device)
    kind = torch.empty(n, dtype=torch.int32, device=stacked.device)
    if n:
        _planfuse.launch(stacked, tape_t, r, kind)
        LAUNCHES["planfuse"] += 1
    return r, kind


def recompress_flags(w, p):
    """(n,) words and their predecessors -> (kind, start) int32."""
    if w.shape != p.shape:
        raise ValueError("recompress: words and predecessors differ in shape")
    if _on_cpu(w, p):
        return ref.recompress(w, p)
    _check_cuda("recompress", w, p)
    kind = torch.empty_like(w)
    start = torch.empty_like(w)
    if w.numel():
        _recompress.launch(w, p, kind, start)
        LAUNCHES["recompress"] += 1
    return kind, start


def recompress_batch(words, capacity):
    """(B, W) dense word rows -> (streams (B, capacity), lengths (B,)).

    Rows get an opposite-class sentinel as word 0's predecessor, so runs
    never bleed across rows; one recompress launch classifies the whole
    batch, then the scan/scatter epilogue (``ewah_torch.compress_from_runs``)
    emits every row's stream.  Requires W <= 2**15 - 1.
    """
    B, W = words.shape
    sent = torch.where(words[:, :1] == 0, -1, 0).to(torch.int32)
    prev = torch.cat([sent, words[:, :-1]], dim=1)
    kind, start = recompress_flags(words.reshape(-1), prev.reshape(-1))
    return ewah_torch.compress_from_runs(
        words, kind.reshape(B, W), start.reshape(B, W), capacity)


def ewah_decode(batch, lengths, n_words: int):
    """(B, m, C) int32 EWAH streams with (B, m) lengths -> (m, B, n_words)
    int32 word planes (plane j of query b at ``[j, b]``)."""
    B, m, C = batch.shape
    if tuple(lengths.shape) != (B, m):
        raise ValueError(f"lengths of shape {tuple(lengths.shape)} for a "
                         f"batch of shape {tuple(batch.shape)}")
    if _on_cpu(batch, lengths):
        return ref.ewah_decode(batch, lengths, n_words)
    _check_cuda("ewah_decode", batch, lengths)
    out = torch.empty(m, B, n_words, dtype=torch.int32, device=batch.device)
    if B and m and C and n_words:
        _decode.launch(batch, lengths, n_words, out)
        LAUNCHES["ewah_decode"] += 1
    elif out.numel():
        out.zero_()
    return out
