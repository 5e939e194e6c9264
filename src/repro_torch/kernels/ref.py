"""Plain PyTorch versions of every CUDA kernel.

The wrappers in ``ops`` run these on CPU tensors; ``chip_smoke.py`` holds
each kernel against its plain version on the card.  Words are int32
bit-views (all-ones is -1).
"""

from __future__ import annotations

import torch

from ..core import ewah_torch
from .planfuse import NOT, OP_AND, OP_OR, PUSH

_FNS = {"and": torch.bitwise_and, "or": torch.bitwise_or,
        "xor": torch.bitwise_xor}


def wordops(a, b, op="and"):
    r = _FNS[op](a, b)
    return r, ewah_torch.classify(r)


def slice_fold(stacked, ops):
    r = stacked[0]
    for i, op in enumerate(ops):
        r = _FNS[op](r, stacked[i + 1])
    return r


def plan_fuse(stacked, tape):
    stack = []
    for opcode, arg in tape:
        if opcode == PUSH:
            stack.append(stacked[arg])
        elif opcode == NOT:
            stack.append(torch.bitwise_not(stack.pop()))
        else:
            b = stack.pop()
            a = stack.pop()
            fn = (torch.bitwise_and if arg == OP_AND else
                  torch.bitwise_or if arg == OP_OR else torch.bitwise_xor)
            stack.append(fn(a, b))
    r = stack.pop()
    return r, ewah_torch.classify(r)


def recompress(w, p):
    kind = ewah_torch.classify(w)
    return kind, (kind != ewah_torch.classify(p)).to(torch.int32)


def ewah_decode(batch, lengths, n_words: int):
    """(B, m, C) EWAH streams with (B, m) lengths -> (m, B, n_words) words.

    A loop over markers, all streams at once: step k reads every stream's
    k-th marker and records its clean-1 run as +1/-1 events over the output
    and its dirty run as a shift over the input positions; one cumsum and
    one scatter then place every word.  Same semantics as the reference's
    scan: entries at or past ``length`` are ignored and output positions
    at or past ``n_words`` are dropped.
    """
    B, m, C = batch.shape
    dev = batch.device
    i64 = torch.int64
    s = batch.permute(1, 0, 2).reshape(m * B, C)      # row j * B + b
    L = lengths.permute(1, 0).reshape(-1).to(i64).clamp(0, C)
    R = m * B
    pos = torch.zeros(R, dtype=i64, device=dev)      # next marker
    opos = torch.zeros(R, dtype=i64, device=dev)     # next output word
    fill = torch.zeros(R, n_words + 2, dtype=i64, device=dev)
    shift = torch.zeros(R, C + 1, dtype=i64, device=dev)
    inrun = torch.zeros(R, C + 1, dtype=i64, device=dev)
    while True:
        active = (pos < L) & (opos < n_words)
        if not bool(active.any()):
            break
        w = s.gather(1, pos.clamp(max=C - 1)[:, None])[:, 0].to(i64)
        w = w & 0xFFFFFFFF
        ctype = (w >> 31) & 1
        nclean = (w >> 15) & 0xFFFF
        ndirty = w & 0x7FFF
        nd_eff = torch.minimum(ndirty, (L - pos - 1).clamp(min=0))
        # clean-1 run [opos, opos + nclean), clipped to the output
        on = active & (ctype == 1)
        c0 = torch.where(on, opos, n_words + 1).clamp(max=n_words + 1)
        c1 = torch.where(on, opos + nclean, n_words + 1).clamp(max=n_words + 1)
        fill.scatter_add_(1, c0[:, None], torch.ones_like(c0)[:, None])
        fill.scatter_add_(1, c1[:, None], -torch.ones_like(c1)[:, None])
        # dirty run: input [pos + 1, pos + 1 + nd_eff) -> output opos + nclean
        d = active & (nd_eff > 0)
        i0 = torch.where(d, pos + 1, C)
        i1 = torch.where(d, pos + 1 + nd_eff, C)
        delta = (opos + nclean) - (pos + 1)
        shift.scatter_add_(1, i0[:, None], delta[:, None])
        shift.scatter_add_(1, i1[:, None], -delta[:, None])
        inrun.scatter_add_(1, i0[:, None], torch.ones_like(i0)[:, None])
        inrun.scatter_add_(1, i1[:, None], -torch.ones_like(i1)[:, None])
        opos = torch.where(active, opos + nclean + nd_eff, opos)
        pos = torch.where(active, pos + 1 + ndirty, pos)
    idx = torch.arange(C, dtype=i64, device=dev)
    dst = idx[None, :] + torch.cumsum(shift[:, :C], dim=1)
    is_dirty = torch.cumsum(inrun[:, :C], dim=1) > 0
    dst = torch.where(is_dirty & (dst < n_words), dst, n_words)
    out = torch.zeros(R, n_words + 1, dtype=torch.int32, device=dev)
    out.scatter_(1, dst, s)
    ones = torch.cumsum(fill[:, :n_words], dim=1) > 0
    out = torch.where(ones, torch.full_like(out[:, :n_words], -1),
                      out[:, :n_words])
    return out.reshape(m, B, n_words)
