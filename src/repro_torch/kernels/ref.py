"""Plain PyTorch versions of every CUDA kernel.

The wrappers in ``ops`` run these on CPU tensors; ``chip_smoke.py`` holds
each kernel against its plain version on the card.  Words are int32
bit-views (all-ones is -1).
"""

from __future__ import annotations

import torch

from ..core import ewah_torch
from . import planfuse

_FNS = {"and": torch.bitwise_and, "or": torch.bitwise_or,
        "xor": torch.bitwise_xor}
_OP_NAMES = ("and", "or", "xor")   # tape op ids 0, 1, 2


def wordops(a, b, op="and"):
    r = _FNS[op](a, b)
    return r, ewah_torch.classify(r)


def slice_fold(stacked, ops):
    r = stacked[0]
    for i, op in enumerate(ops):
        r = _FNS[op](r, stacked[i + 1])
    return r


def plan_fuse(stacked, tape):
    """The kernel's interpretation of a tape: its host split
    (``planfuse.split``; a ``Program`` is taken as it is) run step by step
    on a slot-indexed operand stack."""
    prog = tape if isinstance(tape, planfuse.Program) else \
        planfuse.split(tape)
    st = [None] * max(prog.depth, 1)
    planes = iter(prog.pushes)
    for ins in prog.code:
        kind, op, slot = ins & 3, (ins >> 2) & 3, ins >> 4
        if kind == planfuse.LOAD:
            st[slot] = stacked[next(planes)]
        elif kind == planfuse.CNOT:
            st[slot] = torch.bitwise_not(st[slot])
        else:
            b = (stacked[next(planes)] if kind == planfuse.LOADOP
                 else st[slot + 1])
            st[slot] = _FNS[_OP_NAMES[op]](st[slot], b)
    r = st[0]
    return r, ewah_torch.classify(r)


def recompress(w, p):
    kind = ewah_torch.classify(w)
    return kind, (kind != ewah_torch.classify(p)).to(torch.int32)


def container_pairs(a, b, op="and"):
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    return a & ~b


def container_fold(buf, packed, chunk_words=2048):
    """The one-launch container fold on its packed input
    (``containers.pack_folds``; ``buf`` its int32 buffer as a tensor) ->
    (``packed.n_out``,) int32 planes.  Every step expands to its dense
    words (bitmaps gathered, array positions summed in as distinct powers
    of two, runs as a +1 / -1 prefix sum over bits), then each chunk folds
    its steps in order, all chunks at once."""
    dev, i64 = buf.device, torch.int64
    n_c, n_s = packed.n_chunks, packed.n_steps
    out = torch.zeros(packed.n_out, dtype=torch.int32, device=dev)
    if not n_c:
        return out
    chunks = buf[: 4 * n_c].reshape(n_c, 4).to(i64)
    steps = buf[packed.steps_at: packed.steps_at + 4 * n_s].reshape(
        n_s, 4).to(i64)
    words = buf[packed.words_at: packed.u16_at]
    u16 = buf[packed.u16_at:].view(torch.int16).to(i64) & 0xFFFF
    cls, op = steps[:, 0] & 3, (steps[:, 0] >> 2) & 3
    off, length = steps[:, 1], steps[:, 2]
    cols = torch.arange(chunk_words, device=dev, dtype=i64)
    dense = torch.zeros(n_s, chunk_words, dtype=i64, device=dev)
    bm = torch.nonzero(cls == 1)[:, 0]
    dense[bm] = words[off[bm, None] + cols].to(i64) & 0xFFFFFFFF
    arr = torch.nonzero(cls == 0)[:, 0]
    if len(arr):
        owner = torch.repeat_interleave(arr, length[arr])
        first = torch.cumsum(length[arr], 0) - length[arr]
        rank = torch.arange(len(owner), device=dev) - torch.repeat_interleave(
            first, length[arr])
        pos = u16[off[owner] + rank]
        flat = dense.reshape(-1)
        flat.scatter_add_(0, owner * chunk_words + (pos >> 5),
                          torch.ones_like(pos) << (pos & 31))
    run = torch.nonzero(cls == 2)[:, 0]
    if len(run):
        bits = chunk_words * 32
        owner = torch.repeat_interleave(torch.arange(len(run), device=dev),
                                        length[run])
        first = torch.cumsum(length[run], 0) - length[run]
        rank = torch.arange(len(owner), device=dev) - torch.repeat_interleave(
            first, length[run])
        at = off[run][owner] + 2 * rank
        edge = torch.zeros(len(run), bits + 1, dtype=i64, device=dev)
        one = torch.ones_like(at)
        edge.index_put_((owner, u16[at]), one, accumulate=True)
        edge.index_put_((owner, u16[at + 1] + 1), -one, accumulate=True)
        on = (torch.cumsum(edge[:, :bits], 1) > 0).to(i64)
        dense[run] = (on.reshape(len(run), chunk_words, 32)
                      << torch.arange(32, device=dev)).sum(2)
    dense = ewah_torch._to_int32_bits(dense)
    acc = torch.zeros(n_c, chunk_words, dtype=torch.int32, device=dev)
    span = chunks[:, 3] - chunks[:, 2]
    for j in range(int(span.max())):
        live = j < span
        s = torch.where(live, chunks[:, 2] + j, 0)
        w, o = dense[s], op[s][:, None]
        new = torch.where(o == 0, acc & w, torch.where(o == 1, acc | w,
                                                       acc & ~w))
        acc = torch.where(live[:, None], new, acc)
    keep = cols[None, :] < chunks[:, 1:2]
    out[(chunks[:, :1] + cols[None, :])[keep]] = acc[keep]
    return out


def container_gallop(positions, words):
    """(P, L) positions and (P, W) bitmap rows -> (P, L) 0/1 flags: bit
    ``pos & 31`` of word ``pos >> 5``; 0 for padding (-1) and for any
    position outside the row's W words."""
    n_bits = words.shape[1] * 32
    valid = (positions >= 0) & (positions < n_bits)
    safe = torch.where(valid, positions, 0)
    w = torch.gather(words, 1, (safe >> 5).long())
    hits = (w >> (safe & 31)) & 1  # arithmetic shift: bit 0 is still the bit
    return torch.where(valid, hits, 0).to(torch.int32)


def bitpack(bits):
    """(R, C) bool -> (ceil(R/32), C) words: bit j of word w is row
    32w + j; rows past R are 0."""
    R, C = bits.shape
    W = -(-R // 32)
    if R % 32:
        padded = torch.zeros(W * 32, C, dtype=torch.bool, device=bits.device)
        padded[:R] = bits
        bits = padded
    b = bits.reshape(W, 32, C)
    words = torch.zeros(W, C, dtype=torch.int64, device=bits.device)
    for j in range(32):
        words |= b[:, j].to(torch.int64) << j
    return ewah_torch._to_int32_bits(words)


def gray(x, inverse=False):
    """Gray code of int32 bit-views, or its inverse; each right shift is
    masked to be logical (torch's ``>>`` on int32 is arithmetic)."""
    if not inverse:
        return x ^ ((x >> 1) & 0x7FFFFFFF)
    for s in (1, 2, 4, 8, 16):
        x = x ^ ((x >> s) & ((1 << (32 - s)) - 1))
    return x


def histogram(vals, n_values: int):
    """(T,) int values -> (n_values,) float32 counts; values outside
    [0, n_values) land in a spare slot and are dropped."""
    valid = (vals >= 0) & (vals < n_values)
    idx = torch.where(valid, vals, n_values).long()
    counts = torch.zeros(n_values + 1, dtype=torch.int64, device=vals.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    return counts[:n_values].to(torch.float32)


def moe_route(eids, n_experts: int):
    """(T, k) expert ids -> (ceil(T/32), E) dispatch words; duplicates set
    one bit, -1 and ids >= E none."""
    T, k = eids.shape
    valid = (eids >= 0) & (eids < n_experts)
    idx = torch.where(valid, eids, n_experts).long()
    hit = torch.zeros(T, n_experts + 1, dtype=torch.bool, device=eids.device)
    hit.scatter_(1, idx, True)
    return bitpack(hit[:, :n_experts])


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


def ewah_markers(batch, lengths, n_words: int, tile: int | None):
    """Phase 1 of the decode kernel: (B, m, C) streams with (B, m) lengths
    -> the marker table (tab (R, C, 2) int32 of (position, output offset),
    tab_n (R,), tile_first (R, ceil(n_words / tile))), rows r = b * m + j.

    The kernel's algorithm, all streams at once, each stream one range
    (the kernel splits it over a cluster of blocks and walks the blocks'
    exits first).  Position i read as a
    marker has the successor next(i) = min(i + 1 + nd_i, length).  With
    windows of 32^l positions at level l, E_l(i) is the first marker of
    i's chain at or past the end of i's level-l window: pointer jumping
    clamped at the window's end (5 rounds, since a window holds at most 32
    windows of the level below).  A walk of E_n from position 0 (n levels,
    32^(n+1) >= C: at most 32 steps) gives the entry (first marker) of each
    level-n window; a walk of E_(l-1) from each level-l window's entry
    gives its subwindows' entries; a walk of next from each 32-word
    window's entry gives its markers.  An exclusive cumsum of the markers'
    clean + dirty words, clamped at n_words, gives their offsets; the table
    keeps the markers whose offset is below n_words (entries past tab_n
    are 0).  ``tile_first[r, t]`` is the last of them with offset
    <= t * tile, or -1 for an empty stream (None when ``tile`` is None).
    """
    B, m, C = batch.shape
    R = B * m
    dev = batch.device
    i64 = torch.int64
    nl = 1
    while 32 ** (nl + 1) < C:
        nl += 1
    P = -(-C // 32 ** nl) * 32 ** nl          # whole level-n windows
    s = torch.zeros(R, P, dtype=i64, device=dev)
    s[:, :C] = batch.reshape(R, C).to(i64) & 0xFFFFFFFF
    L = lengths.reshape(R).to(i64).clamp(0, C)[:, None]
    rows = torch.arange(R, dtype=i64, device=dev)[:, None]
    idx = torch.arange(P + 1, dtype=i64, device=dev)[None, :]
    nd = torch.cat([s & 0x7FFF, torch.zeros(R, 1, dtype=i64, device=dev)], 1)
    nxt = torch.where(idx < L, torch.minimum(idx + 1 + nd, L), L)

    def jump(J, level):
        """Pointer jumping clamped at each position's level window end."""
        end = torch.minimum(((idx >> 5 * level) + 1) << 5 * level, L)
        for _ in range(5):
            J = torch.where(J < end, J.gather(1, J), J)
        return J

    E = [None, jump(nxt, 1)]
    for level in range(2, nl + 1):
        E.append(jump(E[-1], level))

    def walk(x, step, end, record):
        """Follow ``step`` from every start x (-1: none) while x < end,
        calling record(active, x) at each point."""
        while True:
            act = (x >= 0) & (x < end)
            if not bool(act.any()):
                return
            record(act, x)
            x = torch.where(act, step.gather(1, x.clamp(min=0)), x)

    def entries(level):
        return torch.full((R, P >> 5 * level), -1, dtype=i64, device=dev)

    def setter(table, shift):
        def record(act, x):
            r = rows.expand_as(x)[act]
            table[r, x[act] >> shift] = x[act]
        return record

    ent = entries(nl)
    walk(torch.zeros(R, 1, dtype=i64, device=dev), E[nl], L,
         setter(ent, 5 * nl))
    for level in range(nl, 1, -1):
        sub = entries(level - 1)
        w = torch.arange(ent.shape[1], dtype=i64, device=dev)[None, :]
        walk(ent, E[level - 1], torch.minimum((w + 1) << 5 * level, L),
             setter(sub, 5 * (level - 1)))
        ent = sub
    flags = torch.zeros(R, P, dtype=torch.bool, device=dev)

    def flag(act, x):
        flags[rows.expand_as(x)[act], x[act]] = True

    w = torch.arange(ent.shape[1], dtype=i64, device=dev)[None, :]
    walk(ent, nxt, torch.minimum((w + 1) << 5, L), flag)

    mk = flags[:, :C]
    w = s[:, :C]
    nd_eff = torch.minimum(w & 0x7FFF, (L - idx[:, :C] - 1).clamp(min=0))
    c = torch.where(mk, ((w >> 15) & 0xFFFF) + nd_eff, 0)
    off = (torch.cumsum(c, 1) - c).clamp(max=n_words)
    keep = mk & (off < n_words)
    tab_n = keep.sum(1)
    rank = torch.cumsum(keep.to(i64), 1) - 1
    r, pos = keep.nonzero(as_tuple=True)
    tab = torch.zeros(R, C, 2, dtype=torch.int32, device=dev)
    tab[r, rank[r, pos], 0] = pos.to(torch.int32)
    tab[r, rank[r, pos], 1] = off[r, pos].to(torch.int32)
    if tile is None:
        return tab, tab_n.to(torch.int32), None
    k = torch.arange(C, dtype=i64, device=dev)[None, :]
    offs = torch.where(k < tab_n[:, None], tab[..., 1].to(i64), n_words + 1)
    starts = torch.arange(0, n_words, tile, dtype=i64, device=dev)
    tile_first = torch.searchsorted(
        offs.contiguous(), starts[None, :].expand(R, -1).contiguous(),
        right=True) - 1
    return tab, tab_n.to(torch.int32), tile_first.to(torch.int32)


def ewah_expand(batch, lengths, n_words: int, tab, tab_n, tile_first):
    """Phase 2 of the decode kernel: the marker table of
    :func:`ewah_markers` -> (m, B, n_words) words.  Every output word takes
    the last marker with offset <= its index (``tile_first`` only narrows
    that search in the kernel), then is the marker's clean fill, one of
    its dirty words, or 0 past the words the stream covers."""
    B, m, C = batch.shape
    R = B * m
    dev = batch.device
    i64 = torch.int64
    s = batch.reshape(R, C)
    L = lengths.reshape(R).to(i64).clamp(0, C)[:, None]
    k = torch.arange(C, dtype=i64, device=dev)[None, :]
    offs = torch.where(k < tab_n.to(i64)[:, None], tab[..., 1].to(i64),
                       n_words + 1).contiguous()
    o = torch.arange(n_words, dtype=i64, device=dev)[None, :].expand(R, -1)
    rec = torch.searchsorted(offs, o.contiguous(), right=True) - 1
    found = rec >= 0
    rec = rec.clamp(min=0)
    pos = tab[..., 0].to(i64).gather(1, rec)
    off = offs.gather(1, rec)
    w = s.gather(1, pos.clamp(0, C - 1)).to(i64) & 0xFFFFFFFF
    nc = (w >> 15) & 0xFFFF
    nd_eff = torch.minimum(w & 0x7FFF, (L - pos - 1).clamp(min=0))
    d = o - off
    dd = d - nc
    dirty = s.gather(1, (pos + 1 + dd).clamp(0, C - 1))
    fill = torch.where((w >> 31) == 1, -1, 0).to(torch.int32)
    val = torch.where(d < nc, fill,
                      torch.where((dd >= 0) & (dd < nd_eff), dirty,
                                  torch.zeros_like(dirty)))
    val = torch.where(found, val, torch.zeros_like(val))
    return val.reshape(B, m, n_words).permute(1, 0, 2).contiguous()


def popcount(w):
    """Set bits of each int32 bit-view word, as int64 (SWAR on the
    word's unsigned value)."""
    x = w.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def ewah_and_popcount(sa, la, na, sb, lb, nb):
    """The kernel's dual-cursor walk, every pair of the batch in step:
    (B, Ca) and (B, Cb) int32 streams, (B,) lengths and array sizes ->
    (count, iterations) (B,) int32.  A pair stops where the kernel's
    thread stops (a stream exhausted, a marker with no words, or the cap
    of both array sizes + 4 steps); reads clamp to the pair's array size,
    and sizes above the row width are cut to it."""
    i64 = torch.int64
    B, dev = sa.shape[0], sa.device
    rows = torch.arange(B, device=dev)
    size_a = na.to(i64).clamp(max=sa.shape[1])
    size_b = nb.to(i64).clamp(max=sb.shape[1])
    la, lb = la.to(i64), lb.to(i64)
    cap = size_a + size_b + 4

    def word(s, size, i):
        if not s.shape[1]:
            return torch.zeros(B, dtype=i64, device=dev)
        w = s[rows, torch.minimum(i, size - 1).clamp(min=0)].to(i64)
        return torch.where(size > 0, w, 0)

    def load(s, length, size, cur, active):
        i, c, t, d = cur
        can = active & (c == 0) & (d == 0) & (i < length)
        w = word(s, size, i)
        return (torch.where(can, i + 1, i),
                torch.where(can, (w >> 15) & 0xFFFF, c),
                torch.where(can, (w >> 31) & 1, t),
                torch.where(can, w & 0x7FFF, d))

    zero = torch.zeros(B, dtype=i64, device=dev)
    every = torch.ones(B, dtype=torch.bool, device=dev)
    ia, ca, ta, da = load(sa, la, size_a, (zero,) * 4, every)
    ib, cb, tb, db = load(sb, lb, size_b, (zero,) * 4, every)
    acc, it = zero.clone(), zero.clone()
    while True:
        active = ((ca > 0) | (da > 0)) & ((cb > 0) | (db > 0)) & (it < cap)
        if not bool(active.any()):
            break
        both_clean = active & (ca > 0) & (cb > 0)
        a_clean = active & (ca > 0) & (cb == 0)      # B on a dirty word
        b_clean = active & (ca == 0) & (cb > 0)      # A on a dirty word
        both_dirty = active & (ca == 0) & (cb == 0)
        n = torch.minimum(ca, cb).clamp(min=1)
        wa, wb = word(sa, size_a, ia), word(sb, size_b, ib)
        acc += (torch.where(both_clean & (ta == 1) & (tb == 1), n * 32, 0)
                + torch.where(a_clean & (ta == 1), popcount(wb), 0)
                + torch.where(b_clean & (tb == 1), popcount(wa), 0)
                + torch.where(both_dirty, popcount(wa & wb), 0))
        ca = ca - torch.where(both_clean, n, a_clean.to(i64))
        cb = cb - torch.where(both_clean, n, b_clean.to(i64))
        step_a = (both_dirty | b_clean).to(i64)
        step_b = (both_dirty | a_clean).to(i64)
        ia, da = ia + step_a, da - step_a
        ib, db = ib + step_b, db - step_b
        ia, ca, ta, da = load(sa, la, size_a, (ia, ca, ta, da), active)
        ib, cb, tb, db = load(sb, lb, size_b, (ib, cb, tb, db), active)
        it += active.to(i64)
    # the kernel's sum wraps at 32 bits, as the reference's int32 does
    return (ewah_torch._to_int32_bits(acc & 0xFFFFFFFF),
            it.to(torch.int32))


def ewah_pair_chain(s, lengths, n_words: int, tile: int):
    """Phase 1 of the wide AND-popcount route, one side: (B, C) int32
    streams with (B,) lengths -> (tab (B, C, 2), wtab (B, C), meta (B, 3),
    ptile (B, ceil(C / tile))) int32.

    ``tab`` and its count are :func:`ewah_markers`' table ((position,
    offset) of the markers whose offset is below n_words; entries past the
    count are 0), ``wtab`` the markers' words; ``meta`` = (count, W, 1 if a
    marker's dirty run passes the length), W the words before the first
    marker with no clean and no dirty word, or all of them, or n_words
    where the table is cut; ``ptile[t]`` the marker whose span [position,
    position + 1 + its dirty words) holds position ``t * tile``, else -1.
    """
    B, C = s.shape
    dev = s.device
    i64 = torch.int64
    tab, tab_n, _ = ewah_markers(s.reshape(B, 1, C), lengths.reshape(B, 1),
                                 n_words, None)
    n = tab_n.to(i64)
    valid = torch.arange(C, dtype=i64, device=dev)[None, :] < n[:, None]
    pos = tab[..., 0].to(i64)
    off = tab[..., 1].to(i64)
    wtab = torch.where(valid, s.gather(1, pos), 0)
    w = wtab.to(i64) & 0xFFFFFFFF
    nc = (w >> 15) & 0xFFFF
    nd = w & 0x7FFF
    avail = lengths.to(i64).clamp(0, C)[:, None] - pos - 1
    end = pos + 1 + torch.minimum(nd, avail)
    bad = (valid & (nd > avail)).any(1)
    empty = torch.where(valid & (nc == 0) & (nd == 0), off, n_words).amin(1)
    last = (n - 1).clamp(min=0)[:, None]
    total = torch.where(n > 0, (off + nc + end - pos - 1).gather(1, last)[:, 0],
                        0)
    W = torch.where(total < n_words, torch.minimum(empty, total), n_words)
    starts = torch.arange(0, C, tile, dtype=i64, device=dev)[None, :]
    k = torch.searchsorted(torch.where(valid, pos, 1 << 40).contiguous(),
                           starts.expand(B, -1).contiguous(), right=True) - 1
    held = (k >= 0) & (starts < end.gather(1, k.clamp(min=0)))
    ptile = torch.where(held, k, -1)
    meta = torch.stack([n, W, bad.to(i64)], 1)
    return (tab, wtab.to(torch.int32), meta.to(torch.int32),
            ptile.to(torch.int32))


def ewah_pair_tiles(sa, la, na, sb, lb, nb, table_a, table_b, n_words: int):
    """Phase 2 of the wide AND-popcount route: both sides' tables of
    :func:`ewah_pair_chain` -> (count, iterations) (B,) int32.

    For a well-formed pair, with W the smaller of the two sides' W, over
    each side's stream positions below its length: a dirty word at logical
    word p < W is one step where the other stream is clean (its popcount
    counts where that fill is 1) and, on A's side, where both are dirty
    (popcount of the AND); a marker whose clean run starts at o < W where
    the other stream is clean is one step, and adds 32 a word of the two
    runs' overlap below W where both fills are 1 (on B's side only where
    A's run started before o).  Edge pairs (a length past its array size,
    a dirty run past a length, a W of n_words) take
    :func:`ewah_and_popcount`."""
    i64 = torch.int64
    B, dev = sa.shape[0], sa.device
    size_a = na.to(i64).clamp(max=sa.shape[1])
    size_b = nb.to(i64).clamp(max=sb.shape[1])
    meta_a, meta_b = table_a[2].to(i64), table_b[2].to(i64)
    edge = ((la.to(i64) > size_a) | (lb.to(i64) > size_b)
            | (meta_a[:, 2] != 0) | (meta_b[:, 2] != 0)
            | (meta_a[:, 1] >= n_words) | (meta_b[:, 1] >= n_words))
    W = torch.minimum(meta_a[:, 1], meta_b[:, 1])[:, None]
    acc = torch.zeros(B, dtype=i64, device=dev)
    steps = torch.zeros(B, dtype=i64, device=dev)

    def markers(table, C):
        tab, wtab, meta, _ = table
        valid = (torch.arange(C, dtype=i64, device=dev)[None, :]
                 < meta[:, :1].to(i64))
        big = 1 << 40
        return (torch.where(valid, tab[..., 0].to(i64), big).contiguous(),
                torch.where(valid, tab[..., 1].to(i64), big).contiguous(),
                wtab.to(i64) & 0xFFFFFFFF)

    for side in (0, 1):
        sx, lx, tx, sy, ty = ((sa, la, table_a, sb, table_b) if side == 0
                              else (sb, lb, table_b, sa, table_a))
        C, Cy = sx.shape[1], sy.shape[1]
        posx, offx, wx = markers(tx, C)
        posy, offy, wy = markers(ty, Cy)
        i = torch.arange(C, dtype=i64, device=dev)[None, :].expand(B, -1)
        kx = (torch.searchsorted(posx, i.contiguous(), right=True) - 1
              ).clamp(min=0)
        px, ox, w = posx.gather(1, kx), offx.gather(1, kx), wx.gather(1, kx)
        ncx, fx = (w >> 15) & 0xFFFF, w >> 31
        is_mk = i == px
        q = torch.where(is_mk, ox, ox + ncx + (i - px - 1))
        live = (i < lx.to(i64)[:, None]) & ~edge[:, None] & (q < W)
        ky = (torch.searchsorted(offy, q.contiguous(), right=True) - 1
              ).clamp(min=0)
        py, oy, w = posy.gather(1, ky), offy.gather(1, ky), wy.gather(1, ky)
        ncy, fy = (w >> 15) & 0xFFFF, w >> 31
        y_clean = q < oy + ncy
        run = live & is_mk & (ncx > 0) & y_clean
        if side == 1:
            run &= oy < q
        overlap = torch.minimum(torch.minimum(q + ncx, oy + ncy), W) - q
        steps += run.sum(1)
        acc += torch.where(run & (fx == 1) & (fy == 1), 32 * overlap,
                           0).sum(1)
        dirty = live & ~is_mk
        steps += (dirty & y_clean).sum(1)
        acc += torch.where(dirty & y_clean & (fy == 1), popcount(sx),
                           0).sum(1)
        if side == 0:
            both = dirty & ~y_clean
            yw = sy.gather(1, (py + 1 + q - oy - ncy).clamp(0, Cy - 1))
            steps += both.sum(1)
            acc += torch.where(both, popcount(sx & yw), 0).sum(1)
    count = ewah_torch._to_int32_bits(acc & 0xFFFFFFFF)
    iters = steps.to(torch.int32)
    if bool(edge.any()):
        rows = edge.nonzero()[:, 0]
        count[rows], iters[rows] = ewah_and_popcount(
            sa[rows], la[rows], na[rows], sb[rows], lb[rows], nb[rows])
    return count, iters


def rowid_bits(words, n_rows: int):
    """(B, W) int32 words -> (B, 32 W) bool: bit j of word w at 32w + j,
    the bits at or past ``n_rows`` cleared."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    B, W = words.shape
    bits = ((words[..., None] >> shifts) & 1).bool().reshape(B, 32 * W)
    bits[:, n_rows:] = False
    return bits


def rowid_counts(words, n_rows: int, tile: int):
    """The count kernel: (B, W) words -> (offsets (B, T) int64, each tile
    of ``tile`` words' exclusive offset in the flat output; totals (B,)
    int64), T = ceil(W / tile)."""
    B, W = words.shape
    T = -(-W // tile)
    per_word = rowid_bits(words, n_rows).reshape(B, W, 32).sum(2)
    per_tile = torch.nn.functional.pad(per_word, (0, T * tile - W)).reshape(
        B, T, tile).sum(2)
    flat = per_tile.reshape(-1)
    offsets = (torch.cumsum(flat, 0) - flat).reshape(B, T)
    return offsets, per_tile.sum(1)


def rowid_write(words, n_rows: int):
    """The write kernel: (B, W) words -> every answer's row ids, ascending,
    the answers back to back, (N,) int64."""
    return torch.nonzero(rowid_bits(words, n_rows))[:, 1].contiguous()
