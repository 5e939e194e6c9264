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
from . import bitpack as _bitpack
from . import containers as _containers
from . import ewah_and_popcount as _and_popcount
from . import ewah_decode as _decode
from . import ewah_encode as _encode
from . import gray as _gray
from . import histmm as _histmm
from . import moe_route as _moe_route
from . import planfuse as _planfuse
from . import recompress as _recompress
from . import ref
from . import rowids as _rowids
from . import slicefold as _slicefold
from . import wordops as _wordops

#: Launches of each kernel since the last :func:`reset_launches`.
LAUNCHES = {"planfuse": 0, "recompress": 0, "wordops": 0, "slicefold": 0,
            "ewah_decode": 0, "containerops": 0, "member": 0, "bitpack": 0,
            "gray": 0, "histogram": 0, "moe_route": 0, "ewah_and_popcount": 0,
            "ewah_encode": 0, "rowids": 0}

_OP_NAMES = ("and", "or", "xor")
#: The libraries the per-stage path may launch: which of them one plan
#: reaches depends on its data (only a range reaches ``slicefold``).
PER_STAGE = ("wordops", "slicefold", "recompress", "ewah_encode")


@lru_cache(maxsize=None)
def build_per_stage() -> None:
    """Build every library of :data:`PER_STAGE` at the path's first use,
    so a later plan that reaches another of them waits on no nvcc."""
    from . import build

    build.build_all(PER_STAGE)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_dtype(name: str, t, dtype=torch.int32) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: {dtype} tensors expected, got {t.dtype}")


def _check_cuda(name: str, *tensors, dtype=torch.int32) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must all lie on the CPU or all "
                             f"on one CUDA device, got {t.device}")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on {tensors[0].device} and "
                             f"{t.device}")
        _check_dtype(name, t, dtype)
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

    Tree reduction: each level combines row i with row i + m // 2 for
    every i in one flattened ``wordops`` launch over the two contiguous
    halves (no copy), and an odd last row into row 0 with one launch more,
    so m planes fold in ceil(log2 m) levels.  and, or and xor are
    associative and commutative: any pairing gives the same words.
    """
    m, n = stacked.shape
    while m > 1:
        h = m // 2
        r, _ = wordops(stacked[:h].reshape(-1),
                       stacked[h: 2 * h].reshape(-1), op)
        r = r.reshape(h, n)
        if m % 2:
            r[0] = wordops(r[0], stacked[2 * h], op)[0]
        stacked, m = r, h
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

    ``tape`` is the stack-machine program from ``core.query.lower_plan``,
    or its host split (``planfuse.Program``, which ``TorchBackend``
    memoises per plan root); ``kind`` is the EWAH class of each result
    word (0 clean-0, 1 clean-1, 2 dirty).  Raises for a tape the kernel
    cannot run (see ``planfuse.split``).
    """
    m, n = stacked.shape
    prog = tape if isinstance(tape, _planfuse.Program) else \
        _planfuse.split(tape)
    bad = [i for i in prog.pushes if i >= m]
    if bad:
        raise ValueError(f"tape pushes plane {bad[0]} of {m}")
    if _on_cpu(stacked):
        return ref.plan_fuse(stacked, prog)
    _check_cuda("plan_fuse", stacked)
    code = _device_table(prog.code, torch.int32, stacked.device)
    pushes = _device_table(prog.pushes, torch.int32, stacked.device)
    r = torch.empty(n, dtype=torch.int32, device=stacked.device)
    kind = torch.empty(n, dtype=torch.int32, device=stacked.device)
    if n:
        _planfuse.launch(stacked, prog, code, pushes, r, kind)
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
    """(B, W) dense word rows -> (streams (B, capacity), lengths (B,),
    overflow (B,)), as :func:`ewah_encode` gives them.

    Rows get an opposite-class sentinel as word 0's predecessor, so runs
    never bleed across rows; one recompress launch classifies the whole
    batch, then :func:`ewah_encode` writes every row's stream, at any W.
    """
    B, W = words.shape
    sent = torch.where(words[:, :1] == 0, -1, 0).to(torch.int32)
    prev = torch.cat([sent, words[:, :-1]], dim=1)
    kind, _ = recompress_flags(words.reshape(-1), prev.reshape(-1))
    return ewah_encode(words, kind.reshape(B, W), capacity)


def ewah_encode(words, kind, capacity: int):
    """(B, n) int32 words and their EWAH classes (0 clean-0, 1 clean-1,
    2 dirty) -> each row's canonical EWAH stream, bit-identical to
    ``ewah.compress`` at any n: (streams (B, capacity), lengths (B,),
    overflow (B,)) int32.

    ``overflow`` is 1 for a row whose stream splits a clean run at
    ``MAX_CLEAN`` or a dirty run at ``MAX_DIRTY``.
    ``ewah_torch.stream_capacity(n)`` words hold any n-word row; words past
    ``capacity`` are dropped, and a length stays its whole stream's.
    Stream words past a row's length are unspecified.  The three results
    are views, in this order, of one buffer (:func:`encoded_flat`), so one
    copy brings them to the host.  The two kernels of ``ewah_encode.cu``
    on a CUDA tensor, one count a call; ``ewah_torch.compress_from_runs``
    on a CPU tensor.
    """
    if words.dim() != 2 or words.shape != kind.shape:
        raise ValueError(f"ewah_encode: (B, n) words and classes expected, "
                         f"got {tuple(words.shape)} and {tuple(kind.shape)}")
    B, n = words.shape
    if not (0 <= n < 2**30 and 0 <= capacity < 2**31):
        raise ValueError(f"ewah_encode: n {n} outside [0, 2**30) or "
                         f"capacity {capacity} outside [0, 2**31)")
    flat = torch.empty(B * (capacity + 2), dtype=torch.int32,
                       device=words.device)
    streams, lengths, overflow = split_encoded(flat, B, capacity)
    if _on_cpu(words, kind):
        for out, part in zip((streams, lengths, overflow),
                             ewah_torch.compress_from_runs(words, kind,
                                                           capacity)):
            out.copy_(part)
        return streams, lengths, overflow
    _check_cuda("ewah_encode", words, kind)
    if B > 65535:
        raise ValueError(f"ewah_encode: {B} rows, at most 65,535 a call")
    if B and n:
        _encode.launch(words, kind, capacity, streams, lengths, overflow)
        LAUNCHES["ewah_encode"] += 1
    else:
        flat.zero_()
    return streams, lengths, overflow


def encoded_flat(streams):
    """The one buffer behind :func:`ewah_encode`'s results, from its
    ``streams``: (B * (capacity + 2),) int32, the streams, then the
    lengths, then the overflow flags."""
    B, C = streams.shape
    return streams.as_strided((B * (C + 2),), (1,))


def split_encoded(flat, B: int, capacity: int):
    """:func:`encoded_flat`'s buffer (a tensor or, on the host, an array)
    -> (streams (B, capacity), lengths (B,), overflow (B,))."""
    return (flat[: B * capacity].reshape(B, capacity),
            flat[B * capacity: B * (capacity + 1)],
            flat[B * (capacity + 1):])


def rowids(words, n_rows: int):
    """(B, W) int32 answer words -> (ids, totals): every answer's set bits
    below ``n_rows`` as int64 row ids, ascending, the answers back to back
    in one (N,) tensor on the words' device (answer b's ids at
    ``totals[:b].sum()``), and each answer's count (B,) int64 on the host.
    What ``np.flatnonzero(ewah.unpack_bits(words[b], n_rows))`` gives for
    each b.  :func:`rowid_counts`, the totals' copy, then
    :func:`rowid_write`."""
    offsets, totals = rowid_counts(words, n_rows)
    totals = totals.cpu()
    return rowid_write(words, n_rows, offsets, int(totals.sum())), totals


def rowid_counts(words, n_rows: int):
    """The first phase of :func:`rowids`: (B, W) int32 words ->
    (offsets (B, T) int64, the exclusive offset of each tile of
    ``kernels/rowids.TILE`` words in the flat output; totals (B,) int64,
    each answer's ids), on the words' device; one count a call."""
    B, W = _check_rowid_args(words, n_rows)
    if _on_cpu(words):
        return ref.rowid_counts(words, n_rows, _rowids.TILE)
    _check_cuda("rowids", words)
    if B > 65535:
        raise ValueError(f"rowids: {B} answers, at most 65,535 a call")
    T = _rowids.n_tiles(W)
    # the offsets, the totals, then the last-block counter
    buf = torch.empty(B * T + B + 1, dtype=torch.int64, device=words.device)
    offsets, totals = buf[: B * T].view(B, T), buf[B * T: B * T + B]
    if B and W:
        _rowids.launch_count(words, n_rows, offsets, totals, buf[B * T + B:])
        LAUNCHES["rowids"] += 1
    else:
        buf.zero_()
    return offsets, totals


def rowid_write(words, n_rows: int, offsets, n_ids: int):
    """The second phase of :func:`rowids`: the words, :func:`rowid_counts`'
    offsets and the sum of its totals -> (n_ids,) int64 row ids on the
    words' device; one count a call."""
    B, W = _check_rowid_args(words, n_rows)
    if tuple(offsets.shape) != (B, _rowids.n_tiles(W)):
        raise ValueError(f"rowid_write: offsets of shape "
                         f"{tuple(offsets.shape)} for words of shape "
                         f"{(B, W)}")
    if _on_cpu(words, offsets):
        ids = ref.rowid_write(words, n_rows)
        if len(ids) != n_ids:
            raise ValueError(f"rowid_write: {len(ids)} ids, not {n_ids}")
        return ids
    _check_cuda("rowids", words)
    _check_cuda("rowids", offsets, dtype=torch.int64)
    ids = torch.empty(n_ids, dtype=torch.int64, device=words.device)
    if n_ids:
        _rowids.launch_write(words, n_rows, offsets, ids)
        LAUNCHES["rowids"] += 1
    return ids


def _check_rowid_args(words, n_rows):
    if words.dim() != 2:
        raise ValueError(f"rowids: (B, W) words expected, got shape "
                         f"{tuple(words.shape)}")
    _check_dtype("rowids", words)
    B, W = words.shape
    if not (W < 2**26 and 0 <= n_rows <= 32 * W):
        raise ValueError(f"rowids: {n_rows} rows in {W} words (at most "
                         f"32 a word, under 2**26 words)")
    return B, W


def ewah_decode(batch, lengths, n_words: int):
    """(B, m, C) int32 EWAH streams with (B, m) lengths -> (m, B, n_words)
    int32 word planes (plane j of query b at ``[j, b]``): the marker
    kernel, then the expansion kernel, one count a call."""
    B, m, C = _check_decode_args(batch, lengths, n_words)
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


def ewah_markers(batch, lengths, n_words: int):
    """The decode's first phase alone: -> (tab (R, C, 2), tab_n (R,),
    tile_first (R, n_tiles)) int32 (see ``kernels/ewah_decode.py``; table
    entries past a row's count are unspecified)."""
    B, m, C = _check_decode_args(batch, lengths, n_words)
    if _on_cpu(batch, lengths):
        return ref.ewah_markers(batch, lengths, n_words, _decode.TILE)
    _check_cuda("ewah_decode", batch, lengths)
    if not (B and m and C and n_words):
        raise ValueError("ewah_markers: empty batch")
    tab, tab_n, tile_first = _decode.table(batch, n_words)
    _decode.launch_markers(batch, lengths, n_words, tab, tab_n, tile_first)
    LAUNCHES["ewah_decode"] += 1
    return tab, tab_n, tile_first


def ewah_expand(batch, lengths, n_words: int, tab, tab_n, tile_first):
    """The decode's second phase alone: a marker table -> (m, B, n_words)
    int32 planes."""
    B, m, C = _check_decode_args(batch, lengths, n_words)
    if _on_cpu(batch, lengths, tab, tab_n, tile_first):
        return ref.ewah_expand(batch, lengths, n_words, tab, tab_n,
                               tile_first)
    _check_cuda("ewah_decode", batch, lengths, tab, tab_n, tile_first)
    R, T = B * m, _decode.n_tiles(n_words)
    if (tuple(tab.shape) != (R, C, 2) or tuple(tab_n.shape) != (R,)
            or tuple(tile_first.shape) != (R, T)):
        raise ValueError("ewah_expand: a table of shapes "
                         f"{(R, C, 2)}, {(R,)}, {(R, T)} expected")
    if not (B and m and C and n_words):
        raise ValueError("ewah_expand: empty batch")
    out = torch.empty(m, B, n_words, dtype=torch.int32, device=batch.device)
    _decode.launch_expand(batch, lengths, n_words, tab, tab_n, tile_first,
                          out)
    LAUNCHES["ewah_decode"] += 1
    return out


def _check_decode_args(batch, lengths, n_words):
    B, m, C = batch.shape
    if tuple(lengths.shape) != (B, m):
        raise ValueError(f"lengths of shape {tuple(lengths.shape)} for a "
                         f"batch of shape {tuple(batch.shape)}")
    if not 0 <= n_words < 2**30:
        raise ValueError(f"n_words {n_words} outside [0, 2**30)")
    return B, m, C


def container_pairs(a, b, op="and"):
    """Batched Roaring-container merge in word space: (P, W) pairs ->
    (P, W) with ``op`` in {"and", "or", "andnot"}: the pairwise form of
    the one-launch fold kernel (two bitmap steps a chunk), the
    counterpart of the reference wrapper of the same name (W =
    ``containers.CHUNK_WORDS`` for whole chunks).  ``TorchBackend`` folds
    through :func:`container_fold` instead."""
    if op not in _containers.OPS:
        raise ValueError(f"unknown container merge op {op!r}")
    if a.shape != b.shape:
        raise ValueError(f"container_pairs: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    if _on_cpu(a, b):
        return ref.container_pairs(a, b, op)
    _check_cuda("container_pairs", a, b)
    out = torch.empty_like(a)
    if a.numel():
        _containers.launch_pairs(a.reshape(-1, a.shape[-1]),
                                 b.reshape(-1, a.shape[-1]), op, out)
        LAUNCHES["containerops"] += 1
    return out


def container_fold(buf, packed):
    """Whole container folds in one launch: ``packed`` from
    ``containers.pack_folds``, ``buf`` its int32 buffer as a tensor ->
    (``packed.n_out``,) int32 dense planes, fold f's W words at
    ``packed.planes[f]``."""
    _check_dtype("container_fold", buf)
    if tuple(buf.shape) != packed.buf.shape:
        raise ValueError(f"container_fold: buffer of shape "
                         f"{tuple(buf.shape)} for a packing of "
                         f"{packed.buf.shape}")
    if _on_cpu(buf):
        return ref.container_fold(buf, packed)
    _check_cuda("container_fold", buf)
    out = torch.zeros(packed.n_out, dtype=torch.int32, device=buf.device)
    if packed.n_chunks:
        _containers.launch_fold(buf, packed, out)
        LAUNCHES["containerops"] += 1
    return out


def container_gallop(positions, words):
    """Array-with-bitmap membership for a batch of chunk pairs.

    ``positions``: (P, L) int32 local chunk positions, right-padded with
    -1.  ``words``: (P, W) int32 bitmap rows (W =
    ``containers.CHUNK_WORDS`` in the backend).  Returns (P, L) int32
    flags: 1 where the bitmap holds the position, 0 for misses and
    padding.  The kernel gathers each position's word itself.  The
    counterpart of the reference wrapper of the same name;
    ``TorchBackend`` intersects arrays with bitmaps inside
    :func:`container_fold` instead.
    """
    if positions.dim() != 2 or words.dim() != 2 or \
            positions.shape[0] != words.shape[0]:
        raise ValueError(f"container_gallop: positions "
                         f"{tuple(positions.shape)} and words "
                         f"{tuple(words.shape)} do not pair up")
    if _on_cpu(positions, words):
        return ref.container_gallop(positions, words)
    _check_cuda("container_gallop", positions, words)
    out = torch.empty_like(positions)
    if positions.numel() and words.shape[1]:
        _containers.launch_member(positions, words, out)
        LAUNCHES["member"] += 1
    elif out.numel():
        out.zero_()
    return out


def bitpack(bits):
    """(R, C) booleans -> (ceil(R/32), C) int32 words: bit j of word w is
    ``bits[32w + j]``, rows past R are 0 (the paper's "wordize" step).

    Takes ``torch.bool`` only and raises on any other dtype: the reference
    packs with a shifted sum after ``astype(uint32)``, so a value above 1
    would carry into the neighbouring bits.  Every caller passes booleans.
    """
    if bits.dim() != 2:
        raise ValueError(f"bitpack: (R, C) bits expected, got shape "
                         f"{tuple(bits.shape)}")
    _check_dtype("bitpack", bits, torch.bool)
    if _on_cpu(bits):
        return ref.bitpack(bits)
    _check_cuda("bitpack", bits, dtype=torch.bool)
    R, C = bits.shape
    words = torch.empty(-(-R // 32), C, dtype=torch.int32, device=bits.device)
    if bits.numel():
        _bitpack.launch(bits, words)
        LAUNCHES["bitpack"] += 1
    return words


def gray(x, inverse=False):
    """int32 bit-views of uint32 words -> their Gray codes (``inverse``:
    back to binary).  Shifts are logical, as on the reference's uint32."""
    _check_dtype("gray", x)
    if _on_cpu(x):
        return ref.gray(x, inverse)
    _check_cuda("gray", x)
    out = torch.empty_like(x)
    if x.numel():
        _gray.launch(x, inverse, out)
        LAUNCHES["gray"] += 1
    return out


def histogram(vals, n_values: int):
    """(T,) int32 values -> (n_values,) float32 counts.  Values outside
    [0, n_values) are dropped, as the reference kernel's wrapper drops
    them (its padding slots); counts are exact integers, identical to the
    reference's float32 sums below 2**24."""
    if vals.dim() != 1:
        raise ValueError(f"histogram: (T,) values expected, got shape "
                         f"{tuple(vals.shape)}")
    if n_values < 1:
        raise ValueError(f"histogram: n_values must be >= 1, got {n_values}")
    _check_dtype("histogram", vals)
    if _on_cpu(vals):
        return ref.histogram(vals, n_values)
    _check_cuda("histogram", vals)
    out = _histmm.launch(vals, n_values)
    LAUNCHES["histogram"] += 1
    return out


def moe_route_bitmap(eids, n_experts: int):
    """(T, k) int32 top-k expert ids -> (ceil(T/32), n_experts) int32
    dispatch words: bit j of ``words[w, e]`` is set iff expert e is among
    the ids of token 32w + j.  A duplicate id sets one bit; -1 and ids
    >= n_experts set none."""
    if eids.dim() != 2:
        raise ValueError(f"moe_route_bitmap: (T, k) ids expected, got shape "
                         f"{tuple(eids.shape)}")
    if n_experts < 1:
        raise ValueError(f"moe_route_bitmap: n_experts must be >= 1, got "
                         f"{n_experts}")
    _check_dtype("moe_route_bitmap", eids)
    if _on_cpu(eids):
        return ref.moe_route(eids, n_experts)
    _check_cuda("moe_route_bitmap", eids)
    T, k = eids.shape
    words = torch.empty(-(-T // 32), n_experts, dtype=torch.int32,
                        device=eids.device)
    if T and k:
        _moe_route.launch(eids, words)
        LAUNCHES["moe_route"] += 1
    elif words.numel():
        words.zero_()
    return words


def ewah_and_popcount(sa, la, na, sb, lb, nb):
    """Popcount of A AND B for a batch of EWAH stream pairs, with the
    reference's dual-cursor walk's step count: ``sa`` (B, Ca) and ``sb``
    (B, Cb) int32 streams, right-padded; ``la``/``lb`` (B,) int32 stream
    lengths; ``na``/``nb`` (B,) int32 array sizes, the sizes of the arrays
    the reference would be given (they set its step cap and where its
    reads clamp; sizes above the row width are cut to it) -> (count,
    iterations), (B,) int32 each.

    Rows at most ``SHORT_WIDTH`` words wide (``kernels/ewah_and_popcount
    .py``) take one launch, a thread a pair; wider ones two
    (:func:`ewah_pair_chain`, :func:`ewah_pair_tiles`), the pairs that are
    not well formed walked inside the second.  On the CPU the same routes
    take the plain versions."""
    B = _check_pairs(sa, la, na, sb, lb, nb)
    if B and not _and_popcount.is_short(sa, sb):
        return ewah_pair_tiles(sa, la, na, sb, lb, nb,
                               *ewah_pair_chain(sa, la, sb, lb))
    if _on_cpu(sa, la, na, sb, lb, nb):
        return ref.ewah_and_popcount(sa, la, na, sb, lb, nb)
    _check_cuda("ewah_and_popcount", sa, la, na, sb, lb, nb)
    count = torch.empty(B, dtype=torch.int32, device=sa.device)
    iters = torch.empty(B, dtype=torch.int32, device=sa.device)
    if B:
        _and_popcount.launch(sa, la, na, sb, lb, nb, count, iters)
        LAUNCHES["ewah_and_popcount"] += 1
    return count, iters


def ewah_pair_chain(sa, la, sb, lb):
    """The wide route's first phase alone: both sides' marker tables
    (``kernels/ewah_and_popcount.py`` describes them)."""
    if sa.dim() != 2 or sb.dim() != 2 or sa.shape[0] != sb.shape[0]:
        raise ValueError(f"ewah_pair_chain: streams {tuple(sa.shape)} and "
                         f"{tuple(sb.shape)} do not pair up")
    N, T = _and_popcount.N_WORDS, _and_popcount.TILE
    if _on_cpu(sa, la, sb, lb):
        return (ref.ewah_pair_chain(sa, la, N, T),
                ref.ewah_pair_chain(sb, lb, N, T))
    _check_cuda("ewah_and_popcount", sa, la, sb, lb)
    if not (sa.shape[0] and sa.shape[1] and sb.shape[1]):
        raise ValueError("ewah_pair_chain: empty batch")
    table_a, table_b = _and_popcount.tables(sa), _and_popcount.tables(sb)
    _and_popcount.launch_chain(sa, la, sb, lb, table_a, table_b)
    LAUNCHES["ewah_and_popcount"] += 1
    return table_a, table_b


def ewah_pair_tiles(sa, la, na, sb, lb, nb, table_a, table_b):
    """The wide route's second phase alone: both sides' tables ->
    (count, iterations) (B,) int32."""
    B = _check_pairs(sa, la, na, sb, lb, nb)
    tables = (*table_a, *table_b)
    if _on_cpu(sa, la, na, sb, lb, nb, *tables):
        return ref.ewah_pair_tiles(sa, la, na, sb, lb, nb, table_a, table_b,
                                   _and_popcount.N_WORDS)
    _check_cuda("ewah_and_popcount", sa, la, na, sb, lb, nb, *tables)
    for s, (tab, wtab, meta, ptile) in ((sa, table_a), (sb, table_b)):
        C = s.shape[1]
        if (tuple(tab.shape) != (B, C, 2) or tuple(wtab.shape) != (B, C)
                or tuple(meta.shape) != (B, 3) or tuple(ptile.shape)
                != (B, _and_popcount.n_tiles(C))):
            raise ValueError("ewah_pair_tiles: tables do not fit the streams")
    if not (B and sa.shape[1] and sb.shape[1]):
        raise ValueError("ewah_pair_tiles: empty batch")
    out = torch.zeros(2, B, dtype=torch.int32, device=sa.device)
    _and_popcount.launch_tiles(sa, la, na, sb, lb, nb, table_a, table_b,
                               out[0], out[1])
    LAUNCHES["ewah_and_popcount"] += 1
    return out[0], out[1]


def _check_pairs(sa, la, na, sb, lb, nb):
    if sa.dim() != 2 or sb.dim() != 2 or sa.shape[0] != sb.shape[0]:
        raise ValueError(f"ewah_and_popcount: streams {tuple(sa.shape)} and "
                         f"{tuple(sb.shape)} do not pair up")
    B = sa.shape[0]
    for name, t in (("la", la), ("na", na), ("lb", lb), ("nb", nb)):
        if tuple(t.shape) != (B,):
            raise ValueError(f"ewah_and_popcount: {name} of shape "
                             f"{tuple(t.shape)} for {B} pairs")
    return B
