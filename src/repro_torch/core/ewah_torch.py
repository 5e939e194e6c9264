"""Batched EWAH codec on torch tensors: classify / compress / size / decode.

Port of the reference package's in-graph codec (``repro.core.ewah_jax``).
Torch has no ``vmap``, so every function here takes a batch of rows
``(B, n)`` and returns one result per row.  Compression is the same
classify -> run labelling -> exclusive scan -> scatter recipe, with
``jax.ops.segment_*`` replaced by ``scatter_reduce``/``scatter_add`` over
row-offset segment ids.  Decompression is the hand-written
``ewah_decode`` CUDA kernel on the device (``kernels.ops.ewah_decode``);
the reference's ``lax.scan`` has no torch counterpart.

Words are ``int32`` bit-views of the uint32 EWAH words: all-ones is -1,
and every right shift is masked.  Offsets and indices are int64.

Restriction (asserted): one marker per (clean, dirty) group, i.e. at most
``MAX_DIRTY`` words per row, exactly as in the reference.
"""

from __future__ import annotations

import torch

from .ewah import MAX_DIRTY

# clean-1 word as an int32 bit-view
FULL = -1


def classify(words: torch.Tensor) -> torch.Tensor:
    """0 = clean-0, 1 = clean-1, 2 = dirty (int32, same shape)."""
    kind = torch.full_like(words, 2, dtype=torch.int32)
    kind[words == 0] = 0
    kind[words == FULL] = 1
    return kind


def run_starts(kind: torch.Tensor) -> torch.Tensor:
    """Run-start flags of each row: word 0 always opens a run, then any
    change of class."""
    start = torch.ones_like(kind, dtype=torch.int32)
    start[:, 1:] = (kind[:, 1:] != kind[:, :-1]).to(torch.int32)
    return start


def compress(words: torch.Tensor, capacity: int):
    """EWAH-compress each row of ``words`` (B, n) int32.

    Returns (streams (B, capacity) int32, lengths (B,) int64).
    """
    kind = classify(words)
    return compress_from_runs(words, kind, run_starts(kind), capacity)


def _segment(values, seg, n_seg, reduce):
    """Segment reduction over flattened row-offset ids (empty segments
    give 0; every caller masks them)."""
    out = torch.zeros(n_seg, dtype=values.dtype, device=values.device)
    if reduce == "sum":
        return out.scatter_add_(0, seg, values)
    return out.scatter_reduce_(0, seg, values, reduce, include_self=True)


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """Wrap int64 values in [0, 2**32) to their int32 bit-view."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def compress_from_runs(words: torch.Tensor, kind: torch.Tensor,
                       start: torch.Tensor, capacity: int):
    """Scan/scatter epilogue of the vectorized compressor, batched.

    ``words``, ``kind`` (0/1/2 per word) and ``start`` (run-start flags,
    ``start[:, 0] == 1``) are (B, n).  They come from :func:`classify` +
    :func:`run_starts`, from the recompress kernel, or from the fused
    planfuse kernel's ``kind``.  Returns (streams (B, capacity) int32,
    lengths (B,) int64).
    """
    B, n = words.shape
    assert n <= MAX_DIRTY, f"vectorized path supports <= {MAX_DIRTY} words"
    dev = words.device
    i64 = torch.int64
    idx = torch.arange(n, device=dev, dtype=i64)
    row_off = (torch.arange(B, device=dev, dtype=i64) * n)[:, None]

    run_id = torch.cumsum(start.to(i64), dim=1) - 1            # (B, n)
    n_runs = run_id[:, -1:] + 1                                # (B, 1)
    seg = (run_id + row_off).reshape(-1)
    run_kind = _segment(kind.to(i64).reshape(-1), seg, B * n,
                        "amax").reshape(B, n)
    run_len = _segment(torch.ones(B * n, dtype=i64, device=dev), seg,
                       B * n, "sum").reshape(B, n)
    run_valid = idx[None, :] < n_runs

    # groups: every clean run opens a group; a leading dirty run opens one
    run_is_clean = run_kind < 2
    grp_start = run_is_clean | (idx == 0)[None, :]
    grp_of_run = torch.cumsum((grp_start & run_valid).to(i64), dim=1) - 1
    last_run = torch.clamp(n_runs - 1, min=0)
    n_groups = torch.clamp(grp_of_run.gather(1, last_run) + 1, min=1)

    gseg = (grp_of_run + row_off).reshape(-1)
    clean_valid = run_is_clean & run_valid
    grp_nclean = _segment(torch.where(clean_valid, run_len, 0).reshape(-1),
                          gseg, B * n, "sum").reshape(B, n)
    grp_ndirty = _segment(
        torch.where(~run_is_clean & run_valid, run_len, 0).reshape(-1),
        gseg, B * n, "sum").reshape(B, n)
    grp_ctype = _segment(torch.where(clean_valid, run_kind, 0).reshape(-1),
                         gseg, B * n, "amax").reshape(B, n)

    grp_live = idx[None, :] < n_groups
    grp_size = torch.where(grp_live, 1 + grp_ndirty, 0)
    grp_off = torch.cumsum(grp_size, dim=1) - grp_size        # exclusive
    last_grp = torch.clamp(n_groups - 1, min=0)
    total = (grp_off.gather(1, last_grp)
             + grp_size.gather(1, last_grp)).reshape(B)

    # markers, assembled in int64 and wrapped to the int32 bit-view
    marker = _to_int32_bits((grp_ctype << 31) | (grp_nclean << 15)
                            | grp_ndirty)
    out = torch.zeros(B, capacity + 1, dtype=torch.int32, device=dev)
    # slot ``capacity`` is the spare that takes every dropped write
    mpos = torch.where(grp_live & (grp_off < capacity), grp_off, capacity)
    out.scatter_(1, mpos, marker)

    # dirty word i goes to grp_off[g] + 1 + its rank inside its dirty run
    word_grp = grp_of_run.gather(1, run_id)
    run_first = torch.cummax(torch.where(start.bool(), idx[None, :], 0),
                             dim=1).values
    t = idx[None, :] - run_first
    dpos = grp_off.gather(1, word_grp) + 1 + t
    dpos = torch.where((kind == 2) & (dpos < capacity), dpos, capacity)
    out.scatter_(1, dpos, words.to(torch.int32))
    return out[:, :capacity], total


def compressed_size(words: torch.Tensor) -> torch.Tensor:
    """Compressed size in words of each row (markers + dirty), (B,) int64.

    Exact for rows within the single-marker-per-group restriction.
    """
    kind = classify(words)
    start = run_starts(kind).bool()
    n_clean_runs = (start & (kind < 2)).sum(dim=1)
    lead_dirty = (kind[:, 0] == 2).to(torch.int64)
    n_groups = torch.clamp(n_clean_runs + lead_dirty, min=1)
    return n_groups + (kind == 2).sum(dim=1)


def decompress(streams: torch.Tensor, lengths: torch.Tensor, n_words: int):
    """Expand EWAH streams (R, C) int32 with lengths (R,) into (R, n_words)
    int32 words: the ``ewah_decode`` kernel on a CUDA tensor, its plain
    version on a CPU tensor."""
    from ..kernels import ops

    R = streams.shape[0]
    planes = ops.ewah_decode(streams.reshape(R, 1, -1),
                             lengths.reshape(R, 1), n_words)
    return planes.reshape(R, n_words)
