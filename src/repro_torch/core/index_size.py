"""Exact EWAH index sizes without materializing bitmaps.

The paper's Algorithm 1 builds a compressed index in O(nck + L) by touching
only dirtied bitmaps per 32-row block.  This module computes the *size* of
that index (markers + verbatim words, per bitmap) with the same complexity,
which lets the benchmarks reproduce the paper's size tables (Tables 3-4,
Figs. 4-5) on multi-million-row tables without allocating n*L bits.

Verified against the dense oracle (``ewah.compress`` of fully materialized
bitmaps) in tests/test_index_size.py.
"""

from __future__ import annotations

import numpy as np

from .ewah import MAX_CLEAN, MAX_DIRTY, WORD_BITS


def _ceil_div(a, b):
    return -(-a // b)


def column_bitmap_sizes(
    col: np.ndarray, codes: np.ndarray, n_bitmaps: int
) -> tuple[np.ndarray, int, int]:
    """Exact per-bitmap EWAH sizes for one table column.

    Args:
      col: (n,) int array of 0-based attribute-value ids, in *table row order*.
      codes: (n_values, k) int array; value v sets bitmaps ``codes[v]``.
      n_bitmaps: number of bitmaps L for this column (the N of k-of-N).

    Returns:
      (sizes, total_markers, total_dirty) where sizes is (n_bitmaps,) int64
      EWAH word counts (markers + verbatim) per bitmap, including trailing
      clean runs so all bitmaps represent exactly n rows (Algorithm 1 does
      the same).
    """
    col = np.asarray(col)
    n = len(col)
    codes = np.asarray(codes, dtype=np.int64)
    k = codes.shape[1]
    n_blocks = _ceil_div(n, WORD_BITS)

    # --- (block, value) occupancy counts ---------------------------------
    block = np.arange(n, dtype=np.int64) // WORD_BITS
    n_vals = codes.shape[0]
    bv_key = block * n_vals + col.astype(np.int64)
    bv_unique, bv_counts = np.unique(bv_key, return_counts=True)
    blk_v = bv_unique // n_vals
    val_v = bv_unique % n_vals

    # --- expand to (block, bitmap) events, merging values sharing bitmaps --
    bmaps = codes[val_v]  # (m, k)
    ev_block = np.repeat(blk_v, k)
    ev_bitmap = bmaps.reshape(-1)
    ev_count = np.repeat(bv_counts, k)
    key = ev_bitmap * n_blocks + ev_block  # sorted-by-(bitmap, block) later
    uniq, inv = np.unique(key, return_inverse=True)
    counts = np.zeros(len(uniq), dtype=np.int64)
    np.add.at(counts, inv, ev_count)
    bm = uniq // n_blocks
    blk = uniq % n_blocks
    # clean-1 word iff all 32 rows of a *full* block set this bitmap
    is_c1 = counts == WORD_BITS
    is_dirty = ~is_c1

    sizes = np.zeros(n_bitmaps, dtype=np.int64)
    total_dirty = int(is_dirty.sum())
    np.add.at(sizes, bm[is_dirty], 1)  # verbatim words

    # --- run structure (events are sorted by bitmap, then block) ----------
    m = len(bm)
    markers = 0
    if m:
        first = np.empty(m, dtype=bool)
        first[0] = True
        first[1:] = bm[1:] != bm[:-1]
        adjacent = np.zeros(m, dtype=bool)
        adjacent[1:] = (~first[1:]) & (blk[1:] == blk[:-1] + 1)
        same_kind = np.zeros(m, dtype=bool)
        same_kind[1:] = is_c1[1:] == is_c1[:-1]
        run_start = ~(adjacent & same_kind)
        starts = np.flatnonzero(run_start)
        run_bm = bm[starts]
        run_kind_c1 = is_c1[starts]
        run_len = np.diff(np.append(starts, m))
        # gap (clean-0 run) before each run
        gap = np.empty(len(starts), dtype=np.int64)
        run_first_of_bitmap = first[starts]
        prev_idx = starts - 1
        gap[:] = blk[starts] - np.where(run_first_of_bitmap, -1, blk[prev_idx]) - 1
        # trailing clean-0 run per bitmap (after its last event)
        bm_ids, last_pos = np.unique(bm[::-1], return_index=True)
        last_blk = blk[m - 1 - last_pos]
        trailing = n_blocks - 1 - last_blk

        # markers from clean runs (c1 runs, c0 gaps, trailing c0)
        c1_markers = _ceil_div(run_len[run_kind_c1], MAX_CLEAN)
        np.add.at(sizes, run_bm[run_kind_c1], c1_markers)
        has_gap = gap > 0
        gap_markers = _ceil_div(gap[has_gap], MAX_CLEAN)
        np.add.at(sizes, run_bm[has_gap], gap_markers)
        has_tr = trailing > 0
        tr_markers = _ceil_div(trailing[has_tr], MAX_CLEAN)
        np.add.at(sizes, bm_ids[has_tr], tr_markers)
        # markers from dirty runs: overflow continuations, plus a marker of
        # its own only when the stream *starts* with a dirty run at block 0
        d = ~run_kind_c1
        d_overflow = np.maximum(0, _ceil_div(run_len[d], MAX_DIRTY) - 1)
        np.add.at(sizes, run_bm[d], d_overflow)
        starts_dirty = d & run_first_of_bitmap & (gap == 0)
        np.add.at(sizes, run_bm[starts_dirty], np.ones(int(starts_dirty.sum()), dtype=np.int64))
        markers = (
            int(c1_markers.sum())
            + int(gap_markers.sum())
            + int(tr_markers.sum())
            + int(d_overflow.sum())
            + int(starts_dirty.sum())
        )
        touched = np.unique(bm)
    else:
        touched = np.empty(0, dtype=np.int64)

    # bitmaps never touched: one pure clean-0 stream covering all blocks
    n_untouched = n_bitmaps - len(touched)
    if n_untouched:
        empty_markers = _ceil_div(n_blocks, MAX_CLEAN) if n_blocks else 1
        mask = np.ones(n_bitmaps, dtype=bool)
        mask[touched] = False
        sizes[mask] += empty_markers
        markers += empty_markers * n_untouched

    return sizes, markers, total_dirty


def table_index_size(
    columns: list[np.ndarray],
    codes_per_col: list[np.ndarray],
    n_bitmaps_per_col: list[int],
) -> dict:
    """Total EWAH index size for a table (one k-of-N encoded index per column)."""
    per_col = []
    total = 0
    markers = 0
    dirty = 0
    for col, codes, L in zip(columns, codes_per_col, n_bitmaps_per_col):
        sizes, mk, dt = column_bitmap_sizes(col, codes, L)
        per_col.append(int(sizes.sum()))
        total += int(sizes.sum())
        markers += mk
        dirty += dt
    return {
        "total_words": total,
        "per_column_words": per_col,
        "markers": markers,
        "dirty_words": dirty,
    }


def storage_cost_bound(n_i: int, k: int) -> float:
    """Proposition 2 bound: sorted column storage cost <= 4*n_i + ceil(k*n_i^(1/k))."""
    return 4.0 * n_i + np.ceil(k * n_i ** (1.0 / k))
