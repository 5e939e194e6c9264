"""k-of-N bitmap encodings and Gray-code enumeration (paper §2, §4.2, Prop. 1)."""

from __future__ import annotations

import math

import numpy as np


def choose_N(n_values: int, k: int) -> int:
    """Smallest N with C(N, k) >= n_values (paper: 'choose N as small as
    possible'), via the sufficient bound N = ceil(k * n^(1/k)) then refined."""
    if k == 1:
        return max(1, n_values)
    N = max(k, int(math.ceil(k * n_values ** (1.0 / k))))
    while math.comb(N - 1, k) >= n_values and N - 1 >= k:
        N -= 1
    while math.comb(N, k) < n_values:
        N += 1
    return N


def clamp_k(n_values: int, k: int) -> int:
    """Paper §2 heuristic: small columns cap k.

    <5 distinct values -> unary only (k=1); <21 -> k<=2; <85 -> k<=3.
    """
    if n_values < 5:
        return 1
    if n_values < 21:
        return min(k, 2)
    if n_values < 85:
        return min(k, 3)
    return k


def gray_kofn_codes(N: int, k: int, count: int | None = None) -> np.ndarray:
    """Enumerate k-of-N codes in Gray-code order (Proposition 1).

    Returns an int32 array (count, k) of 0-based positions of the k set bits.
    Nested loops with alternating direction: a_1 ascends, a_2 descends,
    a_3 ascends, ... Successive codes have Hamming distance exactly 2.
    """
    total = math.comb(N, k)
    count = total if count is None else min(count, total)
    out = np.empty((count, k), dtype=np.int32)
    a = [0] * k  # 1-based values per the paper, stored 1-based internally
    idx = 0

    def rec(level: int, prev: int):
        nonlocal idx
        if idx >= count:
            return
        hi = N - k + level  # max value of a_level (1-based)
        lo = prev + 1
        rng = range(lo, hi + 1) if level % 2 == 1 else range(hi, lo - 1, -1)
        for v in rng:
            if idx >= count:
                return
            a[level - 1] = v
            if level == k:
                out[idx] = [x - 1 for x in a]
                idx += 1
            else:
                rec(level + 1, v)

    rec(1, 0)
    assert idx == count, (idx, count)
    return out


def lex_kofn_codes(N: int, k: int, count: int | None = None) -> np.ndarray:
    """k-of-N codes in lexicographic order of the *bitmap code* (1100, 1010,
    1001, 0110, ... -- i.e. descending positions treated as most significant)."""
    total = math.comb(N, k)
    count = total if count is None else min(count, total)
    out = np.empty((count, k), dtype=np.int32)
    idx = 0

    def rec(level: int, prev: int, acc: list):
        nonlocal idx
        if idx >= count:
            return
        if level == k + 1:
            out[idx] = acc
            idx += 1
            return
        for v in range(prev + 1, N - k + level + 1):
            rec(level + 1, v, acc + [v - 1])

    rec(1, 0, [])
    assert idx == count
    return out


def codes_to_bits(codes: np.ndarray, N: int) -> np.ndarray:
    """(count, k) position codes -> (count, N) boolean code matrix."""
    count = codes.shape[0]
    bits = np.zeros((count, N), dtype=bool)
    rows = np.repeat(np.arange(count), codes.shape[1])
    bits[rows, codes.reshape(-1)] = True
    return bits


def hamming_between_successive(codes: np.ndarray, N: int) -> np.ndarray:
    bits = codes_to_bits(codes, N)
    return (bits[1:] != bits[:-1]).sum(axis=1)


# --- binary (full-space) Gray codes, used for sort keys -------------------


def to_gray(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint64)
    return x ^ (x >> np.uint64(1))


def from_gray(g: np.ndarray) -> np.ndarray:
    g = np.asarray(g, dtype=np.uint64).copy()
    shift = 1
    while shift < 64:
        g ^= g >> np.uint64(shift)
        shift *= 2
    return g


def gray_less(a_pos, b_pos) -> bool:
    """Algorithm 2: Gray-code '<' over sparse bit vectors given 1-positions."""
    f = True
    m = min(len(a_pos), len(b_pos))
    for p in range(m):
        if a_pos[p] > b_pos[p]:
            return f
        if a_pos[p] < b_pos[p]:
            return not f
        f = not f
    if len(a_pos) > len(b_pos):
        return not f
    if len(b_pos) > len(a_pos):
        return f
    return False
