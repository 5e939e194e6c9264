"""The bytes a batch of queries needs, and its share of the card's peak.

Counted from stream lengths alone, never from how the program splits the
work: each distinct leaf stream a batch's predicates read, in compressed
words, read once, and each answer written once (its compressed words, or
``ceil(rows / 32)`` words for a row-id answer).  A kernel fused, removed
or added leaves the count as it is.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA data sheet, at 700 W
WORD_BYTES = 4


def needed_bytes(leaf_words, answer_words) -> int:
    """``leaf_words``: the compressed length of each distinct leaf stream
    read; ``answer_words``: the length of each answer in words."""
    return WORD_BYTES * (int(sum(leaf_words)) + int(sum(answer_words)))


def rowid_answer_words(n_rows: int) -> int:
    return (n_rows + 31) // 32


def share_percent(nbytes: int, device_s: float):
    """Percent of the HBM roofline: the least time the bytes take at the
    peak rate over the device time they took; None without device time."""
    if device_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s
