"""Core: EWAH compression, k-of-N, bit-sliced, binned and Roaring encodings,
histogram-aware row/column reordering, compressed-domain logical ops, behind
one composable API: IndexSpec (strategy registry) -> IndexWriter (append /
seal / compact lifecycle) -> Segment / SegmentedIndex -> predicate algebra
(query.Eq/In/Range/And/Or/Not) -> pluggable backends, with the torch
execution backend the default.  BitmapIndex.build is the seal-once
convenience over the writer."""

from . import (column_order, containers, encoding, encodings, ewah,
               ewah_stream, histogram, index_size, query, sorting, strategies)
from .bitmap_index import BitmapIndex, assign_codes, index_size_report
from .ewah_stream import EwahStream
from .lifecycle import (BackgroundCompactor, IndexWriter, compact,
                        size_tiered_pick)
from .query import (And, Eq, In, Not, NumpyBackend, Or, Range, TorchBackend,
                    evaluate_mask)
from .segment import Segment, SegmentedIndex
from .strategies import IndexSpec

__all__ = [
    "BackgroundCompactor",
    "BitmapIndex",
    "EwahStream",
    "IndexSpec",
    "IndexWriter",
    "NumpyBackend",
    "Segment",
    "SegmentedIndex",
    "TorchBackend",
    "assign_codes",
    "compact",
    "evaluate_mask",
    "index_size_report",
    "size_tiered_pick",
    "And",
    "Eq",
    "In",
    "Not",
    "Or",
    "Range",
    "column_order",
    "containers",
    "encoding",
    "encodings",
    "ewah",
    "ewah_stream",
    "histogram",
    "index_size",
    "query",
    "sorting",
    "strategies",
]

# import-cycle note: segment/lifecycle import bitmap_index at module level;
# bitmap_index reaches lifecycle lazily inside build(), so the order above
# (bitmap_index first) is load-bearing.
