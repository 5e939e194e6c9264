"""Core: EWAH compression, k-of-N and bit-sliced/binned encodings,
histogram-aware row/column reordering, the predicate algebra and planner,
and the torch execution backend.  ``BitmapIndex.build`` constructs an index
in one call; queries run on ``backend="torch"`` by default."""

from . import (column_order, encoding, encodings, ewah, ewah_stream,
               histogram, index_size, query, sorting, strategies)
from .bitmap_index import BitmapIndex, assign_codes, index_size_report
from .ewah_stream import EwahStream
from .query import (And, Eq, In, Not, NumpyBackend, Or, Range, TorchBackend,
                    evaluate_mask)
from .strategies import IndexSpec

__all__ = [
    "BitmapIndex",
    "EwahStream",
    "IndexSpec",
    "NumpyBackend",
    "TorchBackend",
    "assign_codes",
    "evaluate_mask",
    "index_size_report",
    "And",
    "Eq",
    "In",
    "Not",
    "Or",
    "Range",
    "column_order",
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
