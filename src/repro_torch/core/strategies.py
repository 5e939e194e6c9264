"""Strategy registry + ``IndexSpec``: the configuration plane of the index.

The paper's contribution is that *configuration choices* — row order (§4.1,
§4.2, §4.4), code enumeration (§4.2), value-to-code policy, column order
(§4.3) — drive compressed size and query speed.  Here each choice is a named,
introspectable strategy in a registry; an :class:`IndexSpec` bundles one name
per axis into a serializable value object that ``BitmapIndex.build`` resolves.

New heuristics plug in without touching the builder::

    from repro_torch.core.strategies import register_row_order

    @register_row_order("reverse-lex")
    def _reverse_lex(columns, hists=None):
        return order_lex(columns)[::-1]

    BitmapIndex.build(cols, IndexSpec(row_order="reverse-lex"))

Canonical strategy signatures (what the builder calls):

========== ============================================== =====================
kind        signature                                      returns
========== ============================================== =====================
row_order   fn(columns, hists=None)                        (n,) row permutation
code_order  fn(N, k, count)                                (count, k) bit codes
value_policy fn(hist)                                      order[rank] = value
column_order fn(cardinalities, k)                          column permutation
encoding    fn(hist, k)                                    encoding kind name
========== ============================================== =====================

The ``encoding`` axis is the *chooser*: called once per column with that
column's attribute-value histogram, it returns the name of a concrete
:mod:`repro.core.encodings` kind ('equality', 'bitsliced',
'bitsliced-gray', 'binned').  The built-in choosers are the four constant
functions plus ``'auto'``, the histogram-aware policy (high cardinality ->
bit-sliced, skewed low-cardinality -> equality, mid -> binned); because the
choice is per column (and, under the segment lifecycle, per segment), one
index can mix encodings.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np

from . import column_order as _column_order
from . import encoding as _encoding
from . import histogram as _histogram
from . import sorting as _sorting

KINDS = ("row_order", "code_order", "value_policy", "column_order",
         "encoding")

_REGISTRY: dict[str, dict[str, object]] = {kind: {} for kind in KINDS}


def register_strategy(kind: str, name: str):
    """Decorator: register ``fn`` as the ``kind`` strategy called ``name``."""
    if kind not in KINDS:
        raise ValueError(f"unknown strategy kind {kind!r}; kinds: {', '.join(KINDS)}")

    def deco(fn):
        _REGISTRY[kind][name] = fn
        return fn

    return deco


def register_row_order(name: str):
    return register_strategy("row_order", name)


def register_code_order(name: str):
    return register_strategy("code_order", name)


def register_value_policy(name: str):
    return register_strategy("value_policy", name)


def register_column_order(name: str):
    return register_strategy("column_order", name)


def register_encoding(name: str):
    return register_strategy("encoding", name)


def unregister_strategy(kind: str, name: str) -> None:
    """Remove a registered strategy (plugin teardown / tests)."""
    _REGISTRY[kind].pop(name, None)


def strategy_names(kind: str) -> tuple:
    """Sorted names registered under ``kind``."""
    return tuple(sorted(_REGISTRY[kind]))


def get_strategy(kind: str, name: str):
    """Look up a strategy; unknown names list what *is* registered."""
    try:
        return _REGISTRY[kind][name]
    except KeyError:
        raise ValueError(
            f"unknown {kind} strategy {name!r}; registered: "
            f"{', '.join(strategy_names(kind))}"
        ) from None


# ---------------------------------------------------------------------------
# Built-in strategies (the paper's heuristics).
# ---------------------------------------------------------------------------


@register_row_order("unsorted")
def _row_unsorted(columns, hists=None):
    return _sorting.order_unsorted(columns)


@register_row_order("lex")
def _row_lex(columns, hists=None):
    return _sorting.order_lex(columns)


@register_row_order("grayfreq")
def _row_grayfreq(columns, hists=None):
    return _sorting.order_gray_frequency(columns, hists)


@register_row_order("freqcomp")
def _row_freqcomp(columns, hists=None):
    return _sorting.order_frequent_component(columns, hists)


register_code_order("gray")(_encoding.gray_kofn_codes)
register_code_order("lex")(_encoding.lex_kofn_codes)


@register_value_policy("alpha")
def _value_alpha(hist):
    return np.arange(len(hist))


@register_value_policy("freq")
def _value_freq(hist):
    return _histogram.value_order(hist, "freq")


@register_column_order("heuristic")
def _cols_heuristic(cardinalities, k):
    return _column_order.order_columns(cardinalities, k)


@register_column_order("given")
def _cols_given(cardinalities, k):
    return np.arange(len(cardinalities))


# -- encoding choosers (see repro.core.encodings) ---------------------------

for _kind in ("equality", "bitsliced", "bitsliced-gray", "binned",
              "roaring"):
    register_strategy("encoding", _kind)(
        lambda hist, k, _kind=_kind: _kind)


@register_encoding("auto")
def _encoding_auto(hist, k):
    """Histogram-aware per-column encoding choice.

    * high cardinality (>= 256 values): bit-sliced — any range costs
      O(log card) merges where equality pays O(card) ORs;
    * skewed columns (top value holds >= half the rows) and small domains
      (< 32 values): equality — few bitmaps, each long-run compressible,
      and narrow fan-ins stay cheap;
    * mid-cardinality, flat-ish distributions: binned — histogram-equalized
      bins keep range fan-ins ~sqrt(card) with an exact refinement leaf.
    """
    hist = np.asarray(hist, dtype=np.int64)
    card = len(hist)
    n = int(hist.sum())
    if card >= 256:
        return "bitsliced"
    if card < 32 or (n and int(hist.max()) * 2 >= n):
        return "equality"
    return "binned"


# ---------------------------------------------------------------------------
# IndexSpec
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class IndexSpec:
    """Serializable index configuration, resolved through the registry.

    value_policy=None means *auto*: 'freq' when row_order='grayfreq' (the
    paper's Gray-Frequency couples the two), else 'alpha'.

    column_order may be a strategy name ('heuristic', 'given') or an explicit
    permutation of column indices (stored as a tuple).  ``None`` normalizes
    to 'given' (legacy spelling for "index columns in table order").

    encoding names the per-column encoding *chooser* ('equality' — the
    paper's k-of-N value bitmaps and the default — 'bitsliced',
    'bitsliced-gray', 'binned', or 'auto', the histogram-aware policy); the
    chooser runs once per column with that column's histogram, so 'auto'
    specs can mix encodings within one index.
    """

    k: int = 1
    row_order: str = "lex"
    code_order: str = "gray"
    value_policy: str | None = None
    column_order: str | tuple | None = "heuristic"
    encoding: str = "equality"

    def __post_init__(self):
        co = self.column_order
        if co is None:
            co = "given"
        elif not isinstance(co, str):
            co = tuple(int(i) for i in np.asarray(co).reshape(-1))
        object.__setattr__(self, "column_order", co)
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")

    # -- resolution --------------------------------------------------------

    def resolved_value_policy(self) -> str:
        if self.value_policy is not None:
            return self.value_policy
        return "freq" if self.row_order == "grayfreq" else "alpha"

    def strategies(self) -> dict:
        """Resolve every axis against the registry (raises ValueError with
        the registered names on an unknown strategy).  The 'column_order'
        entry is None when the spec carries an explicit permutation."""
        return {
            "row_order": get_strategy("row_order", self.row_order),
            "code_order": get_strategy("code_order", self.code_order),
            "value_policy": get_strategy("value_policy", self.resolved_value_policy()),
            "column_order": (
                get_strategy("column_order", self.column_order)
                if isinstance(self.column_order, str)
                else None
            ),
            "encoding": get_strategy("encoding", self.encoding),
        }

    def validate(self) -> "IndexSpec":
        self.strategies()
        return self

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        d = {f.name: getattr(self, f.name) for f in fields(self)}
        if isinstance(d["column_order"], tuple):
            d["column_order"] = list(d["column_order"])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "IndexSpec":
        return cls(**d)
