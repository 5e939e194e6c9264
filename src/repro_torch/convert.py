"""Carry a reference index across into this package.

:func:`index_from_reference` reads a ``BitmapIndex`` of the reference
package (``repro.core``) by its attributes only, without importing that
package, and returns this package's ``BitmapIndex`` over the same streams,
permutations and spec.  Both packages can then answer queries on one index,
which is how the tests hold the torch backend against the JAX one.
"""

from __future__ import annotations

import numpy as np

from .core import containers, encodings
from .core.bitmap_index import BitmapIndex, ColumnIndex
from .core.strategies import IndexSpec


def _streams(enc):
    if enc.streams is None:
        return None
    return [np.asarray(s, dtype=np.uint32) for s in enc.streams]


def _container_set(cs) -> containers.ContainerSet:
    return containers.ContainerSet(cs.n_rows, np.asarray(cs.keys),
                                   np.asarray(cs.classes),
                                   [np.asarray(p) for p in cs.payloads])


def _encoding(enc) -> encodings.ColumnEncoding:
    kind = enc.kind
    sizes = np.asarray(enc.sizes)
    if kind == "equality":
        return encodings.EqualityEncoding(
            np.asarray(enc.codes), int(enc.N), int(enc.k), sizes,
            _streams(enc), int(enc.card), int(enc.n_rows))
    if kind in ("bitsliced", "bitsliced-gray"):
        cls = encodings.ENCODINGS[kind]
        return cls(int(enc.n_bits), bool(enc.gray), sizes, _streams(enc),
                   int(enc.card), int(enc.n_rows))
    if kind == "binned":
        values = None if enc._values is None else np.asarray(enc._values)
        return encodings.BinnedEncoding(
            np.asarray(enc.edges), sizes, _streams(enc), values,
            int(enc.card), int(enc.n_rows))
    if kind == "roaring":
        csets = (None if enc.csets is None
                 else [_container_set(cs) for cs in enc.csets])
        return encodings.RoaringEncoding(csets, sizes, int(enc.card),
                                         int(enc.n_rows))
    raise ValueError(f"cannot carry encoding kind {kind!r} across")


def index_from_reference(ref_index) -> BitmapIndex:
    """This package's ``BitmapIndex`` holding the same state as
    ``ref_index``, a reference-package ``BitmapIndex``."""
    spec = (None if ref_index.spec is None
            else IndexSpec.from_dict(ref_index.spec.to_dict()))
    return BitmapIndex(
        n_rows=int(ref_index.n_rows),
        columns=[ColumnIndex(encoding=_encoding(c.encoding))
                 for c in ref_index.columns],
        spec=spec,
        row_perm=None if ref_index.row_perm is None
        else np.asarray(ref_index.row_perm),
        col_perm=None if ref_index.col_perm is None
        else np.asarray(ref_index.col_perm),
        cache_scope=getattr(ref_index, "cache_scope", None))
