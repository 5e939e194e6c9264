"""Carry a reference index, writer or model across into this package.

:func:`index_from_reference` reads a ``BitmapIndex`` of the reference
package (``repro.core``) by its attributes only, without importing that
package, and returns this package's ``BitmapIndex`` over the same streams,
permutations and spec.  :func:`writer_from_reference` does the same for a
reference ``IndexWriter``: its sealed segments, open buffer and workload
samples.  Both packages can then answer queries on one index, which is how
the tests hold the torch backend against the JAX one.
:func:`params_from_reference` turns the reference's model parameter tree
into this package's ``Transformer`` ``state_dict``, and
:func:`params_to_reference` turns a ``Transformer`` back into the
reference's tree (names, stacked layer axis, shapes and types);
:func:`opt_state_from_reference` and :func:`opt_state_to_reference` do the
same for the optimizer state (``m``, ``v``, ``step`` and, with error
feedback, ``ef``), param-shaped or flat ZeRO-1 moments alike.  The
checkpoint writes the reference's tree, so that a step written by either
package restores in the other.  DTensor leaves (a mesh's state) are
gathered to full tensors first.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import containers, encodings
from .core.bitmap_index import BitmapIndex, ColumnIndex
from .core.lifecycle import IndexWriter
from .core.segment import Segment
from .core.strategies import IndexSpec
from .models.common import is_dtensor
from .optim.adamw import _flat_size, named_params
from .workload.stats import WorkloadStats


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


def _array(a, dtype=None):
    return None if a is None else np.asarray(a, dtype=dtype)


def _segment(seg) -> Segment:
    """One sealed reference ``Segment``: its index, ingest-order columns,
    id span, generation, TTLs and tombstones."""
    out = Segment(
        index=index_from_reference(seg.index),
        columns=(None if seg.columns is None
                 else tuple(np.asarray(c) for c in seg.columns)),
        row_start=int(seg.row_start), generation=int(seg.generation),
        span_stop=None if seg.span_stop is None else int(seg.span_stop),
        row_ids=_array(seg.row_ids, np.int64),
        expiry=_array(seg.expiry, np.float64))
    tomb = seg.tombstones
    if tomb is not None:
        out._apply_tombstone(np.asarray(tomb.data, dtype=np.uint32))
    return out


def writer_from_reference(ref_writer, workload_stats=None) -> IndexWriter:
    """This package's ``IndexWriter`` holding the same state as
    ``ref_writer``, a reference-package ``IndexWriter``: every sealed
    segment (see :func:`_segment`), the open buffer with its deletes and
    TTLs, the closed flag, and (unless ``workload_stats`` is given) a copy
    of its workload samples.  Generations carry over unchanged; they only
    scope result-cache eviction."""
    segs, buf = ref_writer.snapshot()
    if buf is not None:
        cols, deleted, expiry = buf
        buf = ([np.asarray(c) for c in cols], np.asarray(deleted, dtype=bool),
               np.asarray(expiry, dtype=np.float64))
    if workload_stats is None and ref_writer.workload_stats is not None:
        workload_stats = WorkloadStats()
        workload_stats.merge_snapshot(ref_writer.workload_stats.snapshot())
    spec = IndexSpec.from_dict(ref_writer.spec.to_dict())
    return IndexWriter.from_parts(
        spec, names=ref_writer.names, segments=[_segment(s) for s in segs],
        buffer=buf, closed=ref_writer.closed, seal_rows=ref_writer.seal_rows,
        materialize=ref_writer.materialize, clock=ref_writer.clock,
        workload_stats=workload_stats)


def _tensor(leaf, device, dtype):
    """One parameter leaf (a tensor or an array) as a tensor.  A JAX
    bfloat16 leaf reads as an ``ml_dtypes`` array, which
    ``torch.from_numpy`` refuses; it goes through float32, which holds
    every bfloat16 value exactly."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to(device=device, dtype=dtype or leaf.dtype)
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def _flatten(tree, prefix=""):
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _flatten(leaf, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", leaf


# leaves the model keeps in float32 whatever its type: the MoE router and
# the Mamba2 mixer's A_log, D and dt_bias
FLOAT32_LEAVES = ("router", "A_log", "D", "dt_bias")


def params_from_reference(tree, cfg, device, dtype=None) -> dict:
    """The reference's parameter tree (``repro.models.transformer.
    init_params``; leaves as arrays) as this package's ``Transformer``
    ``state_dict`` on ``device``: the leading layer axis of
    ``tree["layers"]`` is unstacked into ``layers.{i}.*`` (the moe tree
    with its ``shared`` experts and the mamba2 tree alike), and the
    hybrid's ``shared_attn`` tree, which is not stacked, keeps its names.
    ``dtype`` casts every leaf but ``FLOAT32_LEAVES`` (default: each
    leaf's own type)."""

    def leaf_dtype(name):
        return None if name.rsplit(".", 1)[-1] in FLOAT32_LEAVES else dtype

    out = {}
    for name, leaf in _flatten({k: v for k, v in tree.items()
                                if k != "layers"}):
        out[name] = _tensor(leaf, device, leaf_dtype(name))
    for name, leaf in _flatten(tree["layers"]):
        stacked = _tensor(leaf, device, leaf_dtype(name))
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"layers.{name} stacks {stacked.shape[0]} "
                             f"layers, the config has {cfg.n_layers}")
        for i in range(cfg.n_layers):
            out[f"layers.{i}.{name}"] = stacked[i].clone()
    return out


def _layer_name(name):
    """(i, rest) of a per-layer name ``layers.{i}.{rest}``, else None."""
    parts = name.split(".", 2)
    if len(parts) == 3 and parts[0] == "layers" and parts[1].isdigit():
        return int(parts[1]), parts[2]
    return None


def _nest(flat: dict) -> dict:
    """``{"a.b": x}`` -> ``{"a": {"b": x}}``."""
    out = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def _stacked(named: dict, device) -> dict:
    """Tensors keyed by ``state_dict`` names as the reference's tree: each
    ``layers.{i}.{rest}`` family stacked on a new leading axis (copied
    into one tensor on ``device``; default the tensors' own), the other
    leaves copied."""
    flat, layers = {}, {}
    for name, t in named.items():
        if is_dtensor(t):
            t = t.full_tensor()
        hit = _layer_name(name)
        if hit is None:
            flat[name] = t.detach().to(device or t.device, copy=True)
        else:
            layers.setdefault(hit[1], {})[hit[0]] = t
    for rest, by_layer in layers.items():
        first = by_layer[0]
        out = torch.empty((len(by_layer), *first.shape), dtype=first.dtype,
                          device=device or first.device)
        for i in range(len(by_layer)):
            out[i].copy_(by_layer[i].detach())
        flat[f"layers.{rest}"] = out
    return _nest(flat)


def params_to_reference(params, device=None) -> dict:
    """The reference's parameter tree (``repro.models.transformer.
    init_params``' names and shapes, each leaf in the parameter's type) of
    a ``Transformer`` or its ``state_dict``: the per-layer leaves
    ``layers.{i}.*`` restacked on a leading layer axis, the others nested
    by name.  Leaves are fresh tensors on ``device`` (default: the
    parameters' own; ``"meta"`` gives shapes only), to be read with
    ``.numpy()`` on the CPU (numpy has no bfloat16: a bfloat16 leaf goes
    through ``.float()`` first, which is exact)."""
    return _stacked(named_params(params), device)


def _zero_pad_of(opt_state, zero_pad):
    """The ZeRO-1 multiple of a state's flat moments: ``zero_pad`` when
    given, else the ranks a DTensor moment is ``Shard(0)`` over."""
    if zero_pad is not None:
        return zero_pad
    for t in opt_state["m"].values():
        if is_dtensor(t):
            return t.shape[0] // t.to_local().shape[0]
    raise ValueError("flat ZeRO-1 moments: pass zero_pad, the multiple "
                     "they are padded to")


def _flat_to_reference(moments: dict, shapes: dict, zero_pad: int,
                       device) -> dict:
    """Flat per-parameter moments as the reference's flat tree: a layer
    leaf's unpadded pieces concatenated in layer order and padded once to
    a multiple of ``zero_pad``; the other leaves as they are."""
    flat, layers = {}, {}
    for name, t in moments.items():
        if is_dtensor(t):
            t = t.full_tensor()
        n = 1
        for d in shapes[name]:
            n *= d
        hit = _layer_name(name)
        if hit is None:
            flat[name] = t.detach().to(device or t.device, copy=True)
        else:
            layers.setdefault(hit[1], {})[hit[0]] = t.detach()[:n]
    for rest, by_layer in layers.items():
        cat = torch.cat([by_layer[i] for i in range(len(by_layer))])
        out = torch.zeros(_flat_size(cat.numel(), zero_pad), dtype=cat.dtype,
                          device=device or cat.device)
        out[:cat.numel()] = cat
        flat[f"layers.{rest}"] = out
    return _nest(flat)


def _is_flat(opt_state, shapes) -> bool:
    return any(tuple(t.shape) != tuple(shapes[n])
               for n, t in opt_state["m"].items())


def opt_state_to_reference(opt_state, params, device=None,
                           zero_pad=None) -> dict:
    """The reference's optimizer state tree (``repro.optim.
    init_opt_state``) of this package's: ``m`` and ``v`` (and ``ef``) as
    :func:`params_to_reference` trees, ``step`` copied.  Flat ZeRO-1
    moments map to the reference's flat leaves (see
    :func:`_flat_to_reference`); their multiple is ``zero_pad``, by
    default read off a DTensor moment's ``Shard(0)`` ranks."""
    shapes = {n: tuple(p.shape) for n, p in named_params(params).items()}
    step = opt_state["step"]
    if is_dtensor(step):
        step = step.full_tensor()
    if _is_flat(opt_state, shapes):
        zp = _zero_pad_of(opt_state, zero_pad)
        out = {k: _flat_to_reference(opt_state[k], shapes, zp, device)
               for k in ("m", "v")}
    else:
        out = {k: _stacked(opt_state[k], device) for k in ("m", "v")}
    out["step"] = step.detach().to(device or step.device, copy=True)
    if "ef" in opt_state:
        out["ef"] = _stacked(opt_state["ef"], device)
    return out


def opt_state_from_reference(tree, params, device, zero_pad=None) -> dict:
    """This package's optimizer state (moments keyed by ``state_dict``
    names, float32 on ``device``) of the reference's ``init_opt_state``
    tree for the same model ``params``: the inverse of
    :func:`opt_state_to_reference`.  A flat layer leaf (1-D) is cut into
    its layers' pieces, each padded to a multiple of ``zero_pad``
    (required then)."""
    named = named_params(params)
    n_layers = 1 + max((hit[0] for hit in map(_layer_name, named) if hit),
                       default=-1)

    def moments(sub, key):
        out = {}
        for name, leaf in _flatten(sub):
            t = _tensor(leaf, device, torch.float32)
            if not name.startswith("layers."):
                out[name] = t.clone()
                continue
            rest = name[len('layers.'):]
            if t.dim() == 1 and key != "ef":
                if zero_pad is None:
                    raise ValueError(f"{key}[{name!r}] is a flat ZeRO-1 "
                                     "moment: pass zero_pad")
                n = named[f"layers.0.{rest}"].numel()
                for i in range(n_layers):
                    piece = torch.zeros(_flat_size(n, zero_pad),
                                        dtype=torch.float32, device=device)
                    piece[:n] = t[i * n:(i + 1) * n]
                    out[f"layers.{i}.{rest}"] = piece
                continue
            if t.shape[0] != n_layers:
                raise ValueError(f"{name} stacks {t.shape[0]} layers, the "
                                 f"model has {n_layers}")
            for i in range(n_layers):
                out[f"layers.{i}.{rest}"] = t[i].clone()
        return out

    state = {key: moments(tree[key], key) for key in ("m", "v", "ef")
             if key in tree}
    state["step"] = _tensor(tree["step"], device, torch.int32)
    return state
