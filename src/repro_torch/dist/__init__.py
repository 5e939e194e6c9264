"""Distributed layer: query fan-out over row-range index shards
(query_fanout), the cross-process serve plane (serve_plane),
checkpoints (checkpoint): the training state's pytrees and the serve
plane's sharded segments, and the model's placement on a mesh
(sharding: DTensor placements of parameters, ZeRO-1 moments, batches and
the decode cache).

Submodules resolve lazily (PEP 562): serve-plane *worker* processes run
``python -m repro_torch.dist.serve_plane`` through this package and load
only what a request needs.
"""

_SUBMODULES = ("checkpoint", "query_fanout", "serve_plane", "sharding")

_LAZY = {
    # query_fanout: placement + in-process fan-out
    "IndexShard": "query_fanout",
    "ShardedIndex": "query_fanout",
    "assign_segments": "query_fanout",
    "shard_ranges": "query_fanout",
    # serve_plane: cross-process coordinator/worker
    "ServePlane": "serve_plane",
    "seal_from_state": "serve_plane",
    "segment_state": "serve_plane",
}

__all__ = sorted([*_SUBMODULES, *_LAZY])


def __getattr__(name):
    from importlib import import_module

    if name in _SUBMODULES:
        return import_module(f".{name}", __name__)
    if name in _LAZY:
        return getattr(import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return __all__
