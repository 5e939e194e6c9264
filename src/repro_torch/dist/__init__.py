"""Distributed layer: query fan-out over row-range index shards
(query_fanout), the cross-process serve plane (serve_plane), and
checkpoints (checkpoint): the training state's pytrees and the serve
plane's sharded segments.

Submodules resolve lazily (PEP 562): serve-plane *worker* processes run
``python -m repro_torch.dist.serve_plane`` through this package and load
only what a request needs.  The reference's ``sharding`` module (mesh
placement of model parameters) is later work: the port trains and serves
on one card.
"""

_SUBMODULES = ("checkpoint", "query_fanout", "serve_plane")

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
