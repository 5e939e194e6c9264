"""Assigned input shapes (one set for all LM-family archs): the port of
``src/repro/launch/shapes.py``.

``meta``-device tensors stand in for the reference's
``jax.ShapeDtypeStruct``: they carry a shape and a type and allocate
nothing, and the decode cache comes from ``init_decode_cache(...,
device="meta")``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..configs import get_config
from ..models import transformer

__all__ = ["SHAPES", "ShapeSpec", "cell_config", "input_specs", "runnable",
           "specs_for"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def runnable(cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether this (arch, shape) cell runs."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: 500k-token decode is quadratic-"
                       "history; skipped per spec (see DESIGN.md)")
    return True, ""


def cell_config(cfg, shape: ShapeSpec):
    """Shape-dependent config adjustments (documented adaptations)."""
    if shape.name == "long_500k" and cfg.family == "hybrid":
        # Zamba2 long-context: shared attention uses a sliding window
        cfg = replace(cfg, sliding_window=4096)
    return cfg


def input_specs(arch: str, shape_name: str):
    """``meta`` stand-ins for every model input of this cell.

    Returns (cfg, kind, specs_dict).  Nothing is allocated.
    """
    shape = SHAPES[shape_name]
    cfg = cell_config(get_config(arch), shape)
    return cfg, shape.kind, specs_for(cfg, shape)


def specs_for(cfg, shape: ShapeSpec) -> dict:
    """The specs dict of :func:`input_specs` for any config and shape
    (e.g. a smoke config at a small ``ShapeSpec``)."""
    B, S = shape.global_batch, shape.seq_len
    n_patches = min(1024, S)  # frontend-stub block per sample

    if shape.kind in ("train", "prefill"):
        batch = {"inputs": _spec((B, S), torch.int32),
                 "labels": _spec((B, S), torch.int32)}
        if cfg.frontend != "none":
            # precomputed patch/frame embeddings (stub modality frontend)
            batch["patches"] = _spec((B, n_patches, cfg.d_model),
                                     torch.bfloat16)
        if cfg.family == "vlm":
            batch["mrope_positions"] = _spec((3, B, S), torch.int32)
        if shape.kind == "prefill":
            batch.pop("labels")
        return {"batch": batch}

    # decode: one new token against a seq_len KV cache
    return {
        "tokens": _spec((B, 1), torch.int32),
        "cache": transformer.init_decode_cache(cfg, B, S, device="meta"),
        "cache_len": _spec((), torch.int32),
    }
