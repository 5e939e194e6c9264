"""int8 error-feedback gradient compression for slow cross-pod links.

A copy of the reference's ``src/repro/optim/compress.py`` in PyTorch.
Quantizing the cross-pod stage of the gradient all-reduce to int8 with a
per-tensor scale cuts its wire bytes 4x; the quantization residual is
carried in an error-feedback buffer and added to the next step's gradient
(Seide et al. / EF-SGD), so the bias vanishes asymptotically rather than
accumulating.  Rounding is half to even (``torch.round``, as
``jnp.round``), values clip to +-127, and the scale is floored at 1e-30.

Trees are tensors or nested dicts of them (the optimizer state keys them
by parameter name).

Usage (train_step):
    ef    = init_error_feedback(params)
    g_q, ef = compress_grads(grads, ef)     # before the cross-pod reduce
"""

from __future__ import annotations

import torch

from ..pytree import tree_leaves, tree_map, tree_unflatten
from .adamw import named_params

__all__ = ["compress_grads", "init_error_feedback", "wire_bytes"]


def init_error_feedback(params):
    """float32 zeros shaped like ``params`` (a module's parameters are
    keyed by name)."""
    if isinstance(params, torch.nn.Module):
        params = named_params(params)
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize(g):
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-30) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q, scale):
    return q.float() * scale


def compress_grads(grads, error_feedback):
    """Returns (quantize-dequantized grads, new error feedback).

    The returned grads are exactly what the receiving side reconstructs, so
    training math is identical on every host; the int8+scale pair is what
    crosses the slow link (4.03x smaller than f32)."""

    def one(g, ef):
        g = g.float() + ef
        q, scale = _quantize(g)
        deq = _dequantize(q, scale)
        return deq, g - deq

    out = [one(g, e) for g, e in zip(tree_leaves(grads),
                                     tree_leaves(error_feedback))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def wire_bytes(grads, compressed: bool) -> int:
    tot = 0
    for g in tree_leaves(grads):
        tot += g.numel() * (1 if compressed else 4) + (4 if compressed else 0)
    return tot
