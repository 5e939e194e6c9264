"""Fused prefill: one forward pass that also fills the decode cache.

Serving a request = ``prefill_with_cache(prompt)`` -> ``serve_step`` loop.
Each layer's K/V projections are written into the (layers, b, max_len,
kvh, hd) cache, zero past the prompt.  The dense branch of the
reference's ``src/repro/serve/prefill.py``; the other families raise
(``models.transformer.check_family``).
"""

from __future__ import annotations

import torch

from ..models import transformer
from ..models.attention import attention
from ..models.common import rms_norm, swiglu

__all__ = ["prefill_with_cache"]


@torch.no_grad()
def prefill_with_cache(params, cfg, tokens, max_len: int):
    """tokens: (b, s) ids.  Returns (next_token_logits (b, V), cache)."""
    transformer.check_family(cfg)
    b, s = tokens.shape[:2]
    if s > max_len:
        raise ValueError(f"a prompt of {s} tokens exceeds max_len {max_len}")
    x = params.embed[tokens.long()] if tokens.dim() == 2 else tokens
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    cache = transformer.init_decode_cache(cfg, b, max_len, device=x.device)
    for i, lp in enumerate(params.layers):
        h = rms_norm(x, lp.ln1)
        o, k, v = attention(lp.mixer, cfg, h, positions, impl=cfg.attn_impl,
                            return_kv=True)
        x = x + o
        h = rms_norm(x, lp.ln2)
        x = x + swiglu(h, lp.ffn.w_gate, lp.ffn.w_up, lp.ffn.w_down)
        cache["k"][i, :, :s] = k.to(cache["k"].dtype)
        cache["v"][i, :, :s] = v.to(cache["v"].dtype)
    x = rms_norm(x, params.ln_f)
    return x[:, -1] @ transformer._head(params, cfg), cache
