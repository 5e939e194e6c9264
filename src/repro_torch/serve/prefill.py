"""Fused prefill: one forward pass that also fills the decode cache.

Serving a request = ``prefill_with_cache(prompt)`` -> ``serve_step`` loop.
Each attention layer's K/V projections are written into the (layers, b,
max_len, kvh, hd) cache, zero past the prompt; ssm / hybrid layers keep
their final recurrent state and conv tail instead, and the hybrid's
shared block its K/V, one slot an application.  The port of the
reference's ``src/repro/serve/prefill.py``.
"""

from __future__ import annotations

import torch

from ..models import ssm as ssm_mod
from ..models import transformer
from ..models.attention import attention, write_kv
from ..models.common import (is_dtensor, mesh_region, rms_norm, set_layer,
                             swiglu)
from ..models.moe import moe_ffn

__all__ = ["prefill_with_cache"]


def _ssm_tail_state(p, cfg, h):
    """Final (conv tail, ssm state) of a mamba2 layer over prompt h."""
    _, tail, state = ssm_mod._mamba2(p, cfg, h)
    return tail, state


@torch.no_grad()
def prefill_with_cache(params, cfg, tokens, max_len: int,
                       mrope_positions=None, patches=None):
    """tokens: (b, s) ids (or (b, s, d) embeddings).  Returns
    (next_token_logits (b, V), cache).  On a mesh (DTensor parameters and
    tokens) the cache is made as DTensors placed by
    ``transformer.cache_axes`` under the current ``ShardingCtx``."""
    b, s = tokens.shape[:2]
    if s > max_len:
        raise ValueError(f"a prompt of {s} tokens exceeds max_len {max_len}")
    with mesh_region(params, tokens):
        return _prefill(params, cfg, tokens, max_len, mrope_positions,
                        patches)


def _prefill(params, cfg, tokens, max_len, mrope_positions, patches):
    b, s = tokens.shape[:2]
    x = transformer._embed(params, cfg, tokens, patches)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    x = transformer._add_sinusoid(x, positions, cfg)
    cache = transformer.init_decode_cache(
        cfg, b, max_len, device=x.device,
        mesh=x.device_mesh if is_dtensor(x) else None)

    if cfg.family in ("ssm", "hybrid"):
        slot = 0
        for start, ln, shared_after in transformer._segments(cfg):
            for i in range(start, start + ln):
                lp = params.layers[i]
                h = rms_norm(x, lp.ln1)
                # one pass gives the mixer's output and its final state
                mix, tail, state = ssm_mod._mamba2(lp.mixer, cfg, h)
                set_layer(cache["conv"], i, tail)
                set_layer(cache["state"], i, state)
                x = x + mix
            if shared_after:
                sp = params.shared_attn
                h = rms_norm(x, sp.ln1)
                o, k, v = attention(sp.attn, cfg, h, positions,
                                    impl=cfg.attn_impl, return_kv=True)
                x = transformer._shared_ffn(sp, x + o)
                write_kv(cache["k"][slot], k, 0)
                write_kv(cache["v"][slot], v, 0)
                slot += 1
    else:
        for i, lp in enumerate(params.layers):
            h = rms_norm(x, lp.ln1)
            o, k, v = attention(lp.mixer, cfg, h, positions, mrope_positions,
                                impl=cfg.attn_impl, return_kv=True)
            x = x + o
            h = rms_norm(x, lp.ln2)
            if cfg.family == "moe":
                y, _ = moe_ffn(lp.ffn, cfg, h, route_sort="none",
                               dispatch=cfg.moe_dispatch)
            else:
                y = swiglu(h, lp.ffn.w_gate, lp.ffn.w_up, lp.ffn.w_down)
            x = x + y
            write_kv(cache["k"][i], k, 0)
            write_kv(cache["v"][i], v, 0)
    x = rms_norm(x, params.ln_f)
    return x[:, -1] @ transformer._head(params, cfg), cache
