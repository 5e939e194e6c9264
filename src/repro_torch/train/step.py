"""Serving step functions, the serving half of the reference's
``src/repro/train/step.py``.

``cross_entropy``, ``loss_fn``, ``train_step`` and ``eval_step`` wait for
the training slice (ROADMAP queue 1), with ``optim/`` and the backward
pass.
"""

from __future__ import annotations

import torch

from ..models import transformer

__all__ = ["prefill_step", "serve_step"]


@torch.no_grad()
def serve_step(params, tokens, cache, cache_len, *, cfg, temperature=0.0,
               generator=None):
    """One batched decode step: logits -> next token ids (b, 1) int32.

    Greedy (the first maximum) when ``temperature == 0`` or no
    ``generator`` is given; otherwise one draw a row from
    softmax(logits / temperature) with ``generator``.  Updates ``cache``
    in place.
    """
    logits, cache = transformer.decode_step(params, cfg, tokens, cache,
                                            cache_len)
    if temperature > 0.0 and generator is not None:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        next_tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
    else:
        next_tok = torch.argmax(logits, dim=-1)
    return next_tok.to(torch.int32)[:, None], cache


@torch.no_grad()
def prefill_step(params, batch, *, cfg):
    """Forward over the prompt ``batch["inputs"]``, returning the last
    position's logits for sampling the first generated token."""
    logits, _ = transformer.forward(
        params, cfg, batch["inputs"], positions=batch.get("positions"),
        mrope_positions=batch.get("mrope_positions"),
        patches=batch.get("patches"))
    return logits[:, -1]
