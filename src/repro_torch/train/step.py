"""Training and serving step functions: a copy of the reference's
``src/repro/train/step.py`` in PyTorch.

``jax.grad`` becomes autograd on the ``Transformer``
(``torch.autograd.grad``, which leaves the parameters' ``.grad`` alone);
a parameter the loss does not reach gets zeros, as ``jax.grad`` gives it.
``train_step`` updates the model's parameters in place and returns them
with the new optimizer state.  The two accumulation modes keep the
reference's numerics: ``accum="unroll"`` adds the microbatch gradients in
their own type (bfloat16 for a bfloat16 model), ``accum="scan"`` into
float32 zeros.  There is no mesh: ``grad_shardings`` must be None.
"""

from __future__ import annotations

import torch

from .. import convert
from ..models import transformer
from ..optim.adamw import OptConfig, apply_updates
from ..optim.compress import compress_grads

__all__ = ["cross_entropy", "eval_step", "loss_fn", "prefill_step",
           "serve_step", "train_step"]


def cross_entropy(logits, labels, mask=None):
    """Token-level CE. logits (b, s, V) any float type; labels (b, s) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, cfg, batch, aux_weight=0.01):
    """(loss + aux_weight * aux, (loss, aux)) of ``batch`` ("inputs",
    "labels", optional "mask", "positions", "mrope_positions",
    "patches")."""
    logits, aux = transformer.forward(
        params, cfg, batch["inputs"],
        positions=batch.get("positions"),
        mrope_positions=batch.get("mrope_positions"),
        patches=batch.get("patches"))
    loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss + aux_weight * aux, (loss, aux)


def _grads(params, cfg, batch):
    """({name: gradient}, loss, aux) of one (micro)batch."""
    named = list(params.named_parameters())
    total, (loss, aux) = loss_fn(params, cfg, batch)
    gs = torch.autograd.grad(total, [p for _, p in named], allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(named, gs)}
    return grads, loss.detach(), aux.detach()


def _microbatch(batch, microbatches, i):
    """The i-th of ``microbatches`` equal slices of every batch entry:
    along dimension 0 where it is the batch, else along dimension 1 (a
    leading non-batch dimension, e.g. mrope_positions (3, B, S))."""
    B = batch["inputs"].shape[0]

    def cut(x):
        if x.shape[0] == B:
            m = B // microbatches
            return x[i * m:(i + 1) * m]
        m = x.shape[1] // microbatches
        return x[:, i * m:(i + 1) * m]

    return {k: cut(v) for k, v in batch.items()}


def _compress(grads, ef, cfg):
    """``compress_grads`` with the reference's per-tensor scales: its layer
    leaves are stacked, so one scale covers a leaf of every layer.  The
    gradients and residuals go through the reference's tree and back."""
    device = next(iter(grads.values())).device
    deq, new_ef = compress_grads(convert.params_to_reference(grads),
                                 convert.params_to_reference(ef))
    return (convert.params_from_reference(deq, cfg, device),
            convert.params_from_reference(new_ef, cfg, device))


def train_step(params, opt_state, batch, *, cfg, opt_cfg: OptConfig,
               microbatches: int = 1, grad_shardings=None,
               accum: str = "scan"):
    """One optimizer step, optionally accumulated over microbatches:
    returns (params, new_opt_state, metrics), the parameters updated in
    place.

    accum="unroll" adds the per-microbatch gradients in their own type;
    accum="scan" (the reference folds the microbatches into ``lax.scan``)
    adds them into float32 zeros.  Both divide by ``microbatches`` after
    the sum.  ``grad_shardings`` constrains the reference's gradients to
    its ZeRO moment shardings; one card has none, and it must be None.
    With ``opt_state["ef"]`` the gradients go through the int8
    error-feedback compressor first, one scale per leaf of the
    reference's tree (a layer leaf's scale spans every layer)."""
    if grad_shardings is not None:
        raise ValueError("grad_shardings: the port trains on one card "
                         "without a mesh; pass None")
    if microbatches == 1:
        grads, loss, aux = _grads(params, cfg, batch)
    else:
        unroll = accum == "unroll"
        grads = None
        loss = aux = 0.0 if unroll else torch.zeros(
            (), device=batch["inputs"].device)
        for i in range(microbatches):
            g, l, a = _grads(params, cfg, _microbatch(batch, microbatches, i))
            if grads is None:
                grads = (g if unroll else
                         {n: x.float() for n, x in g.items()})
            else:
                for n, x in g.items():
                    grads[n].add_(x)
            loss, aux = loss + l, aux + a
        grads = {n: g / microbatches for n, g in grads.items()}
        loss, aux = loss / microbatches, aux / microbatches

    if "ef" in opt_state:
        # int8 error-feedback compression of the cross-pod gradient sync
        # (optim/compress.py); opt_state must come from
        # init_opt_state(params, error_feedback=True)
        grads, new_ef = _compress(grads, opt_state["ef"], cfg)
        opt_state = dict(opt_state, ef=new_ef)
    params, new_opt, metrics = apply_updates(opt_cfg, params, grads,
                                             opt_state)
    metrics.update({"loss": loss, "aux_loss": aux})
    return params, new_opt, metrics


@torch.no_grad()
def eval_step(params, batch, *, cfg):
    loss, (ce, aux) = loss_fn(params, cfg, batch)
    return {"loss": loss, "ce": ce, "aux": aux}


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
