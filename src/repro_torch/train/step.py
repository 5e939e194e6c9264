"""Training and serving step functions: a copy of the reference's
``src/repro/train/step.py`` in PyTorch.

``jax.grad`` becomes autograd on the ``Transformer``
(``torch.autograd.grad``, which leaves the parameters' ``.grad`` alone);
a parameter the loss does not reach gets zeros, as ``jax.grad`` gives it.
``train_step`` updates the model's parameters in place and returns them
with the new optimizer state.  The two accumulation modes keep the
reference's numerics: ``accum="unroll"`` adds the microbatch gradients in
their own type (bfloat16 for a bfloat16 model), ``accum="scan"`` into
float32 zeros.

On a mesh the parameters and the batch are DTensors (``dist.sharding``)
and the step runs under a ``ShardingCtx``: the microbatch split keeps the
batch shard (``lshard(y, None, "batch", ...)``), and each microbatch's
gradients and their sum are redistributed to ``grad_shardings`` (default:
each parameter's own placement), which reduces the data-parallel partial
sums, as the reference's sharding constraints do.  The metrics come back
as plain tensors.
"""

from __future__ import annotations

import torch

from .. import convert
from ..models import transformer
from ..dist.sharding import gather
from ..models.common import (is_dtensor, lshard, mesh_region, placed_as,
                             unsharded)
from ..optim.adamw import OptConfig, apply_updates, named_params
from ..optim.compress import compress_grads

__all__ = ["cross_entropy", "eval_step", "loss_fn", "prefill_step",
           "serve_step", "train_step"]


def cross_entropy(logits, labels, mask=None):
    """Token-level CE. logits (b, s, V) any float type; labels (b, s) int."""
    # on a mesh, aten.gather along a vocab dimension sharded over the
    # model axis has no working rule (its masked partial sum fails to
    # reduce): the vocab dimension is replicated first, the batch shard
    # kept
    logits = unsharded(logits.float(), -1)
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
    with mesh_region(batch["inputs"], named[0][1]):
        total, (loss, aux) = loss_fn(params, cfg, batch)
        gs = torch.autograd.grad(total, [p for _, p in named],
                                 allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(named, gs)}
    return grads, loss.detach(), aux.detach()


def _microbatches(batch, microbatches):
    """``microbatches`` equal slices of every batch entry, in order: along
    dimension 0 where it is the batch, else along dimension 1 (a leading
    non-batch dimension, e.g. mrope_positions (3, B, S)).  Each entry is
    reshaped to (microbatches, B / microbatches, ...) and keeps its
    data-parallel shard on the new batch dimension."""
    B = batch["inputs"].shape[0]

    def split(x):
        # on a mesh, aten.view has no rule to split a batch dimension
        # sharded over more ranks than there are microbatches: the batch
        # dimension (token ids, small) is gathered first, and lshard cuts
        # each rank's rows of every microbatch out of it
        if x.shape[0] == B:
            x = unsharded(x, 0)
            y = x.reshape(microbatches, B // microbatches, *x.shape[1:])
            axes = (None, "batch") + (None,) * (y.dim() - 2)
        else:
            x = unsharded(x, 1)
            y = x.reshape(x.shape[0], microbatches, B // microbatches,
                          *x.shape[2:]).movedim(1, 0)
            axes = (None, None, "batch") + (None,) * (y.dim() - 3)
        return lshard(y, *axes)

    split_batch = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split_batch.items()}
            for i in range(microbatches)]


def _constrain(grads, params, grad_shardings):
    """On a mesh, each gradient redistributed to ``grad_shardings[name]``
    (default: its parameter's placement); plain tensors pass."""
    if not any(is_dtensor(g) for g in grads.values()):
        return grads
    return {n: placed_as(g, params[n].placements if grad_shardings is None
                         else grad_shardings[n].placements)
            for n, g in grads.items()}


def _compress(grads, ef, cfg):
    """``compress_grads`` with the reference's per-tensor scales: its layer
    leaves are stacked, so one scale covers a leaf of every layer.  The
    gradients and residuals go through the reference's tree and back (on
    a mesh, gathered and placed again as they came)."""
    device = next(iter(grads.values())).device
    deq, new_ef = compress_grads(convert.params_to_reference(grads),
                                 convert.params_to_reference(ef))
    deq = convert.params_from_reference(deq, cfg, device)
    new_ef = convert.params_from_reference(new_ef, cfg, device)
    for tree, like in ((deq, grads), (new_ef, ef)):
        for n, t in like.items():
            if is_dtensor(t):
                from torch.distributed.tensor import distribute_tensor

                tree[n] = distribute_tensor(tree[n], t.device_mesh,
                                            t.placements)
    return deq, new_ef


def train_step(params, opt_state, batch, *, cfg, opt_cfg: OptConfig,
               microbatches: int = 1, grad_shardings=None,
               accum: str = "scan"):
    """One optimizer step, optionally accumulated over microbatches:
    returns (params, new_opt_state, metrics), the parameters updated in
    place.

    accum="unroll" adds the per-microbatch gradients in their own type;
    accum="scan" (the reference folds the microbatches into ``lax.scan``)
    adds them into float32 zeros.  Both divide by ``microbatches`` after
    the sum.  ``grad_shardings`` (``{name: NamedSharding}``, e.g. the ZeRO
    moment shardings ``opt_shardings(...)["m"]``) places the gradients on
    a mesh, per microbatch and after the sum; without it each gradient
    takes its parameter's placement.  With ``opt_state["ef"]`` the
    gradients go through the int8 error-feedback compressor first, one
    scale per leaf of the reference's tree (a layer leaf's scale spans
    every layer)."""
    named = named_params(params)
    if grad_shardings is not None and not any(
            is_dtensor(p) for p in named.values()):
        raise ValueError("grad_shardings: the parameters lie on one card, "
                         "not on a mesh; pass None")
    if microbatches == 1:
        grads, loss, aux = _grads(params, cfg, batch)
        grads = _constrain(grads, named, grad_shardings)
    else:
        unroll = accum == "unroll"
        grads = None
        loss = aux = 0.0 if unroll else torch.zeros(
            (), device=batch["inputs"].device)
        for mbatch in _microbatches(batch, microbatches):
            g, l, a = _grads(params, cfg, mbatch)
            # reduce(-scatter) per microbatch, as the reference's ZeRO
            # accumulation does
            g = _constrain(g, named, grad_shardings)
            l, a = gather(l), gather(a)
            if grads is None:
                grads = (g if unroll else
                         {n: x.float() for n, x in g.items()})
            else:
                for n, x in g.items():
                    grads[n].add_(x)
            loss, aux = loss + l, aux + a
        grads = {n: g / microbatches for n, g in grads.items()}
        loss, aux = loss / microbatches, aux / microbatches
        grads = _constrain(grads, named, grad_shardings)

    if "ef" in opt_state:
        # int8 error-feedback compression of the cross-pod gradient sync
        # (optim/compress.py); opt_state must come from
        # init_opt_state(params, error_feedback=True)
        grads, new_ef = _compress(grads, opt_state["ef"], cfg)
        opt_state = dict(opt_state, ef=new_ef)
    params, new_opt, metrics = apply_updates(opt_cfg, params, grads,
                                             opt_state)
    metrics.update({"loss": gather(loss), "aux_loss": gather(aux)})
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
    # on a mesh, the arg-max over a vocab dimension sharded on the model
    # axis fails in DTensor's all-gather of the (value, index) pairs when
    # the batch is replicated (B = 1): the vocab dimension is replicated
    # first, the batch shard kept
    logits = unsharded(logits, -1)
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
