"""AdamW + cosine schedule + global-norm clipping.

A copy of the reference's ``src/repro/optim/adamw.py`` in PyTorch.  The
parameters are a ``Transformer`` (or a dict of tensors); the optimizer
state keys its moments by the parameters' ``state_dict`` names:

    {"m": {name: float32}, "v": {name: float32}, "step": int32 scalar,
     "ef": {name: float32}}        # "ef" only with error feedback

The arithmetic is the reference's, in float32 from Python-float constants
and in its order: the warm-up ratio, the cosine, ``b1 ** step``, the
decoupled weight decay, and the new parameter cast back to its type.

ZeRO-1 moment storage: ``init_opt_state(params, zero_pad=d)`` with d > 1
stores "m"/"v" leaves **1-D flattened and zero-padded** to a multiple of d
(the data-axis size, ``dist.sharding.zero_pad_for``), as the reference
does for its data-parallel shards; one card uses ``zero_pad=1``.
``apply_updates`` detects flat leaves by shape, reshapes them to the
parameter shape for the update math, and re-pads on the way out, so flat
and param-shaped states compute identical updates.

On a mesh the parameters, gradients and moments are DTensors
(``dist.sharding.opt_shardings``) and every element's arithmetic is the
one above, on local shards.  A param-shaped moment is placed as its
parameter, and the update runs on the three local shards.  A flat moment
is ``Shard(0)`` on the ZeRO axis: each rank takes its slice of the
flattened, zero-padded parameter and gradient, updates that slice of the
moments, and the new parameter slices are gathered back into the
parameter's own placement.  The padding lanes stay exactly 0.

``apply_updates`` writes the new values into the parameters in place,
under ``torch.no_grad()`` only (autograd's version counters still see the
write), and returns a new state dict.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..models.common import from_local, is_dtensor, placed_as, shard_span
from ..pytree import tree_leaves

__all__ = ["OptConfig", "apply_updates", "global_norm", "init_opt_state",
           "lr_schedule", "named_params"]


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def named_params(params) -> dict:
    """``{name: tensor}`` of a module's parameters, or the dict itself."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _flat_size(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def init_opt_state(params, error_feedback: bool = False, zero_pad: int = 1):
    """Fresh AdamW state on the parameters' device.  ``zero_pad > 1``
    stores the moments 1-D flattened and zero-padded to a multiple of
    ``zero_pad``; the "ef" residual stays param-shaped (it feeds the
    gradient compressor, which works in parameter space)."""
    named = named_params(params)

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    if zero_pad > 1:
        def moment(p):
            return torch.zeros((_flat_size(p.numel(), zero_pad),),
                               dtype=torch.float32, device=p.device)
    else:
        moment = zeros
    device = next(iter(named.values())).device
    state = {
        "m": {n: moment(p) for n, p in named.items()},
        "v": {n: moment(p) for n, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if error_feedback:
        # residual buffer for int8 cross-pod gradient compression
        state["ef"] = {n: zeros(p) for n, p in named.items()}
    return state


def lr_schedule(cfg: OptConfig, step):
    """The learning rate at ``step`` (an int or an integer tensor), as a
    float32 scalar tensor."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def global_norm(tree):
    """sqrt of the sum of every leaf's squares, in float32 (a plain
    tensor; DTensor leaves add their shards' sums)."""
    total = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    if is_dtensor(total):
        total = total.full_tensor()
    return torch.sqrt(total)


def apply_updates(cfg: OptConfig, params, grads, state):
    """One AdamW step: writes the new values into ``params`` (a module or a
    dict of tensors, in place) and returns (params, new_state, metrics).
    ``grads`` is ``{name: tensor}`` for every parameter."""
    named = named_params(params)
    new_step = state["step"] + 1
    step = new_step.full_tensor() if is_dtensor(new_step) else new_step
    gnorm = global_norm(grads)
    # a Python float over a tensor is the tensor's reciprocal times it in
    # PyTorch; the reference divides
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = cfg.betas
    lr = lr_schedule(cfg, step)
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        # ZeRO-1 flat storage: moments whose shape differs from the param
        # are the flattened+padded form; unpad for the math, re-pad after
        # (1-D leaves of divisible size need no pad, so equal shapes always
        # mean the values coincide too)
        flat = m.shape != p.shape
        if flat:
            stored = m.shape[0]
            m = m[: p.numel()].reshape(p.shape)
            v = v[: p.numel()].reshape(p.shape)
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * delta).to(p.dtype)
        if flat:
            pad = (0, stored - p.numel())
            m = F.pad(m.reshape(-1), pad)
            v = F.pad(v.reshape(-1), pad)
        return new_p, m, v

    def upd_sharded(p, g, m, v):
        """``upd`` on a mesh, on local shards: writes the parameter's
        shard and returns the moments as DTensors."""
        def placed(local, like):
            return from_local(local, like.device_mesh, like.placements,
                              like.shape)

        if m.shape == p.shape and list(m.placements) == list(p.placements):
            new_p, m_l, v_l = upd(p.to_local(),
                                  placed_as(g, p.placements).to_local(),
                                  m.to_local(), v.to_local())
            p.to_local().copy_(new_p)
            return placed(m_l, m), placed(v_l, v)
        # flat ZeRO-1: this rank's slice of the flattened, zero-padded
        # parameter and gradient, updated against its moment slice
        off, n = shard_span(m, 0)
        pad = (0, m.shape[0] - p.numel())
        p_sl = F.pad(p.full_tensor().reshape(-1), pad)[off:off + n]
        g_sl = F.pad(g.full_tensor().reshape(-1), pad)[off:off + n]
        new_sl, m_l, v_l = upd(p_sl, g_sl, m.to_local(), v.to_local())
        new_p = placed(new_sl, m).full_tensor()[:p.numel()].reshape(p.shape)
        # the whole new parameter, cut to this rank's shard (no exchange)
        from torch.distributed.tensor import Replicate

        whole = from_local(new_p, p.device_mesh,
                           [Replicate()] * p.device_mesh.ndim, p.shape)
        p.to_local().copy_(placed_as(whole, p.placements).to_local())
        return placed(m_l, m), placed(v_l, v)

    new_m, new_v = {}, {}
    with torch.no_grad():
        for name, p in named.items():
            m, v = state["m"][name], state["v"][name]
            if is_dtensor(m):
                new_m[name], new_v[name] = upd_sharded(p, grads[name], m, v)
                continue
            new_p, new_m[name], new_v[name] = upd(p, grads[name], m, v)
            p.copy_(new_p)
    new_state = {"m": new_m, "v": new_v, "step": new_step}
    for k in state:
        if k not in new_state:
            new_state[k] = state[k]  # pass through extra keys (e.g. "ef")
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
