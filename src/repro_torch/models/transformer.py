"""Model assembly: embedding -> layer stack -> head, for every family.

The reference (``src/repro/models/transformer.py``) stacks every layer's
parameters on a leading axis and scans over them; here a ``Transformer``
holds an ``nn.ModuleList`` of blocks, whose parameter names mirror the
reference tree (``embed``, ``layers.{i}.ln1``, ``layers.{i}.mixer.wq``,
..., ``layers.{i}.ffn.w_down``, ``ln_f``, ``lm_head``, ``shared_attn.*``),
so that ``convert.params_from_reference`` carries a reference tree across
by name.

The config selects each layer's mixer and FFN: attention + SwiGLU
(dense, vlm, audio), attention + the MoE FFN (moe), or a Mamba2 mixer
(ssm).  The hybrid (zamba2) is a Mamba2 stack with ONE weight-tied
(attention + MLP) block applied after every full segment of
``attn_every`` layers, each application with its own K/V cache slot.
vlm takes precomputed patch embeddings (``patches``, written over the
first positions) and M-RoPE positions; audio (rope off) adds sinusoidal
positions in ``forward`` and prefill, and, as in the reference,
``decode_step`` adds none.

Remat (``cfg.remat``), as the reference's ``jax.checkpoint`` around each
scanned layer: with autograd on, each layer's block runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``.
``remat_policy="full"`` saves nothing inside the block and recomputes it
in the backward pass; ``"dots"`` (the reference's
``dots_with_no_batch_dims_saveable``) saves the outputs of the 2-D matrix
products (``aten.mm`` / ``aten.addmm``) and recomputes the rest.  The
hybrid's shared block is not wrapped, as in the reference.  Remat changes
no value, and it does nothing when grad is off.

The serving functions (``decode_step`` here, ``serve.prefill``,
``train.step.serve_step``) run without autograd and update the decode
cache in place.
"""

from __future__ import annotations

import math
from functools import partial

import torch
from torch import nn

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .common import dense_init, embed_init, resolve_device, rms_norm, swiglu

__all__ = ["FFN", "Layer", "SharedBlock", "Transformer", "decode_step",
           "forward", "init_decode_cache", "init_params", "n_params",
           "n_shared_slots"]


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _ssm(cfg):
    return cfg.family in ("ssm", "hybrid")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _ones(cfg, dtype, device):
    return nn.Parameter(torch.ones(cfg.d_model, dtype=dtype, device=device))


class FFN(nn.Module):
    """SwiGLU feed-forward: ``w_gate``, ``w_up`` (d, f), ``w_down`` (f, d)."""

    def __init__(self, cfg, dtype, device, generator=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff

        def dense(shape):
            return nn.Parameter(dense_init(generator, shape, dtype=dtype,
                                           device=device))

        self.w_gate = dense((d, f))
        self.w_up = dense((d, f))
        self.w_down = dense((f, d))


class Layer(nn.Module):
    """One repeated block (the reference's ``init_layer``): ``ln1`` and a
    Mamba2 ``mixer`` (ssm, hybrid; the mixer holds its own expansion), or
    ``ln1``, an attention ``mixer``, ``ln2`` and an ``ffn`` (SwiGLU, or
    the MoE FFN for the moe family)."""

    def __init__(self, cfg, dtype, device, generator=None):
        super().__init__()
        self.ln1 = _ones(cfg, dtype, device)
        if _ssm(cfg):
            self.mixer = ssm_mod.Mamba2(cfg, dtype, device, generator)
            return
        self.mixer = attn.Attention(cfg, dtype, device, generator)
        self.ln2 = _ones(cfg, dtype, device)
        ffn = moe_mod.MoE if cfg.family == "moe" else FFN
        self.ffn = ffn(cfg, dtype, device, generator)


class SharedBlock(nn.Module):
    """The hybrid's weight-tied block (``_init_shared_block``): ``ln1``,
    ``attn``, ``ln2``, ``ffn``."""

    def __init__(self, cfg, dtype, device, generator=None):
        super().__init__()
        self.ln1 = _ones(cfg, dtype, device)
        self.attn = attn.Attention(cfg, dtype, device, generator)
        self.ln2 = _ones(cfg, dtype, device)
        self.ffn = FFN(cfg, dtype, device, generator)


class Transformer(nn.Module):
    """The model's parameters, drawn from ``generator`` (default: one on
    ``device`` seeded 0) in the reference's shapes and types.

    ``device=None`` is the CUDA device and raises where there is none;
    ``device="meta"`` builds the shapes only (allocates nothing)."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device).manual_seed(0)
        dtype = _dtype(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(embed_init(
            generator, (cfg.padded_vocab, cfg.d_model), dtype, device))
        self.layers = nn.ModuleList(
            Layer(cfg, dtype, device, generator) for _ in range(cfg.n_layers))
        self.ln_f = _ones(cfg, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(dense_init(
                generator, (cfg.d_model, cfg.padded_vocab), dtype=dtype,
                device=device))
        if cfg.family == "hybrid" and cfg.attn_every:
            self.shared_attn = SharedBlock(cfg, dtype, device, generator)

    def forward(self, inputs, positions=None, mrope_positions=None,
                patches=None):
        return forward(self, self.cfg, inputs, positions, mrope_positions,
                       patches)


def init_params(cfg, *, device=None, generator=None) -> Transformer:
    """The reference's ``init_params(key, cfg)``: a ``Transformer`` with
    random weights from ``generator`` (by default seeded 0 on ``device``)."""
    return Transformer(cfg, device=device, generator=generator)


def n_params(params) -> int:
    return sum(p.numel() for p in params.parameters())


def _sinusoid(positions, d):
    """musicgen-style sinusoidal position embedding, float32 (..., d)."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _segments(cfg):
    """Hybrid layer segmentation: [(start, len, shared_after), ...]."""
    if cfg.family != "hybrid" or not cfg.attn_every:
        return [(0, cfg.n_layers, False)]
    segs = []
    i = 0
    while i < cfg.n_layers:
        ln = min(cfg.attn_every, cfg.n_layers - i)
        segs.append((i, ln, ln == cfg.attn_every))
        i += ln
    return segs


def n_shared_slots(cfg):
    return sum(1 for _, _, s in _segments(cfg) if s)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _head(params, cfg):
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def _embed(params, cfg, inputs, patches=None):
    """Token ids (b, s) -> embeddings; (b, s, d) embeddings pass through
    in the model's type.  ``patches`` (b, P, d) replace the first P
    positions."""
    if inputs.dim() == 2:
        x = params.embed[inputs.long()]
    else:
        x = inputs.to(_dtype(cfg))
    if patches is not None:
        x = torch.cat([patches.to(x.dtype), x[:, patches.shape[1]:]], dim=1)
    return x


def _add_sinusoid(x, positions, cfg):
    if not cfg.rope and not _ssm(cfg):
        x = x + _sinusoid(positions, cfg.d_model).to(x.dtype)
    return x


def _block(lp, x, positions, mrope_positions, cfg):
    """One layer over the sequence: (x, aux)."""
    h = rms_norm(x, lp.ln1)
    if _ssm(cfg):
        return x + ssm_mod.mamba2_block(lp.mixer, cfg, h), 0.0
    x = x + attn.attention(lp.mixer, cfg, h, positions, mrope_positions,
                           impl=cfg.attn_impl)
    h = rms_norm(x, lp.ln2)
    if cfg.family == "moe":
        y, aux = moe_mod.moe_ffn(lp.ffn, cfg, h, route_sort=cfg.route_sort,
                                 dispatch=cfg.moe_dispatch)
        return x + y, aux
    return x + swiglu(h, lp.ffn.w_gate, lp.ffn.w_up, lp.ffn.w_down), 0.0


def _rematted(cfg):
    """``_block``, under activation checkpointing when ``cfg.remat`` asks
    for it and autograd is recording."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return _block
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    kw = {"use_reentrant": False}
    if cfg.remat_policy != "full":
        # "dots" keeps the 2-D products' outputs (a product of a 3-D
        # activation and a weight reaches autograd as one)
        saved = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]
        kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                   saved)
    return partial(checkpoint, _block, **kw)


def _shared_ffn(sp, x):
    h = rms_norm(x, sp.ln2)
    return x + swiglu(h, sp.ffn.w_gate, sp.ffn.w_up, sp.ffn.w_down)


def _shared_apply(sp, cfg, x, positions):
    h = rms_norm(x, sp.ln1)
    x = x + attn.attention(sp.attn, cfg, h, positions, impl=cfg.attn_impl)
    return _shared_ffn(sp, x)


def forward(params, cfg, inputs, positions=None, mrope_positions=None,
            patches=None):
    """inputs: token ids (b, s) int, or precomputed embeddings (b, s, d).
    ``mrope_positions`` (3, b, s) int; ``patches`` (b, P, d) frontend
    embeddings written over the first P positions.  Returns (logits (b, s,
    padded_vocab), aux), aux the MoE layers' summed load-balancing loss
    (0 for the other families)."""
    x = _embed(params, cfg, inputs, patches)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    x = _add_sinusoid(x, positions, cfg)
    aux = torch.zeros((), device=x.device)
    block = _rematted(cfg)
    for start, ln, shared_after in _segments(cfg):
        for lp in params.layers[start:start + ln]:
            x, a = block(lp, x, positions, mrope_positions, cfg)
            aux = aux + a
        if shared_after:
            x = _shared_apply(params.shared_attn, cfg, x, positions)
    x = rms_norm(x, params.ln_f)
    return x @ _head(params, cfg), aux


# ---------------------------------------------------------------------------
# decode (single token, cached)
# ---------------------------------------------------------------------------


def init_decode_cache(cfg, batch: int, max_len: int, dtype=None, device=None):
    """Zeros; ``device=None`` is the card.  Attention: K/V (layers, b, S,
    kvh, hd).  ssm / hybrid: the conv tail (layers, b, K-1, conv_dim) in
    ``dtype`` and the state (layers, b, h, p, N) in float32, and for the
    hybrid K/V (slots, b, S, kvh, hd), one slot a shared-block
    application."""
    device = resolve_device(device)
    dtype = dtype or _dtype(cfg)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    cache = {}
    kv_layers = cfg.n_layers
    if _ssm(cfg):
        d_in = cfg.ssm_expand * cfg.d_model
        conv_dim = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
        hp = d_in // cfg.ssm_heads
        cache["conv"] = zeros((cfg.n_layers, batch, ssm_mod.CONV_K - 1,
                               conv_dim))
        cache["state"] = zeros((cfg.n_layers, batch, cfg.ssm_heads, hp,
                                cfg.ssm_state), torch.float32)
        if cfg.family != "hybrid":
            return cache
        kv_layers = n_shared_slots(cfg)
    shape = (kv_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache["k"] = zeros(shape)
    cache["v"] = zeros(shape)
    return cache


def _decode_attn_block(lp, cfg, x, ck, cv, cache_len):
    h = rms_norm(x, lp.ln1)
    o, ck, cv = attn.decode_attention(lp.mixer, cfg, h, ck, cv, cache_len)
    x = x + o
    h = rms_norm(x, lp.ln2)
    if cfg.family == "moe":
        y, _ = moe_mod.moe_ffn(lp.ffn, cfg, h, route_sort="none",
                               dispatch=cfg.moe_dispatch)
    else:
        y = swiglu(h, lp.ffn.w_gate, lp.ffn.w_up, lp.ffn.w_down)
    return x + y, ck, cv


@torch.no_grad()
def decode_step(params, cfg, tokens, cache, cache_len):
    """One decode step. tokens: (b, 1) ids or (b, 1, d) embeddings;
    ``cache_len`` (an int, the same for every row) is where the new K/V
    go.  Updates ``cache`` in place and returns (logits (b, vocab),
    cache)."""
    cache_len = int(cache_len)
    x = _embed(params, cfg, tokens)
    if _ssm(cfg):
        slot = 0
        for start, ln, shared_after in _segments(cfg):
            for i in range(start, start + ln):
                lp = params.layers[i]
                h = rms_norm(x, lp.ln1)
                mix, conv, state = ssm_mod.mamba2_decode(
                    lp.mixer, cfg, h, cache["conv"][i], cache["state"][i])
                cache["conv"][i] = conv
                cache["state"][i] = state
                x = x + mix
            if shared_after:
                sp = params.shared_attn
                h = rms_norm(x, sp.ln1)
                o, _, _ = attn.decode_attention(
                    sp.attn, cfg, h, cache["k"][slot], cache["v"][slot],
                    cache_len)
                x = _shared_ffn(sp, x + o)
                slot += 1
    else:
        for i, lp in enumerate(params.layers):
            x, _, _ = _decode_attn_block(lp, cfg, x, cache["k"][i],
                                         cache["v"][i], cache_len)
    x = rms_norm(x, params.ln_f)
    return (x @ _head(params, cfg))[:, 0], cache
