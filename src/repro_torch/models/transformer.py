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
from .common import (dense_init, embed_init, from_local, is_dtensor,
                     logical_to_spec, lshard, mesh_region, placed_as,
                     resolve_device, rms_norm, set_layer, shard_span,
                     spec_to_placements, swiglu)

__all__ = ["FFN", "Layer", "SharedBlock", "Transformer", "cache_axes",
           "decode_step", "forward", "init_decode_cache", "init_params",
           "layer_axes", "n_params", "n_shared_slots", "params_axes"]


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


_FFN_AXES = {"w_gate": ("embed", "ff"), "w_up": ("embed", "ff"),
             "w_down": ("ff", "embed")}


def layer_axes(cfg):
    """The logical axes of one layer's parameters, as a nested dict."""
    ax = {"ln1": ("embed",)}
    if _ssm(cfg):
        ax["mixer"] = ssm_mod.mamba2_axes(cfg)
        return ax
    ax["mixer"] = attn.attention_axes(cfg)
    ax["ln2"] = ("embed",)
    ax["ffn"] = moe_mod.moe_axes(cfg) if cfg.family == "moe" else \
        dict(_FFN_AXES)
    return ax


def _named(tree, prefix=""):
    """``{"a.b": axes}`` of a nested dict of axes tuples."""
    out = {}
    for key, sub in tree.items():
        if isinstance(sub, dict):
            out.update(_named(sub, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = sub
    return out


def params_axes(cfg):
    """``{state_dict name: logical axes}`` mirroring ``init_params(cfg)``.
    The reference stacks the layers and gives each layer leaf a leading
    None; here each ``layers.{i}.*`` leaf takes ``layer_axes`` as is."""
    axes = {"embed": ("vocab", "embed")}
    per_layer = _named(layer_axes(cfg))
    for i in range(cfg.n_layers):
        axes.update({f"layers.{i}.{n}": a for n, a in per_layer.items()})
    axes["ln_f"] = ("embed",)
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    if cfg.family == "hybrid" and cfg.attn_every:
        axes.update(_named({
            "ln1": ("embed",), "attn": attn.attention_axes(cfg),
            "ln2": ("embed",), "ffn": dict(_FFN_AXES)}, "shared_attn."))
    return axes


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


def _sharded_lookup(table, ids):
    """Rows of a DTensor ``table`` (vocab, d) for token ids (b, s), on
    local shards: each rank looks up the ids that fall in its vocab rows
    (zeros for the others), and the rows add over the ranks that split
    the vocab (a partial sum, which the next ``lshard`` reduces).  Neither
    aten.index's backward (index_put) nor aten.embedding's masked partial
    sum has a DTensor rule that works on every PyTorch release."""
    from torch.distributed.tensor import Partial, Replicate

    mesh = table.device_mesh
    if is_dtensor(ids):
        # the ids are whole where the table splits its vocab
        ids = placed_as(ids, [Replicate() if tp.is_shard(0) else ip
                              for tp, ip in zip(table.placements,
                                                ids.placements)])
        id_pl, local_ids = list(ids.placements), ids.to_local()
    else:
        id_pl, local_ids = [Replicate()] * mesh.ndim, ids
    # a rank's table gradient covers its own rows of the batch
    grad = [tp if tp.is_shard(0) else Partial() if ip.is_shard()
            else Replicate() for tp, ip in zip(table.placements, id_pl)]
    off, n = shard_span(table, 0)
    idx = local_ids.long() - off
    hit = ((idx >= 0) & (idx < n))[..., None]
    rows = table.to_local(grad_placements=grad)[idx.clamp(0, n - 1)]
    rows = torch.where(hit, rows, torch.zeros((), dtype=rows.dtype,
                                               device=rows.device))
    out = [Partial() if tp.is_shard(0) else ip
           for tp, ip in zip(table.placements, id_pl)]
    return from_local(rows, mesh, out, (*ids.shape, table.shape[1]))


def _embed(params, cfg, inputs, patches=None):
    """Token ids (b, s) -> embeddings; (b, s, d) embeddings pass through
    in the model's type.  ``patches`` (b, P, d) replace the first P
    positions."""
    if inputs.dim() == 2 and is_dtensor(params.embed):
        x = _sharded_lookup(params.embed, inputs)
    elif inputs.dim() == 2:
        x = params.embed[inputs.long()]
    else:
        x = inputs.to(_dtype(cfg))
    if patches is not None:
        x = torch.cat([patches.to(x.dtype), x[:, patches.shape[1]:]], dim=1)
    return lshard(x, "batch", "seq", "embed")


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
    (0 for the other families).  On a mesh (DTensor parameters) it runs
    under ``mesh_region``."""
    with mesh_region(params, inputs):
        return _forward(params, cfg, inputs, positions, mrope_positions,
                        patches)


def _forward(params, cfg, inputs, positions, mrope_positions, patches):
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
    return lshard(x @ _head(params, cfg), "batch", "seq", "vocab"), aux


# ---------------------------------------------------------------------------
# decode (single token, cached)
# ---------------------------------------------------------------------------


def init_decode_cache(cfg, batch: int, max_len: int, dtype=None, device=None,
                      mesh=None):
    """Zeros; ``device=None`` is the card.  Attention: K/V (layers, b, S,
    kvh, hd).  ssm / hybrid: the conv tail (layers, b, K-1, conv_dim) in
    ``dtype`` and the state (layers, b, h, p, N) in float32, and for the
    hybrid K/V (slots, b, S, kvh, hd), one slot a shared-block
    application.  With a ``DeviceMesh``, each leaf is a DTensor placed by
    ``cache_axes`` under the current ``ShardingCtx`` (each rank allocates
    its own shard only)."""
    device = resolve_device(device)
    dtype = dtype or _dtype(cfg)
    axes = cache_axes(cfg)

    def zeros(shape, dt=dtype, name=None):
        if mesh is None:
            return torch.zeros(shape, dtype=dt, device=device)
        from torch.distributed.tensor import zeros as dzeros

        return dzeros(shape, dtype=dt, device_mesh=mesh,
                      placements=spec_to_placements(
                          logical_to_spec(axes[name]), mesh))

    cache = {}
    kv_layers = cfg.n_layers
    if _ssm(cfg):
        d_in = cfg.ssm_expand * cfg.d_model
        conv_dim = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
        hp = d_in // cfg.ssm_heads
        cache["conv"] = zeros((cfg.n_layers, batch, ssm_mod.CONV_K - 1,
                               conv_dim), name="conv")
        cache["state"] = zeros((cfg.n_layers, batch, cfg.ssm_heads, hp,
                                cfg.ssm_state), torch.float32, "state")
        if cfg.family != "hybrid":
            return cache
        kv_layers = n_shared_slots(cfg)
    shape = (kv_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache["k"] = zeros(shape, name="k")
    cache["v"] = zeros(shape, name="v")
    return cache


def cache_axes(cfg):
    """The logical axes of each ``init_decode_cache`` leaf."""
    ax = {}
    if _ssm(cfg):
        ax["conv"] = (None, "batch", None, "ssm_inner")
        # state (layers, b, heads, p, N): heads across the model axis, so
        # the recurrent update is shard-local
        ax["state"] = (None, "batch", "ssm_heads", None, None)
        if cfg.family != "hybrid":
            return ax
    ax["k"] = (None, "batch", "kv_seq", "kv_heads", "head_dim")
    ax["v"] = (None, "batch", "kv_seq", "kv_heads", "head_dim")
    return ax


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
    with mesh_region(params, tokens):
        return _decode_step(params, cfg, tokens, cache, int(cache_len))


def _decode_step(params, cfg, tokens, cache, cache_len):
    x = _embed(params, cfg, tokens)
    if _ssm(cfg):
        slot = 0
        for start, ln, shared_after in _segments(cfg):
            for i in range(start, start + ln):
                lp = params.layers[i]
                h = rms_norm(x, lp.ln1)
                mix, conv, state = ssm_mod.mamba2_decode(
                    lp.mixer, cfg, h, cache["conv"][i], cache["state"][i])
                set_layer(cache["conv"], i, conv)
                set_layer(cache["state"], i, state)
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
    return lshard((x @ _head(params, cfg))[:, 0], "batch", "vocab"), cache
