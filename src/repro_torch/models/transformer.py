"""Model assembly: embedding -> layer stack -> head, for the dense family.

The reference (``src/repro/models/transformer.py``) stacks every layer's
parameters on a leading axis and scans over them; here a ``Transformer``
holds an ``nn.ModuleList`` of blocks, whose parameter names mirror the
reference tree (``embed``, ``layers.{i}.ln1``, ``layers.{i}.mixer.wq``,
..., ``layers.{i}.ffn.w_down``, ``ln_f``, ``lm_head``), so that
``convert.params_from_reference`` carries a reference tree across by name.

Only the dense family is ported (tinyllama-1.1b, qwen2-7b, qwen2.5-14b,
phi3-medium-14b).  The other families raise ``NotImplementedError`` and
name the ROADMAP queue item that ports them.  No remat: that is training.

The serving functions (``decode_step`` here, ``serve.prefill``,
``train.step.serve_step``) run without autograd and update the KV cache
in place.
"""

from __future__ import annotations

import torch
from torch import nn

from . import attention as attn
from .common import dense_init, embed_init, resolve_device, rms_norm, swiglu

__all__ = ["FFN", "Layer", "Transformer", "check_family", "decode_step",
           "forward", "init_decode_cache", "init_params", "n_params"]

_NOT_PORTED = {
    "moe": "the MoE router and moe_ffn (ROADMAP queue 1, item 2: the rest "
           "of models/moe.py)",
    "ssm": "models/ssm.py (ROADMAP queue 1, item 2: mamba2)",
    "hybrid": "models/ssm.py and the shared attention block (ROADMAP queue "
              "1, item 2: mamba2/zamba2)",
    "vlm": "M-RoPE and the patch frontend (ROADMAP queue 1, item 2: the "
           "vlm and audio families)",
    "audio": "the sinusoidal positions and frame frontend (ROADMAP queue "
             "1, item 2: the vlm and audio families)",
}


def check_family(cfg) -> None:
    """Raise for a family the port does not run yet."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported; it waits "
            f"for {_NOT_PORTED.get(cfg.family, 'its port')}")


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


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
    """One repeated block (the reference's ``init_layer``): ``ln1``,
    ``mixer`` (attention), ``ln2``, ``ffn``."""

    def __init__(self, cfg, dtype, device, generator=None):
        super().__init__()
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                           device=device))
        self.mixer = attn.Attention(cfg, dtype, device, generator)
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                           device=device))
        self.ffn = FFN(cfg, dtype, device, generator)


class Transformer(nn.Module):
    """The dense decoder's parameters, drawn from ``generator`` (default:
    one on ``device`` seeded 0) in the reference's shapes and types.

    ``device=None`` is the CUDA device and raises where there is none;
    ``device="meta"`` builds the shapes only (allocates nothing)."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        check_family(cfg)
        device = resolve_device(device)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device).manual_seed(0)
        dtype = _dtype(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(embed_init(
            generator, (cfg.padded_vocab, cfg.d_model), dtype, device))
        self.layers = nn.ModuleList(
            Layer(cfg, dtype, device, generator) for _ in range(cfg.n_layers))
        self.ln_f = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                            device=device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(dense_init(
                generator, (cfg.d_model, cfg.padded_vocab), dtype=dtype,
                device=device))

    def forward(self, inputs, positions=None):
        return forward(self, self.cfg, inputs, positions)


def init_params(cfg, *, device=None, generator=None) -> Transformer:
    """The reference's ``init_params(key, cfg)``: a ``Transformer`` with
    random weights from ``generator`` (by default seeded 0 on ``device``)."""
    return Transformer(cfg, device=device, generator=generator)


def n_params(params) -> int:
    return sum(p.numel() for p in params.parameters())


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _head(params, cfg):
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def _embed(params, cfg, inputs):
    """Token ids (b, s) -> embeddings; (b, s, d) embeddings pass through
    in the model's type."""
    if inputs.dim() == 2:
        return params.embed[inputs.long()]
    return inputs.to(_dtype(cfg))


def _block(lp, x, positions, cfg):
    h = rms_norm(x, lp.ln1)
    x = x + attn.attention(lp.mixer, cfg, h, positions, impl=cfg.attn_impl)
    h = rms_norm(x, lp.ln2)
    return x + swiglu(h, lp.ffn.w_gate, lp.ffn.w_up, lp.ffn.w_down)


def forward(params, cfg, inputs, positions=None):
    """inputs: token ids (b, s) int, or precomputed embeddings (b, s, d).
    Returns (logits (b, s, padded_vocab), aux), aux 0 for the dense
    family."""
    check_family(cfg)
    x = _embed(params, cfg, inputs)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    for lp in params.layers:
        x = _block(lp, x, positions, cfg)
    x = rms_norm(x, params.ln_f)
    return x @ _head(params, cfg), torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# decode (single token, cached)
# ---------------------------------------------------------------------------


def init_decode_cache(cfg, batch: int, max_len: int, dtype=None, device=None):
    """K/V (layers, b, S, kvh, hd), zeros; ``device=None`` is the card."""
    check_family(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    device = resolve_device(device)
    dtype = dtype or _dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _decode_attn_block(lp, cfg, x, ck, cv, cache_len):
    h = rms_norm(x, lp.ln1)
    o, ck, cv = attn.decode_attention(lp.mixer, cfg, h, ck, cv, cache_len)
    x = x + o
    h = rms_norm(x, lp.ln2)
    y = swiglu(h, lp.ffn.w_gate, lp.ffn.w_up, lp.ffn.w_down)
    return x + y, ck, cv


@torch.no_grad()
def decode_step(params, cfg, tokens, cache, cache_len):
    """One decode step. tokens: (b, 1) ids or (b, 1, d) embeddings;
    ``cache_len`` (an int, the same for every row) is where the new K/V
    go.  Updates ``cache`` in place and returns (logits (b, vocab),
    cache)."""
    check_family(cfg)
    cache_len = int(cache_len)
    x = _embed(params, cfg, tokens)
    for i, lp in enumerate(params.layers):
        x, _, _ = _decode_attn_block(lp, cfg, x, cache["k"][i],
                                     cache["v"][i], cache_len)
    x = rms_norm(x, params.ln_f)
    return (x @ _head(params, cfg))[:, 0], cache
