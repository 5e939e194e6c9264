"""GQA attention: the prefill paths (dense, and blockwise online softmax)
and the cached single-token decode path.

A copy of the reference's ``src/repro/models/attention.py`` in plain
PyTorch tensor arithmetic (matmul, einsum, softmax; no fused attention
operator), with its numerics: scores ``q . k`` are computed in float32
(the reference's ``preferred_element_type=jnp.float32``), masked with the
finite ``NEG_INF``, and the probabilities are cast to ``v``'s type before
the PV product; the blockwise path keeps its accumulator in ``v``'s type
and ``m`` / ``l`` in float32.  Weights keep the reference's ``(in, out)``
layout and are applied as ``x @ w``.

On the card, float32 checks need TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).

The decode path writes the new K/V into the cache tensors it is given, in
place (the reference returns updated copies).
"""

from __future__ import annotations

import torch
from torch import nn

from .common import apply_mrope, apply_rope, dense_init

__all__ = ["NEG_INF", "Attention", "attention", "decode_attention"]

NEG_INF = -1e30


class Attention(nn.Module):
    """The attention mixer's parameters (the reference's
    ``init_attention``): ``wq``, ``wk``, ``wv``, ``wo`` and, with
    ``qkv_bias``, ``bq``, ``bk``, ``bv`` (zeros at init)."""

    def __init__(self, cfg, dtype, device, generator=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim

        def dense(shape):
            return nn.Parameter(dense_init(generator, shape, dtype=dtype,
                                           device=device))

        self.wq = dense((d, cfg.n_heads * hd))
        self.wk = dense((d, cfg.n_kv_heads * hd))
        self.wv = dense((d, cfg.n_kv_heads * hd))
        self.wo = dense((cfg.n_heads * hd, d))
        if cfg.qkv_bias:
            for name, width in (("bq", cfg.n_heads * hd),
                                ("bk", cfg.n_kv_heads * hd),
                                ("bv", cfg.n_kv_heads * hd)):
                setattr(self, name, nn.Parameter(
                    torch.zeros(width, dtype=dtype, device=device)))


def _scaled(q, hd):
    """``q * hd**-0.5`` with the scale rounded to ``q``'s type first, as
    JAX does with a Python scalar."""
    return q * float(torch.tensor(hd ** -0.5, dtype=q.dtype))


def _project_qkv(p, cfg, x, positions, mrope_positions=None):
    b, s, _ = x.shape
    hd = cfg.head_dim
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    if mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.mrope_sections,
                        cfg.rope_theta)
        k = apply_mrope(k, mrope_positions, cfg.mrope_sections,
                        cfg.rope_theta)
    elif cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _scores(q, k):
    """(b, sq, n, g, d) x (b, sk, n, d) -> (b, n, g, sq, sk) in float32."""
    return torch.einsum("bqngd,bknd->bngqk", q.float(), k.float())


def _blockwise_attn(q, k, v, n_kv_heads, window, block_q=512, block_k=1024):
    """Online-softmax attention over KV blocks (flash-style).

    q: (b, sq, h, hd)  k/v: (b, sk, kvh, hd).  Causal; optional sliding
    window.  Memory O(sq * block_k) instead of O(sq * sk).
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    g = h // n_kv_heads
    q = _scaled(q.reshape(b, sq, n_kv_heads, g, hd), hd)

    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(f"sequence lengths {sq}, {sk} are not multiples "
                         f"of the blocks {block_q}, {block_k}")
    nq, nk = sq // block_q, sk // block_k
    dev = q.device
    outs = []
    for qi in range(nq):
        qb = q[:, qi * block_q:(qi + 1) * block_q]
        q_pos = qi * block_q + torch.arange(block_q, device=dev)
        acc = torch.zeros((b, n_kv_heads, g, block_q, hd), dtype=v.dtype,
                          device=dev)
        m = torch.full((b, n_kv_heads, g, block_q), NEG_INF,
                       dtype=torch.float32, device=dev)
        l = torch.zeros((b, n_kv_heads, g, block_q), dtype=torch.float32,
                        device=dev)
        # only kv blocks with k_start <= q_end are relevant (causal skip)
        hi = min((qi * block_q + block_q + block_k - 1) // block_k, nk)
        for ki in range(hi):
            kb = k[:, ki * block_k:(ki + 1) * block_k]
            vb = v[:, ki * block_k:(ki + 1) * block_k]
            s_ = _scores(qb, kb)
            k_pos = ki * block_k + torch.arange(block_k, device=dev)
            mask = k_pos[None, :] <= q_pos[:, None]
            if window:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            s_ = torch.where(mask, s_, NEG_INF)
            m_new = torch.maximum(m, s_.amax(-1))
            p_ = torch.exp(s_ - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p_.sum(-1)
            pv = torch.einsum("bngqk,bknd->bngqd", p_.to(vb.dtype), vb)
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None].to(acc.dtype))
    out = torch.cat(outs, dim=3)  # (b, kvh, g, sq, hd)
    # (b, kvh, g, sq, hd) -> (b, sq, h, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)


def _dense_attn(q, k, v, n_kv_heads, window, q_offset=0):
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    g = h // n_kv_heads
    q = _scaled(q.reshape(b, sq, n_kv_heads, g, hd), hd)
    s_ = _scores(q, k)
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    s_ = torch.where(mask, s_, NEG_INF)
    p_ = torch.softmax(s_, dim=-1).to(v.dtype)
    out = torch.einsum("bngqk,bknd->bqngd", p_, v)
    return out.reshape(b, sq, h, hd)


def attention(p, cfg, x, positions, mrope_positions=None, impl="blockwise",
              return_kv=False):
    """Prefill attention. x: (b, s, d) -> (b, s, d); dense when
    ``impl == "dense"`` or ``s <= 1024``, as in the reference.
    ``mrope_positions`` (3, b, s) rotates by M-RoPE instead of RoPE.

    return_kv=True additionally returns the (k, v) projections so prefill
    can populate the decode cache in one pass (serve.prefill)."""
    b, s, d = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions, mrope_positions)
    window = cfg.sliding_window or None
    if impl == "dense" or s <= 1024:
        o = _dense_attn(q, k, v, cfg.n_kv_heads, window)
    else:
        o = _blockwise_attn(q, k, v, cfg.n_kv_heads, window)
    out = o.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p.wo
    if return_kv:
        return out, k, v
    return out


def decode_attention(p, cfg, x, cache_k, cache_v, cache_len: int,
                     mrope_positions=None):
    """Single-token decode with a KV cache.

    x: (b, 1, d); cache_k/v: (b, S, kvh, hd); cache_len: the current
    length, the same for every row (the new token is written at it).
    Any ``mrope_positions`` is replaced by ``cache_len`` in all three
    components, as in the reference.
    Writes the new K/V into ``cache_k`` / ``cache_v`` in place and returns
    (out, cache_k, cache_v).
    """
    b = x.shape[0]
    S = cache_k.shape[1]
    if not 0 <= cache_len < S:
        raise ValueError(f"cache_len {cache_len} outside a cache of {S}")
    positions = torch.full((b, 1), cache_len, dtype=torch.int32,
                           device=x.device)
    if mrope_positions is not None:
        mrope_positions = positions.expand(3, b, 1)
    q, k, v = _project_qkv(p, cfg, x, positions, mrope_positions)
    cache_k[:, cache_len] = k[:, 0].to(cache_k.dtype)
    cache_v[:, cache_len] = v[:, 0].to(cache_v.dtype)
    g = cfg.n_heads // cfg.n_kv_heads
    qh = _scaled(q.reshape(b, 1, cfg.n_kv_heads, g, cfg.head_dim),
                 cfg.head_dim)
    s_ = _scores(qh, cache_k)
    k_pos = torch.arange(S, device=x.device)[None, :]
    valid = k_pos <= cache_len
    if cfg.sliding_window:
        valid &= k_pos > cache_len - cfg.sliding_window
    s_ = torch.where(valid, s_, NEG_INF)
    p_ = torch.softmax(s_, dim=-1).to(cache_v.dtype)
    o = torch.einsum("bngqk,bknd->bqngd", p_, cache_v)
    out = o.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ p.wo
    return out, cache_k, cache_v
