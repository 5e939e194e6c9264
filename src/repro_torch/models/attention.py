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

from .common import (apply_mrope, apply_rope, dense_init, from_local,
                     is_dtensor, lshard, placed_as, shard_count, shard_span,
                     unsharded)

__all__ = ["NEG_INF", "Attention", "attention", "attention_axes",
           "decode_attention", "write_kv"]

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


def attention_axes(cfg):
    """The logical axes of each attention parameter."""
    ax = {
        "wq": ("embed", "heads"),
        "wk": ("embed", "kv_heads"),
        "wv": ("embed", "kv_heads"),
        "wo": ("heads", "embed"),
    }
    if cfg.qkv_bias:
        ax.update({"bq": ("heads",), "bk": ("kv_heads",), "bv": ("kv_heads",)})
    return ax


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
    q = _split_heads(q, cfg.n_heads, hd)
    k = _split_heads(k, cfg.n_kv_heads, hd)
    v = _split_heads(v, cfg.n_kv_heads, hd)
    if mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.mrope_sections,
                        cfg.rope_theta)
        k = apply_mrope(k, mrope_positions, cfg.mrope_sections,
                        cfg.rope_theta)
    elif cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = lshard(q, "batch", "seq", "heads", "head_dim")
    k = lshard(k, "batch", "seq", "kv_heads", "head_dim")
    v = lshard(v, "batch", "seq", "kv_heads", "head_dim")
    return q, k, v


def _split_heads(x, n, hd):
    """(b, s, n * hd) -> (b, s, n, hd).  On a mesh, a last dimension split
    over a number of ranks that does not divide ``n`` is replicated first:
    DTensor has no rule for an unflatten into uneven head shards."""
    if is_dtensor(x) and n % shard_count(x, -1):
        x = unsharded(x, -1)
    return x.reshape(*x.shape[:-1], n, hd)


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
    core = _dense_attn if impl == "dense" or s <= 1024 else _blockwise_attn
    if is_dtensor(q):
        # on a mesh the core runs on each rank's batch rows and heads
        # (independent of the others'), as plain tensors: the products'
        # flattens of a tensor sharded on two dimensions have no view rule
        # on every PyTorch release
        ql, kl, vl, n_kv, qp = _local_heads(q, k, v)
        o = from_local(core(ql, kl, vl, n_kv, window), q.device_mesh, qp,
                       q.shape)
    else:
        o = core(q, k, v, cfg.n_kv_heads, window)
    o = lshard(o, "batch", "seq", "heads", "head_dim")
    # heads left whole where the model axis does not divide them: the
    # merged dimension is split again (a local slice), so that the
    # gradient reaching the unflatten in the backward comes back whole
    o = lshard(o.reshape(b, s, cfg.n_heads * cfg.head_dim),
               "batch", "seq", "heads")
    out = o @ p.wo
    out = lshard(out, "batch", "seq", "embed")
    if return_kv:
        return out, k, v
    return out


def _without(placements, *dims):
    """``placements`` with a ``Shard`` of any of ``dims`` replicated."""
    from torch.distributed.tensor import Replicate

    return [Replicate() if any(p.is_shard(d) for d in dims) else p
            for p in placements]


def write_kv(cache, new, start: int):
    """Write ``new`` (b, n, kvh, hd) into ``cache`` (b, S, kvh, hd) at
    positions [start, start + n), in place, and return ``cache``.

    On a mesh the cache's sequence dimension is sharded ("kv_seq" on the
    model axis), and an in-place slice write there belongs to one rank:
    each rank writes the new rows that fall in its own positions into its
    local shard (``new`` placed as the cache with its sequence whole)."""
    n = new.shape[1]
    if not is_dtensor(cache):
        cache[:, start:start + n] = new.to(cache.dtype)
        return cache
    off, length = shard_span(cache, 1)
    new = placed_as(new, _without(cache.placements, 1)).to_local()
    lo, hi = max(start, off), min(start + n, off + length)
    if lo < hi:
        with torch.no_grad():
            cache.to_local()[:, lo - off:hi - off] = \
                new[:, lo - start:hi - start].to(cache.dtype)
    return cache


def _local_heads(q, k, v):
    """On a mesh: (q, k, v, kv heads, q placements) for the attention
    core on this rank's shards, as plain tensors: q keeps its batch and
    head shards, k and v their batch shard and the kv heads this rank's
    query heads read (GQA: query head j reads kv head j // g).  A head
    split that does not align with the kv groups replicates the heads."""
    h, kvh = q.shape[2], k.shape[2]
    g = h // kvh
    qp = _without(q.placements, 1, 3)
    kvp = _without(q.placements, 1, 2, 3)
    q = placed_as(q, qp)
    off, h_l = shard_span(q, 2)
    lo, hi = off // g, (off + h_l - 1) // g + 1
    if not ((off % g == 0 and h_l % g == 0) or hi - lo == 1):
        qp = kvp
        q = placed_as(q, qp)
        lo, hi = 0, kvh
    # ranks that split the heads each read their own kv heads: the
    # gradient of k and v adds over them
    from torch.distributed.tensor import Partial

    grad = [Partial() if qpl.is_shard(2) else pl
            for pl, qpl in zip(kvp, qp)]
    k = placed_as(k, kvp).to_local(grad_placements=grad)[:, :, lo:hi]
    v = placed_as(v, kvp).to_local(grad_placements=grad)[:, :, lo:hi]
    return q.to_local(), k, v, hi - lo, qp


def _decode_scores(cfg, q, cache_k, cache_len, offset):
    """Masked float32 scores (b, n, g, 1, S) of q (b, 1, h, hd) against
    the cache positions [offset, offset + S)."""
    b, S = q.shape[0], cache_k.shape[1]
    g = cfg.n_heads // cfg.n_kv_heads
    qh = _scaled(q.reshape(b, 1, cfg.n_kv_heads, g, cfg.head_dim),
                 cfg.head_dim)
    s_ = _scores(qh, cache_k)
    k_pos = offset + torch.arange(S, device=q.device)[None, :]
    valid = k_pos <= cache_len
    if cfg.sliding_window:
        valid &= k_pos > cache_len - cfg.sliding_window
    return torch.where(valid, s_, NEG_INF)


def _decode_core(cfg, q, cache_k, cache_v, cache_len, offset=0):
    """(b, 1, n, g, hd) attention of q over a whole cache."""
    s_ = _decode_scores(cfg, q, cache_k, cache_len, offset)
    p_ = torch.softmax(s_, dim=-1).to(cache_v.dtype)
    return torch.einsum("bngqk,bknd->bqngd", p_, cache_v)


def _sharded_decode(cfg, q, cache_k, cache_v, cache_len):
    """The decode core on a mesh, on local shards: q placed as the
    cache's batch with every head, each rank's scores over its own cache
    positions.  With the sequence whole on every rank this is the
    one-card core; with it split, each rank's partial softmax (its
    maximum, exp-sum and weighted values, in float32) is combined across
    the ranks that split it (all-reduces on those mesh axes' groups)."""
    import torch.distributed as dist

    mesh = cache_k.device_mesh
    qp = _without(cache_k.placements, 1)
    ql = placed_as(q, qp).to_local()
    off, _ = shard_span(cache_k, 1)
    ck, cv = cache_k.to_local(), cache_v.to_local()
    split = [md for md, p in enumerate(cache_k.placements)
             if p.is_shard(1) and mesh.size(md) > 1]
    if not split:
        o = _decode_core(cfg, ql, ck, cv, cache_len, off)
    else:
        s_ = _decode_scores(cfg, ql, ck, cache_len, off)
        m = s_.amax(-1, keepdim=True)
        for md in split:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.get_group(md))
        e = torch.exp(s_ - m)
        parts = [e.sum(-1), torch.einsum("bngqk,bknd->bqngd", e, cv.float())]
        for t in parts:
            for md in split:
                dist.all_reduce(t, group=mesh.get_group(md))
        # (b, n, g, 1) sums against (b, 1, n, g, hd) weighted values
        o = (parts[1] / parts[0].permute(0, 3, 1, 2)[..., None]).to(cv.dtype)
    return from_local(o, mesh, qp, (q.shape[0], *o.shape[1:]))


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
    cache_k = lshard(write_kv(cache_k, k, cache_len),
                     "batch", "kv_seq", "kv_heads", "head_dim")
    cache_v = lshard(write_kv(cache_v, v, cache_len),
                     "batch", "kv_seq", "kv_heads", "head_dim")
    if is_dtensor(cache_k):
        o = _sharded_decode(cfg, q, cache_k, cache_v, cache_len)
    else:
        o = _decode_core(cfg, q, cache_k, cache_v, cache_len)
    out = o.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ p.wo
    return lshard(out, "batch", "seq", "embed"), cache_k, cache_v
