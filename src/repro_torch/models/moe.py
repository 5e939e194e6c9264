"""Mixture-of-Experts with bitmap-encoded dispatch (the paper, transplanted).

A top-k router over E experts gives each token a k-of-E code (qwen2-moe:
4-of-60, olmoe: 8-of-64), so the (tokens x experts) dispatch matrix is a
bitmap index whose rows can be reordered like a table's:

  * ``route_sort="expert"``   -- named for a plain sort by first expert id;
    as in the reference it orders slots exactly as ``"none"`` does.
  * ``route_sort="grayfreq"`` -- Gray-Frequency: tokens with identical (and
    popular) expert sets cluster, so the EWAH-compressed dispatch metadata
    shrinks and expert gathers become runs.

A copy of the reference's ``src/repro/models/moe.py`` in PyTorch: the
router, capacity-based ``"gather"`` (per-sequence plan) and ``"scatter"``
(global plan) dispatch, the fused shared experts and the Switch-style
auxiliary loss.  The expert products are ``torch.einsum`` over the
(E_pad, cap) slot buffer, as the reference leaves them to XLA.  Where
the reference relies on JAX orderings the port builds them explicitly:
the top k come from a stable descending sort (``lax.top_k``: descending,
the lower index first on ties), every argsort is stable, and
``jnp.lexsort`` is stable sorts, least significant key first.  The
combine gathers each token's k slots and adds them in ascending expert
order in the activations' type: the order of the reference's scatter-add,
and deterministic on the card (``index_add_`` there uses atomics).

``routing_bitmap_words`` and ``grayfreq_token_order`` build and order the
dispatch bitmap index; the packing kernel is ``kernels.ops.
moe_route_bitmap``, whose plain version packs the words here.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import ref
from .common import dense_init, is_dtensor, lshard, replicated, silu

__all__ = ["MoE", "SharedExperts", "grayfreq_token_order", "moe_axes",
           "moe_ffn", "padded_experts", "routing_bitmap_words"]


def padded_experts(n_experts: int) -> int:
    """The expert dim padded to a multiple of 16 above 16 experts, as the
    reference pads for its expert-parallel shards (padded experts receive
    no tokens)."""
    if n_experts <= 16:
        return n_experts
    return -(-n_experts // 16) * 16


class SharedExperts(nn.Module):
    """qwen2-moe's shared experts fused into one FFN of width
    ``shared_d_ff``: ``w_gate``, ``w_up`` (d, sff), ``w_down`` (sff, d)."""

    def __init__(self, cfg, dtype, device, generator=None):
        super().__init__()
        d, sff = cfg.d_model, cfg.shared_d_ff

        def dense(shape):
            return nn.Parameter(dense_init(generator, shape, dtype=dtype,
                                           device=device))

        self.w_gate = dense((d, sff))
        self.w_up = dense((d, sff))
        self.w_down = dense((sff, d))


class MoE(nn.Module):
    """The MoE FFN's parameters (the reference's ``init_moe``): ``router``
    (d, E) float32; ``w_gate``, ``w_up`` (E_pad, d, f) and ``w_down``
    (E_pad, f, d) in the model's type (drawn with the reference's fan-in,
    the leading axis); ``shared`` when ``n_shared_experts > 0``."""

    def __init__(self, cfg, dtype, device, generator=None):
        super().__init__()
        d, ff, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        ep = padded_experts(e)

        def dense(shape, dt=dtype):
            return nn.Parameter(dense_init(generator, shape, dtype=dt,
                                           device=device))

        self.router = dense((d, e), torch.float32)
        self.w_gate = dense((ep, d, ff))
        self.w_up = dense((ep, d, ff))
        self.w_down = dense((ep, ff, d))
        if cfg.n_shared_experts:
            self.shared = SharedExperts(cfg, dtype, device, generator)


def moe_axes(cfg):
    """The logical axes of each MoE parameter."""
    ax = {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", None),
        "w_up": ("experts", "embed", None),
        "w_down": ("experts", None, "embed"),
    }
    if cfg.n_shared_experts:
        ax["shared"] = {
            "w_gate": ("embed", "ff"),
            "w_up": ("embed", "ff"),
            "w_down": ("ff", "embed"),
        }
    return ax


def _stable_argsort(key, dim=-1):
    return torch.sort(key, dim=dim, stable=True).indices


def _route(p, cfg, xf):
    """Router: top-k expert ids, normalised gates and the logits.
    xf: (T, d).  Ties go to the lower expert id, as in ``lax.top_k``."""
    logits = xf.float() @ p.router  # (T, E)
    order = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = order.values[:, :cfg.top_k]
    eids = order.indices[:, :cfg.top_k]
    return eids, torch.softmax(gates, dim=-1), logits


def routing_bitmap_words(eids, n_experts: int):
    """k-of-E routing bitmaps packed to words: (E, ceil(T/32)) int32
    bit-views, one row per expert, bit j of word w for token 32w + j.
    Duplicate ids set one bit; ids outside [0, E) set none."""
    return ref.moe_route(eids, n_experts).T.contiguous()


def grayfreq_token_order(eids, n_experts: int):
    """Gray-Frequency row ordering for the dispatch bitmap index.

    Token key = (frequency rank of its expert-set class, expert ids):
    tokens with identical popular expert sets become adjacent runs (the
    paper's section 4.2 applied to the routing table).  The same
    permutation as the reference's ``jnp.lexsort`` passes, built from
    stable sorts, least significant key first.
    """
    T, k = eids.shape
    se = torch.sort(eids, dim=1).values  # canonical (sorted) set per token
    order = torch.arange(T, device=eids.device)
    for i in range(k - 1, -1, -1):       # se[:, 0] is the primary key
        order = order[_stable_argsort(se[order, i])]
    sse = se[order]
    new = torch.ones(T, dtype=torch.bool, device=eids.device)
    new[1:] = (sse[1:] != sse[:-1]).any(dim=1)
    grp = torch.cumsum(new, 0) - 1
    freq = torch.bincount(grp, minlength=T)[grp]
    # descending frequency first, group id to break ties
    reorder = _stable_argsort(grp)
    reorder = reorder[_stable_argsort(-freq[reorder])]
    return order[reorder]


def _slots(a_eid, cap, e):
    """Each sorted assignment's slot ``eid * cap + position within its
    expert``, and ``e * cap`` (the drop slot) past the capacity.  a_eid:
    (..., n) sorted by expert along the last axis."""
    n = a_eid.shape[-1]
    idx = torch.arange(n, device=a_eid.device).expand_as(a_eid)
    new = torch.ones_like(a_eid, dtype=torch.bool)
    new[..., 1:] = a_eid[..., 1:] != a_eid[..., :-1]
    seg_start = torch.cummax(torch.where(new, idx, 0), dim=-1).values
    pos = idx - seg_start
    return torch.where(pos < cap, a_eid * cap + pos, e * cap)


def _experts(p, buf):
    """SwiGLU of every expert over its slots: buf (..., E_pad, cap, d)."""
    h = torch.einsum("...ecd,edf->...ecf", buf, p.w_gate)
    u = torch.einsum("...ecd,edf->...ecf", buf, p.w_up)
    return torch.einsum("...ecf,efd->...ecd", silu(h) * u, p.w_down)


def _combine(out, slot, eids, gates):
    """Each token's gated expert outputs, added in ascending expert order
    in ``out``'s type.  out: (..., E_pad * cap, d); slot, eids: (..., T, k)
    with the drop slot ``E_pad * cap`` for a token its expert had no room
    for; gates: (..., T, k) in ``out``'s type."""
    rows = torch.cat([out, out.new_zeros(*out.shape[:-2], 1, out.shape[-1])],
                     dim=-2)  # the drop slot reads zeros
    by_expert = _stable_argsort(eids)
    slot = torch.gather(slot, -1, by_expert)
    gates = torch.gather(gates, -1, by_expert)
    lead = slot.shape[:-2]
    flat = slot.reshape(*lead, -1, 1).expand(*lead, -1, out.shape[-1])
    picked = torch.gather(rows, -2, flat).reshape(*slot.shape, -1)
    picked = picked * gates[..., None]
    y = picked[..., 0, :]
    for j in range(1, picked.shape[-2]):
        y = y + picked[..., j, :]
    return y


def _unsort(order, values):
    """``values`` (sorted along the last axis by ``order``) back in the
    original order."""
    return torch.empty_like(values).scatter_(-1, order, values)


def moe_ffn(p, cfg, x, capacity_factor=None, route_sort="none",
            dispatch="gather"):
    """x: (b, s, d) -> ((b, s, d), aux).

    ``dispatch="gather"``: a per-sequence (E_pad, cap) slot plan, tokens
    gathered into a (b, E_pad, cap, d) buffer.  ``dispatch="scatter"``: one
    plan over all b * s tokens, scattered into an (E_pad, cap, d) buffer.
    Tokens past an expert's capacity are dropped (they get no output from
    it); the capacity counts ``cfg.n_experts``, the slots the padded
    experts.
    """
    b, s, d = x.shape
    e, k = p.w_gate.shape[0], cfg.top_k  # e includes the padding
    if capacity_factor is None:
        capacity_factor = getattr(cfg, "moe_capacity_factor", 1.25)
    T = b * s
    dev = x.device
    # on a mesh: the token plan's sorts, scatters and gathers (aten.sort,
    # scatter_, cummax, index.Tensor, gather) index the token dimension,
    # which DTensor has no rule to shard through, so the tokens are
    # replicated first; every rank builds the same integer plan from the
    # replicated expert ids, and only the slot buffer's expert dimension
    # is sharded ("experts" on the model axis)
    x = replicated(x)
    xf = x.reshape(T, d)
    eids, gates, logits = _route(p, cfg, xf)
    if is_dtensor(eids):
        eids = eids.full_tensor()

    if dispatch == "gather":
        cap = int(capacity_factor * s * k / cfg.n_experts + 0.5)
        cap = max(8, min(cap, s))
        be = eids.reshape(b, s, k)
        a_eid = be.reshape(b, s * k)
        tok = torch.arange(s, device=dev).repeat_interleave(k).expand(
            b, s * k)
        if route_sort == "grayfreq":
            # similar expert sets adjacent within the sequence, keyed on
            # the two smallest expert ids, dense-ranked
            se = torch.sort(be, dim=2).values
            raw = se[:, :, 0] * e + (se[:, :, 1] if k > 1 else 0)
            sub = _stable_argsort(_stable_argsort(raw, dim=1), dim=1)
            sub = sub.repeat_interleave(k, dim=1)
        else:
            sub = tok
        order = _stable_argsort(a_eid * (s * k) + sub, dim=1)
        a_eid = torch.gather(a_eid, 1, order)
        tok = torch.gather(tok, 1, order)
        slot = _slots(a_eid, cap, e)

        # slot -> token plan; unfilled slots read the zero row s
        tok_for_slot = torch.full((b, e * cap + 1), s, dtype=tok.dtype,
                                  device=dev).scatter_(1, slot, tok)[:, :-1]
        xpad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)
        buf = xpad[torch.arange(b, device=dev)[:, None], tok_for_slot]
        buf = lshard(buf.reshape(b, e, cap, d),
                     "batch", "experts", "expert_cap", "embed")
        out = lshard(_experts(p, buf),
                     "batch", "experts", "expert_cap", "embed")
        # aten.gather over the expert slots: no rule for a sharded slot dim
        out = replicated(out).reshape(b, e * cap, d)
        y = _combine(out, _unsort(order, slot).reshape(b, s, k), be,
                     gates.reshape(b, s, k).to(x.dtype)).reshape(T, d)
    else:
        cap = int(capacity_factor * T * k / cfg.n_experts + 0.5)
        cap = max(8, min(cap, T))
        tok = torch.arange(T, device=dev).repeat_interleave(k)
        a_eid = eids.reshape(-1)
        if route_sort == "grayfreq":
            perm = grayfreq_token_order(eids, e)
            inv_rank = torch.empty_like(perm).scatter_(
                0, perm, torch.arange(T, device=dev))
            sub = inv_rank[tok]
        else:
            sub = tok
        # jnp.lexsort((sub, a_eid)): a_eid primary, sub secondary
        order = _stable_argsort(sub)
        order = order[_stable_argsort(a_eid[order])]
        a_eid, tok = a_eid[order], tok[order]
        slot = _slots(a_eid, cap, e)
        buf = x.new_zeros(e * cap + 1, d)
        buf[slot] = xf[tok]  # only the drop slot takes several rows
        buf = lshard(buf[:-1].reshape(e, cap, d),
                     "experts", "expert_cap", "embed")
        out = lshard(_experts(p, buf), "experts", "expert_cap", "embed")
        # aten.gather over the expert slots: no rule for a sharded slot dim
        out = replicated(out).reshape(e * cap, d)
        y = _combine(out, _unsort(order, slot).reshape(T, k), eids,
                     gates.to(x.dtype))

    if cfg.n_shared_experts:
        # the shared experts, fused into one wide FFN
        sp = p.shared
        y = y + (silu(xf @ sp.w_gate) * (xf @ sp.w_up)) @ sp.w_down
    y = y.reshape(b, s, d)

    # Switch-style load-balancing loss over the unpadded experts
    probs = torch.softmax(logits, dim=-1)
    load = torch.zeros(cfg.n_experts, device=dev).index_add_(
        0, eids.reshape(-1), torch.ones(T * k, device=dev)) / (T * k)
    aux = cfg.n_experts * torch.sum(load * probs.mean(0))
    return lshard(y, "batch", "seq", "embed"), aux
