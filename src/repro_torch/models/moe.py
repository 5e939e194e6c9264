"""Mixture-of-Experts routing as the paper's k-of-N bitmap encoding.

A top-k router over E experts gives each token a k-of-E code (qwen2-moe:
4-of-60, olmoe: 8-of-64), so the (tokens x experts) dispatch matrix is a
bitmap index whose rows can be reordered like a table's.  This module
holds the two helpers that build and order that index, in plain PyTorch
as in the reference (``src/repro/models/moe.py``); the packing kernel is
``kernels.ops.moe_route_bitmap``, whose plain version packs the words
here.

The rest of the reference module (the router, expert-parallel dispatch and
the MoE FFN) waits for the port of the LM stack.
"""

from __future__ import annotations

import torch

from ..kernels import ref


def routing_bitmap_words(eids, n_experts: int):
    """k-of-E routing bitmaps packed to words: (E, ceil(T/32)) int32
    bit-views, one row per expert, bit j of word w for token 32w + j.
    Duplicate ids set one bit; ids outside [0, E) set none."""
    return ref.moe_route(eids, n_experts).T.contiguous()


def _stable_argsort(key):
    return torch.sort(key, stable=True).indices


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
