"""The paper's technique on MoE routing bitmaps: EWAH size of the dispatch
index under three row orders.

Top-k routing over E experts is a k-of-E bitmap encoding of the tokens.
For the two MoE architectures the repository supports, this measures the
EWAH-compressed size of the (tokens x experts) dispatch bitmaps when the
tokens come unsorted, sorted by first expert id (Alpha-Lex) and in
Gray-Frequency order: the paper's Table-4 row orders applied to the
routing table.  The packing runs on the card through
``kernels.ops.moe_route_bitmap``; each expert column is then compressed
by the host codec ``core.ewah.compress``.

The port's copy of ``routed_assignments``, ``compressed_dispatch_size``,
``run`` and ``validate`` from ``benchmarks/bench_moe_dispatch.py``; rows
carry no kernel wall-clock (the reference's is an interpret-mode time).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import ewah
from ..kernels import ops
from .moe import grayfreq_token_order

#: (name, experts, top-k) of the supported MoE configurations.
ARCHS = (("qwen2-moe-a2.7b", 60, 4), ("olmoe-1b-7b", 64, 8))


def routed_assignments(T, E, k, skew=1.2, seed=0):
    """Skewed routing: expert popularity ~ zipf, k distinct experts per
    token drawn without replacement."""
    rng = np.random.default_rng(seed)
    pop = (np.arange(1, E + 1) ** -skew)
    pop /= pop.sum()
    eids = np.stack(
        [rng.choice(E, size=k, replace=False, p=pop) for _ in range(T)])
    return eids.astype(np.int32)


def dispatch_words(eids, E, order=None, device="cuda"):
    """(T, k) numpy ids (rows permuted by ``order``) -> (ceil(T/32), E)
    uint32 dispatch words, packed on ``device``."""
    if order is not None:
        eids = eids[order]
    words = ops.moe_route_bitmap(
        torch.from_numpy(np.ascontiguousarray(eids)).to(device), E)
    return words.cpu().numpy().view(np.uint32)


def compressed_dispatch_size(eids, E, order=None, device="cuda"):
    """Total EWAH words of the E expert columns of the dispatch index."""
    words = dispatch_words(eids, E, order, device)
    return sum(len(ewah.compress(words[:, e])) for e in range(E))


def token_orders(eids, E, device="cuda"):
    """The three row orders: None (unsorted), expert-sorted, Gray-Frequency
    (computed on ``device``)."""
    gray = grayfreq_token_order(torch.from_numpy(eids).to(device), E)
    return {"unsorted": None,
            "expert_sorted": np.argsort(eids[:, 0], kind="stable"),
            "grayfreq": gray.cpu().numpy()}


def run(T=16384, device="cuda"):
    """One row per architecture: compressed words under each order and the
    uncompressed word count."""
    out = []
    for name, E, k in ARCHS:
        eids = routed_assignments(T, E, k)
        row = {"arch": name, "T": T, "E": E, "k": k}
        for oname, order in token_orders(eids, E, device).items():
            row[f"words_{oname}"] = compressed_dispatch_size(eids, E, order,
                                                             device)
        row["uncompressed_words"] = ((T + 31) // 32) * E
        out.append(row)
    return out


def validate(rows):
    checks = []
    for r in rows:
        ok = r["words_grayfreq"] < r["words_unsorted"]
        checks.append(
            f"{r['arch']}: Gray-Freq shrinks dispatch bitmaps "
            f"({r['words_grayfreq']} vs unsorted {r['words_unsorted']}): "
            f"{'PASS' if ok else 'FAIL'}")
        ok = r["words_grayfreq"] <= r["words_expert_sorted"]
        checks.append(
            f"{r['arch']}: Gray-Freq <= expert-sort "
            f"({r['words_grayfreq']} vs {r['words_expert_sorted']}): "
            f"{'PASS' if ok else 'FAIL'}")
    return checks
