"""Deterministic synthetic LM token pipeline.

Shardable (each data-parallel host reads its own offset range), resumable
(the stream position is a pure function of (seed, step), saved with the
checkpoint), and metadata-aware: every sequence carries categorical
metadata (source, domain, quality bin, length bin) which the EWAH bitmap
index in data/metadata_index.py indexes — the paper's use case embedded in
the training data plane.

A numpy-only copy of the reference's ``src/repro/data/tokens.py``: the
same seed and step give byte-identical batches and metadata.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["TokenPipeline", "TokenPipelineState"]


@dataclass
class TokenPipelineState:
    seed: int
    step: int
    host_id: int
    n_hosts: int


class TokenPipeline:
    """Markov-ish synthetic tokens with enough structure for loss to drop."""

    N_SOURCES = 8
    N_DOMAINS = 32
    N_QBINS = 10
    N_LBINS = 8

    def __init__(self, vocab_size: int, batch: int, seq: int, seed: int = 0,
                 host_id: int = 0, n_hosts: int = 1):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq
        self.state = TokenPipelineState(seed, 0, host_id, n_hosts)
        r = np.random.default_rng(seed)
        # fixed bigram structure so the LM has something learnable
        self._next = r.integers(0, vocab_size, size=(min(vocab_size, 4096),))

    def _rng_for(self, step):
        s = self.state
        return np.random.default_rng(
            (s.seed * 1_000_003 + step) * 64 + s.host_id)

    def next_batch(self):
        step = self.state.step
        r = self._rng_for(step)
        b, s, v = self.batch, self.seq, self.vocab
        start = r.integers(0, min(v, 4096), size=(b, 1))
        noise = r.integers(0, v, size=(b, s))
        take_chain = r.random((b, s)) < 0.7
        toks = np.empty((b, s), dtype=np.int32)
        cur = start[:, 0]
        for t in range(s):  # cheap python chain; CPU-scale batches only
            cur = np.where(take_chain[:, t],
                           self._next[cur % len(self._next)], noise[:, t])
            toks[:, t] = cur
        labels = np.roll(toks, -1, axis=1)
        meta = {
            "source": r.integers(0, self.N_SOURCES, size=b),
            "domain": r.integers(0, self.N_DOMAINS, size=b),
            "quality_bin": r.integers(0, self.N_QBINS, size=b),
            "length_bin": r.integers(0, self.N_LBINS, size=b),
        }
        self.state.step += 1
        return {"inputs": toks, "labels": labels}, meta

    # --- fault tolerance ---------------------------------------------------

    def snapshot(self) -> dict:
        return {"seed": self.state.seed, "step": self.state.step,
                "host_id": self.state.host_id, "n_hosts": self.state.n_hosts}

    def restore(self, snap: dict):
        self.state = TokenPipelineState(**snap)
