"""Fitted per-encoding cost model over observed workload samples.

The model answers one question for compaction: *given what this column's
queries actually looked like, which encoding would have served them
cheapest?*  It combines

* an **analytic merge estimator** (:func:`estimate_merges`) — how many
  stream merges each candidate encoding would spend compiling the observed
  predicate shapes (mirrors each encoding's ``compile_*`` structure:
  equality/roaring pay O(width) fan-ins with the over-half-domain
  complement trick, bit-sliced pays the O(log card) comparison circuit,
  binned ~sqrt(card) bins); and
* a **fitted per-merge cost** (:class:`CostModel`) — a least-squares line
  ``us ≈ a + b·merges`` per encoding over the recorded ``(merges, us)``
  samples, falling back to a pooled fit (and, when the observed mix is
  degenerate — all samples at one merge count — to a through-origin rate)
  for encodings the workload hasn't exercised yet.

``make_compaction_chooser`` packages both into the ``encoding_chooser``
hook ``compact()`` threads down to ``Segment.seal`` — see
docs/containers.md and docs/lifecycle.md.
"""

from __future__ import annotations

import math

#: Candidate kinds the chooser ranks, in tie-break order (stable sort:
#: earlier wins on equal predicted cost).  ``bitsliced-gray`` is excluded
#: by default — it only differs from ``bitsliced`` in run compression, a
#: size effect this time-based model cannot see.
CANDIDATES = ("roaring", "equality", "bitsliced", "binned")


def estimate_merges(kind: str, shape: str, width: int, card: int,
                    k: int = 1) -> int:
    """Analytic merge count for compiling one predicate under ``kind``.

    ``shape`` is ``"eq"`` / ``"in"`` / ``"range"``, ``width`` the value
    count the predicate spans, ``card`` the column cardinality.  Estimates
    mirror the encodings' compile paths; exactness is not required — the
    fitted slope absorbs constant factors — but the *ordering* in width
    and cardinality must be right.
    """
    card = max(int(card), 2)
    width = max(min(int(width), card), 1)
    k = max(int(k), 1)
    if kind == "equality":
        if shape == "eq":
            return k - 1
        w = width if shape == "in" else min(width, card - width)
        extra = 1 if shape == "range" and 2 * width > card else 0
        return max(w * k - 1, 0) + extra
    if kind in ("bitsliced", "bitsliced-gray"):
        m = max(1, math.ceil(math.log2(card)))
        if shape == "eq":
            return 2 * m - 1       # plane ANDs + zero-bit complements
        if shape == "in":
            return width * 2 * m   # one comparison circuit per value
        return 2 * m               # the O(m) range circuit
    if kind == "binned":
        bins = max(2, min(64, int(round(2 * math.sqrt(card)))))
        if shape in ("eq", "in"):
            return width           # refinement leaf OR per value
        covered = min(width * bins // card + 2, bins)
        return max(covered - 1, 1)
    if kind == "roaring":
        if shape == "eq":
            return 0               # one container fold, no stream merges
        w = width if shape == "in" else min(width, card - width)
        extra = 1 if shape == "range" and 2 * width > card else 0
        return max(w - 1, 0) + extra
    raise ValueError(f"unknown encoding kind {kind!r}")


def _fit_line(points) -> tuple[float, float]:
    """Least squares ``us = a + b*merges`` with b clamped non-negative;
    degenerate inputs (single merge level) fall back to a through-origin
    rate so predicted cost still grows with merges."""
    n = len(points)
    mx = sum(p[0] for p in points) / n
    my = sum(p[1] for p in points) / n
    varx = sum((p[0] - mx) ** 2 for p in points)
    if varx > 0:
        b = sum((p[0] - mx) * (p[1] - my) for p in points) / varx
        if b > 0:
            return (max(my - b * mx, 0.0), b)
    # no usable slope — one merge level, or flat/inverted cost (batched
    # execution attributes uniform us per plan): charge the observed mean
    # cost per merge, so alternatives with fewer merges rank cheaper
    return (0.0, my / max(mx, 1.0))


class CostModel:
    """Per-encoding ``us ≈ a + b·merges`` lines fitted from samples."""

    def __init__(self, coef: dict, default: tuple[float, float]):
        self.coef = coef        # kind -> (a, b)
        self.default = default  # pooled fallback for unseen kinds

    @classmethod
    def fit(cls, samples, min_samples: int = 8) -> "CostModel":
        """``samples`` are WorkloadStats tuples ``(column, shape, width,
        encoding, merges, us)``; kinds with fewer than ``min_samples``
        fall back to the pooled line."""
        by_kind: dict = {}
        pooled = []
        for _col, _shape, _width, kind, merges, us in samples:
            pt = (float(merges), float(us))
            by_kind.setdefault(kind, []).append(pt)
            pooled.append(pt)
        if not pooled:
            raise ValueError("cannot fit a cost model from zero samples")
        default = _fit_line(pooled)
        coef = {kind: _fit_line(pts) for kind, pts in by_kind.items()
                if len(pts) >= min_samples}
        return cls(coef, default)

    def predict(self, kind: str, merges: float) -> float:
        a, b = self.coef.get(kind, self.default)
        return a + b * max(float(merges), 0.0)

    def rank(self, mix, card: int, k: int = 1,
             candidates=CANDIDATES) -> list:
        """Rank candidate encodings for one column against an observed
        predicate mix (``(shape, width, weight)`` triples); returns
        ``[(kind, predicted us), ...]`` cheapest first, ties broken by
        ``candidates`` order."""
        scored = []
        for kind in candidates:
            cost = sum(
                weight * self.predict(
                    kind, estimate_merges(kind, shape, width, card, k))
                for shape, width, weight in mix)
            scored.append((kind, cost))
        scored.sort(key=lambda t: t[1])
        return scored


def column_mixes(samples) -> dict:
    """Aggregate samples into per-column predicate mixes:
    ``{column: [(shape, mean width, count), ...]}``."""
    agg: dict = {}
    for col, shape, width, _kind, _merges, _us in samples:
        cell = agg.setdefault(int(col), {}).setdefault(
            shape, [0, 0])
        cell[0] += 1
        cell[1] += int(width)
    return {col: [(shape, max(ws // max(cnt, 1), 1), cnt)
                  for shape, (cnt, ws) in shapes.items()]
            for col, shapes in agg.items()}


def make_compaction_chooser(stats, min_samples: int = 32,
                            candidates=CANDIDATES):
    """Build the ``encoding_chooser(col, hist, k) -> kind | None`` hook
    compaction threads down to ``Segment.seal``.

    Returns None when ``stats`` holds fewer than ``min_samples`` samples
    — compaction then keeps the spec's static chooser.  The returned
    chooser answers None for columns the workload never touched (same
    static fallback, per column).
    """
    samples = stats.samples()
    if len(samples) < min_samples:
        return None
    model = CostModel.fit(samples)
    mixes = column_mixes(samples)

    def chooser(col, hist, k):
        mix = mixes.get(int(col))
        if not mix:
            return None
        return model.rank(mix, card=len(hist), k=k,
                          candidates=candidates)[0][0]

    return chooser
