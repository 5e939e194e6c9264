"""Finding records and the suppression-baseline protocol.

Every analyzer rule reports :class:`Finding` rows — file:line, a rule id
(``family/name``), a human message, and a ``detail`` string that survives
line drift (the baseline key deliberately excludes the line number, so a
refactor that shuffles a file does not resurrect suppressed findings).

The committed baseline (``analysis_torch_baseline.json`` for the
port, beside the reference's ``analysis_baseline.json``) maps baseline keys to
counts; CI fails only on findings *beyond* the baselined count per key
(see docs/analysis.md for the workflow).

A copy of the reference's ``src/repro/analysis/findings.py``.
"""

from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Finding:
    """One rule violation: where, which rule, what happened.

    ``detail`` is the stable identity used for baselining (defaults to the
    message); ``line`` is presentation only.
    """

    rule: str
    path: str
    line: int
    message: str
    detail: str = field(default="")

    def key(self) -> str:
        return f"{self.rule}|{self.path}|{self.detail or self.message}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def render_findings(findings) -> list[str]:
    """Stable presentation order: path, then line, then rule."""
    return [f.render() for f in
            sorted(findings, key=lambda f: (f.path, f.line, f.rule))]


def load_baseline(path) -> dict[str, int]:
    """Read a suppression baseline; missing file = empty baseline."""
    try:
        with open(path) as fh:
            raw = json.load(fh)
    except FileNotFoundError:
        return {}
    if not isinstance(raw, dict):
        raise ValueError(f"baseline {path}: expected a JSON object")
    return {str(k): int(v) for k, v in raw.items()}


def save_baseline(path, findings) -> dict[str, int]:
    """Write the current findings as the new baseline (sorted, stable)."""
    counts = Counter(f.key() for f in findings)
    baseline = dict(sorted(counts.items()))
    with open(path, "w") as fh:
        json.dump(baseline, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return baseline


def new_findings(findings, baseline: dict[str, int]) -> list:
    """Findings beyond the baselined count for their key (CI fails on
    these; baselined repeats stay suppressed)."""
    budget = Counter(baseline)
    fresh = []
    for f in findings:
        if budget[f.key()] > 0:
            budget[f.key()] -= 1
        else:
            fresh.append(f)
    return fresh
