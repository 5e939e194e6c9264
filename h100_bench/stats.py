"""Small statistics the metric readers share."""

from __future__ import annotations

import numpy as np


def p95_ms(latencies_s):
    """95th percentile (linear between order statistics) in ms."""
    if not latencies_s:
        return None
    return float(np.percentile(np.asarray(latencies_s) * 1e3, 95))


def per_batch_host_s(run):
    """Each traced batch's wall time less its device-busy time."""
    t = run.trace
    if t is None or not t.batch_busy_s or len(t.batch_busy_s) != len(
            run.latencies_s):
        return None
    return [w - b for w, b in zip(run.latencies_s, t.batch_busy_s)]
