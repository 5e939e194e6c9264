"""The reader of ``encode_overflow_share``, on the CPU: the percent of
the answers the device encoder wrote whose stream splits a run, read
from the program's ``backend.encoded`` and ``backend.encoded_overflow``
counters."""

import pytest

from h100_bench.tests.helpers_h100bench import REPO
from h100_bench import harness


@pytest.fixture
def tracing():
    from repro_torch import tracing

    tracing.reset()   # pytest shares one process between runs
    yield tracing
    tracing.reset()


def test_encode_overflow_share_reads_the_encoder_counters(tracing):
    """The share of encoded answers whose stream splits a run; None where
    the encoder wrote nothing (a program without its counters, or a
    window with other counters only)."""
    read = harness.reader(REPO / "h100_bench", "encode_overflow_share")
    run = harness.Run(cell={}, config={}, mix={}, queries=8,
                      latencies_s=[0.5])
    prev = tracing.enable()
    try:
        tracing.add("backend.groups", 3)
        assert read(run) is None
        tracing.add("backend.encoded", 8)
        assert read(run) == 0.0
        tracing.add("backend.encoded_overflow", 6)
        assert read(run) == 75.0
    finally:
        tracing.enable(prev)
