"""Percent of the bytes copied to the device that are not leaf-stream
words (capacity padding and the lengths): the program's
``backend.h2d_bytes`` and ``backend.stream_bytes`` counters."""

from h100_bench.totals import counter


def read(run):
    h2d = counter("backend.h2d_bytes")
    if not h2d:
        return None
    return 100.0 * (h2d - counter("backend.stream_bytes")) / h2d
