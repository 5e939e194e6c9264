"""Host ms a batch of the result-cache keying in
``execute_compressed_many`` (leaf digests, ``_node_key``, ``ResultCache.get``):
the program's ``backend.key`` span."""

from h100_bench.totals import span_ms


def read(run):
    return span_ms(run, "backend.key")
