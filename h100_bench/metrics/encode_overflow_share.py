"""Percent of the answers the device encoder wrote whose stream splits a
clean run at ``MAX_CLEAN`` or a dirty run at ``MAX_DIRTY``: the
program's ``backend.encoded_overflow`` over ``backend.encoded``
counters.  None where the program's encoder wrote no answer, or where it
has no such counters."""

from h100_bench.totals import counter


def read(run):
    encoded = counter("backend.encoded")
    if not encoded:
        return None
    return 100.0 * counter("backend.encoded_overflow") / encoded
