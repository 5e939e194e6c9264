"""``correct`` on the CPU at a small size: true for the program, false for
the control (the reference with a guarantee broken) and for the program
with its timed path broken underneath."""

import numpy as np
import pytest

from h100_bench.tests.helpers_h100bench import run_small, small_root
from h100_bench.control import ControlProgram
from h100_bench.program import Program

STREAM, ROWIDS = "dbgen-4d.tpch-stream", "dbgen-4d.tpch-stream-rowids"
CELLS = (STREAM, ROWIDS)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def wide_root(tmp_path_factory):
    """Bitmaps of 1,251 words: wider than the blocks control's block."""
    return small_root(tmp_path_factory.mktemp("wide"), rows=40_003)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(root, cell):
    r = run_small(root, cell)
    assert r["correct"], (r["checks"], r.get("failures"))
    assert r["checks"]["checked"]["value"] >= 1
    assert "failures" not in r


@pytest.mark.parametrize("cell, kind, number", [
    (STREAM, "approx", "wrong"),
    (STREAM, "blocks", "noncanonical"),
    (ROWIDS, "approx", "wrong"),
])
def test_control_is_not_correct(wide_root, root, cell, kind, number):
    r = run_small(wide_root if kind == "blocks" else root, cell,
                  make_program=lambda c, e, d: ControlProgram(c, e, d, kind))
    assert not r["correct"]
    assert r["checks"][number]["value"] > 0
    assert r["failures"][0].startswith(number + ":")


class HalfLeftOut(Program):
    """Answers only the first half of each batch."""

    def run_batch(self, preds, span=None, plans_out=None):
        out = super().run_batch(preds, span, plans_out)
        return out[: len(out) // 2]


class AnswerAltered(Program):
    """Flips the last bit of every answer where it is produced: a verbatim
    word of an EWAH answer, or the last row id."""

    def run_batch(self, preds, span=None, plans_out=None):
        out = []
        for a in super().run_batch(preds, span, plans_out):
            a = np.array(a, copy=True)
            if len(a):
                a[-1] ^= 1
            out.append(a)
        return out


class RowPastTheEnd(Program):
    """Row-id answers that name one row past the table's last."""

    def run_batch(self, preds, span=None, plans_out=None):
        return [np.append(a, self.n_rows)
                for a in super().run_batch(preds, span, plans_out)]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault, number", [(HalfLeftOut, "missing"),
                                           (AnswerAltered, "wrong")])
def test_broken_program_is_not_correct(root, cell, fault, number):
    r = run_small(root, cell, make_program=fault)
    assert not r["correct"]
    assert r["checks"][number]["value"] > 0
    if fault is HalfLeftOut:
        assert r["failed"] > 0


def test_a_row_past_the_end_is_wrong(root):
    r = run_small(root, ROWIDS, make_program=RowPastTheEnd)
    assert not r["correct"] and r["checks"]["wrong"]["value"] > 0
