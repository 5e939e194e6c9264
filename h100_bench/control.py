"""The control of the comparison that decides ``correct``, and the
program's own readings of the same numbers, over many seeds in one
process.

The control is the plain reference put in the program's place with one
guarantee of the configuration broken:

``approx``  answers at word granularity: every 32-row word that holds a
            selected row is answered whole (an approximate answer where it
            was exact); for both entries;
``blocks``  EWAH answers whose runs split at every 1,024-word block edge,
            as a block-parallel encoder without a merge pass would emit:
            the right rows in a stream that is not canonical; for the
            ``compressed`` entry.

``none`` runs the program itself.  The index (row order, bytes) is the
program's in every case: the control stands in for the query path.

    python3 h100_bench/control.py --workload dbgen-4d.tpch-stream \
        --control approx --seeds 11,12,13 --seconds 5
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CONTROLS = ("none", "approx", "blocks")


class ControlProgram:
    """The reference in the program's place (see the module's doc)."""

    def __init__(self, config: dict, entry: str, device: str, kind: str):
        from h100_bench.program import Program

        if kind == "blocks" and entry != "compressed":
            raise ValueError("the blocks control breaks the EWAH answers "
                             "of the compressed entry only")
        self.inner = Program(config, entry, device)
        self.ops = self.inner.ops
        self.entry = entry
        self.kind = kind

    def build(self, cols) -> float:
        secs = self.inner.build(cols)
        self.cols = [c[self.inner.row_perm] for c in cols]
        return secs

    def __getattr__(self, name):
        # n_rows, row_perm, index_words, plans, caches
        return getattr(self.inner, name)

    def launches(self):
        """None: the reference launches no kernel, so the mix's launch
        check does not apply."""
        return None

    def run_batch(self, preds, span=None, plans_out=None) -> list:
        from h100_bench.reference import evaluate, ewah

        out = []
        for p in preds:
            words = ewah.pack(evaluate.mask(p, self.cols))
            if self.kind == "approx":
                words = np.where(words != 0, np.uint32(ewah.FULL),
                                 np.uint32(0))
            if self.entry == "rows":
                out.append(ewah.rows_of(words, self.n_rows))
            elif self.kind == "blocks":
                out.append(ewah.encode_blocks(words))
            else:
                out.append(ewah.encode(words))
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", choices=CONTROLS, required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    from h100_bench import harness
    from h100_bench.control import ControlProgram

    def make(config, entry, device):
        return ControlProgram(config, entry, device, args.control)

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run(args.workload, seed, args.seconds, False, root=ROOT,
                        device=args.device,
                        make_program=None if args.control == "none"
                        else make)
        print(json.dumps({
            "workload": args.workload, "control": args.control,
            "seed": seed, "correct": r["correct"],
            "attempted": r["attempted"], "seconds": time.perf_counter() - t0,
            "checks": {k: v["value"] for k, v in r["checks"].items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
