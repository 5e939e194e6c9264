"""Run one cell of the port's H100 benchmark and print its result line.

    python3 h100_bench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

Run from the root of a checkout.  Without a CUDA card, or with fewer
cards than the cell asks for, or where the program cannot be imported, it
exits with a code other than 0 and prints no result.  The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: each number compared beside its limit; ``batches`` summarises
the window's batch times and host spans, and ``failures`` names the first
answers that failed); the checks are also the last lines of standard
error.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {c["name"]: c["chips"] for c in bench["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3

    from h100_bench import harness

    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), root=ROOT, t_process=T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} {c['rule']} {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
