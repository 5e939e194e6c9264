"""CLI: ``python -m repro_torch.analysis [--baseline FILE]
[--update-baseline]``, the reference's ``repro.analysis`` CLI over the
port.

Exit 0 when no findings beyond the baseline; exit 1 otherwise, printing
each new finding as ``path:line: [rule] message``.
"""

from __future__ import annotations

import argparse
import sys

from . import (RULES, load_baseline, new_findings, render_findings,
               run_analysis, save_baseline)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro_torch invariant lint passes "
                    "(see docs/analysis.md)")
    ap.add_argument("--root", default=".",
                    help="repo root to analyze (default: cwd)")
    ap.add_argument("--baseline", default=None,
                    help="suppression baseline JSON; only findings beyond "
                         "it fail the run")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite --baseline from the current findings and "
                         "exit 0")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        width = max(len(r) for r in RULES)
        for rule, desc in sorted(RULES.items()):
            print(f"{rule:<{width}}  {desc}")
        return 0

    findings = run_analysis(args.root)

    if args.update_baseline:
        if not args.baseline:
            ap.error("--update-baseline requires --baseline")
        baseline = save_baseline(args.baseline, findings)
        print(f"wrote {args.baseline}: {sum(baseline.values())} "
              f"suppressed finding(s)")
        return 0

    baseline = load_baseline(args.baseline) if args.baseline else {}
    fresh = new_findings(findings, baseline)
    for line in render_findings(fresh):
        print(line)
    suppressed = len(findings) - len(fresh)
    if fresh:
        print(f"\n{len(fresh)} new finding(s)"
              + (f" ({suppressed} baselined)" if suppressed else ""),
              file=sys.stderr)
        return 1
    print(f"repro_torch.analysis: clean"
          + (f" ({suppressed} baselined finding(s))" if suppressed else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
