"""CLI: `python -m repro_torch.analysis [paths...] [--json out.json]
[--order] [--strict-suppressions]`.

Runs the lock-discipline, host-sync, launch-contract and dtype-policy
passes over the given files or directories (default:
src/repro_torch/core) and exits 1 if any unsuppressed finding remains.
Suppressed findings (race-ok / sync-ok / kernel-ok / shard-ok) are listed
so their justifications stay auditable; `--order` also prints the static
lock-order graph; `--strict-suppressions` additionally fails on
suppression comments that no longer match any finding.  No nvcc and no
card are needed.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="asaplint for the port: concurrency, host-sync, "
                    "launch-contract and dtype-policy analysis")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch/core"],
                    help="files or directories to analyze "
                         "(default: src/repro_torch/core)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the full findings report (incl. suppressed "
                         "findings and the lock-order graph) as JSON")
    ap.add_argument("--order", action="store_true",
                    help="print the static lock-order graph")
    ap.add_argument("--strict-suppressions", action="store_true",
                    help="also fail on suppression comments that no longer "
                         "match any finding")
    args = ap.parse_args(argv)

    from repro_torch.analysis import run_static
    res = run_static(args.paths,
                     strict_suppressions=args.strict_suppressions)

    for f in res.unsuppressed:
        print(f.format())
    if res.suppressed:
        print(f"-- {len(res.suppressed)} suppressed finding(s):")
        for f in res.suppressed:
            print("   " + f.format())
    if args.order:
        print("-- static lock-order graph:")
        for (a, b), wit in sorted(res.lock_edges.items()):
            print(f"   {a} -> {b}   ({wit[0]})")

    if args.json:
        res.save_json(args.json)
        print(f"-- report written to {args.json}")

    n = len(res.unsuppressed)
    print(f"asaplint: {len(res.files)} file(s), "
          f"{len(res.findings)} finding(s), {n} unsuppressed")
    return 1 if n else 0


if __name__ == "__main__":
    sys.exit(main())
