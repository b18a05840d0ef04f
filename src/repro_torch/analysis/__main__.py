"""CLI: `python -m repro_torch.analysis [paths...] [--json out.json]
[--order] [--strict-suppressions] [--contracts | --update-contracts]`.

Runs the lock-discipline, host-sync, launch-contract and sharding /
dtype-policy passes over the given files or directories (default:
src/repro_torch/core) and exits 1 if any unsuppressed finding remains.
Suppressed findings (race-ok / sync-ok / kernel-ok / shard-ok) are listed
so their justifications stay auditable; `--order` also prints the static
lock-order graph; `--strict-suppressions` additionally fails on
suppression comments that no longer match any finding.  No nvcc and no
card are needed.

Contract mode (`--contracts` / `--update-contracts`) builds the pinned
cost-contract cells' steps on a fake 2x4 mesh and diffs (or re-baselines)
their dot-FLOPs / collective-bytes / memory-bytes against the golden JSON
under analysis/contracts_golden/ (`analysis.contracts`).  It joins a fake
process group, so it runs in this process alone.
"""
from __future__ import annotations

import argparse
import json
import sys


def _run_contracts(args) -> int:
    from repro_torch.analysis.contracts import run_contracts
    ok, report = run_contracts(update=args.update_contracts)
    for entry in report["contracts"]:
        line = f"contract {entry['name']} ({entry['arch']}/{entry['kind']}):" \
               f" {entry['status']}"
        for v in entry.get("violations", []):
            line += (f"\n    {v['metric']} {v['why']}: golden={v['golden']:.6g}"
                     f" measured={v['measured']:.6g} rel={v['rel']:+.2%}")
        if entry["status"] == "missing-golden":
            line += f"\n    {entry['why']}"
        print(line)
    if args.contracts_json:
        with open(args.contracts_json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"-- contract report written to {args.contracts_json}")
    print(f"cost-contracts: {len(report['contracts'])} cell(s), "
          f"{'ok' if ok else 'FAIL'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="asaplint for the port: concurrency, host-sync, "
                    "launch-contract, sharding and dtype-policy analysis")
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
    ap.add_argument("--contracts", action="store_true",
                    help="verify the cost contracts instead of running the "
                         "static passes")
    ap.add_argument("--update-contracts", action="store_true",
                    help="re-baseline the cost-contract goldens")
    ap.add_argument("--contracts-json", metavar="PATH", default=None,
                    help="write the contract diff report as JSON")
    args = ap.parse_args(argv)

    if args.contracts or args.update_contracts:
        return _run_contracts(args)

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
