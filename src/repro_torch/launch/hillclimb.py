"""Perf-iteration loop -- the reference's `repro.launch.hillclimb`: run
one dry-run cell (`launch.dryrun`, a fake process group of its own) with a
set of optimization knobs, report the three roofline terms, append the
record to a JSONL file.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch gemma3_1b \\
      --shape prefill_32k --opts attn_dp_constraint,inner_remat \\
      --label "H1+H2" [--breakdown]

The terms are priced at one H100 SXM's data-sheet rates (`dryrun`'s
PEAK_FLOPS / HBM_BW / LINK_BW).  `--out` defaults under `build/`.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                       measure_cell, parse_opts)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--opts", default="")
    ap.add_argument("--label", default="")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--out", default="build/perf_iterations.jsonl")
    args = ap.parse_args(argv)

    opts = parse_opts(args.opts)
    rec, hc = measure_cell(args.arch, args.shape, args.multi_pod, opts=opts,
                           breakdown=args.breakdown, top_k=8)
    rec["label"] = args.label or ",".join(opts) or "baseline"
    if rec.get("status") != "ok":
        print(json.dumps(rec)[:2000])
        raise SystemExit(1)
    brief = dict(label=rec["label"], arch=args.arch, shape=args.shape,
                 compute_s=round(rec["compute_s"], 3),
                 memory_s=round(rec["memory_s"], 3),
                 collective_s=round(rec["collective_s"], 3),
                 dominant=rec["dominant"],
                 useful=round(rec["useful_flops_ratio"], 4),
                 peak_hbm_gb=round(rec["mem"]["peak_hbm_gb"], 1),
                 compile_s=rec["compile_s"])
    print(json.dumps(brief))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")

    if args.breakdown:
        print("\n-- top dots (flops) --")
        for f_, d in hc.top_dots:
            print(f"{f_/PEAK_FLOPS:9.3f}s  {d[:120]}")
        print("-- top memory --")
        for b, d in hc.top_memory:
            print(f"{b/HBM_BW:9.3f}s  {d[:120]}")
        print("-- top collectives --")
        for b, d in hc.top_collectives:
            print(f"{b/LINK_BW:9.3f}s  {d[:120]}")


if __name__ == "__main__":
    main()
