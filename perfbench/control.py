"""The control's and the program's compared numbers on the chip, at a cell's
own size: not run by the cells.

  python3 perfbench/control.py --workload <cell> --seeds 11,12,13 \
      [--seconds 8] [--out chiprun_out/control.jsonl]

For each seed, in one process: a run of the cell with a short window (its
own load and sizes), the program's numbers on the window's sampled
requests, and on the same prompts the control's: the reference in float8
in the program's place.  One JSON line a seed.  The limits in
`perfbench/limits/<cell>.json` are set between the program's largest
reading and the control's smallest.
"""
import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import manifest
    plan = manifest.plan(args.workload)
    manifest.prepare_env(plan.traffic)
    import torch
    torch.set_num_threads(int(plan.traffic["host_threads"]))
    from perfbench import cell
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        result, checks, _, extra = cell.execute(
            plan, seed, args.seconds, False, "cuda", time.monotonic(),
            build_dir=ROOT / "build" / "perfbench", control=True)
        line = {"workload": args.workload, "seed": seed,
                "correct": result["correct"],
                "program": extra.get("values"),
                "control": extra.get("control"),
                "end_to_end": extra["end_to_end"],
                "memory_peak_bytes": result["device"]["memory_peak_bytes"]}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
