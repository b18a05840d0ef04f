"""Sweeps that fix a cell's traffic parameters, run once on the chip; not
run by the cells.  The value chosen is written into the mix file by hand,
with the sweep's readings in PERF.md.

  python3 perfbench/sweep.py cap --workload deepseek_v32.isl2048_poisson \
      --values 4096,8192 --seconds 20 --seed 5
  python3 perfbench/sweep.py rate --workload deepseek_v32.isl2048_poisson \
      --values 2,4,6,8,10 --seconds 20 --seed 5 --trace 0

`cap` sets the batcher's cap (`batch_cap`) and reads, from one untraced and
one traced run at each value, prompt tokens/s, the device's idle share,
the batch size and the peak memory.  `rate` sets the Poisson rate
(`rate_rps`) and reads the TTFT median and 95th percentile, the rate of
completions, and whether the queue grows: the TTFT of the window's last
third of requests over its first third.
"""
import argparse
import gc
import dataclasses
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _one(plan, seed, seconds, trace):
    from perfbench import cell
    return cell.execute(plan, seed, seconds, trace, "cuda", time.monotonic(),
                        build_dir=ROOT / "build" / "perfbench")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("cap", "rate"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--values", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--trace", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import manifest
    base = manifest.plan(args.workload)
    manifest.prepare_env(base.traffic)
    import torch
    torch.set_num_threads(int(base.traffic["host_threads"]))
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 2
    key = {"cap": "batch_cap", "rate": "rate_rps"}[args.what]
    for v in [float(x) for x in args.values.split(",")]:
        val = int(v) if args.what == "cap" else v
        plan = dataclasses.replace(base, traffic={**base.traffic, key: val})
        res, checks, rec, extra = _one(plan, args.seed, args.seconds, False)
        line = {"sweep": args.what, key: val, "correct": res["correct"],
                "end_to_end": extra["end_to_end"],
                "attempted": res["attempted"], "failed": res["failed"],
                "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                "batch_tokens_mean": statistics.fmean(
                    sum(j["lengths"]) for j in rec.jobs) if rec.jobs
                else None}
        if args.what == "rate":
            ok = sorted((r for r in rec.results if r["status"] == "ok"),
                        key=lambda r: r["arrival"])
            ttft = [r["first_token_time"] - r["arrival"] for r in ok]
            third = max(len(ttft) // 3, 1)
            line.update(
                ttft_p50_s=statistics.median(ttft) if ttft else None,
                completed_per_s=len(ok) / args.seconds,
                offered=len(rec.results),
                growth=(statistics.fmean(ttft[-third:])
                        / statistics.fmean(ttft[:third])) if ttft else None)
        if args.trace:
            del res, rec
            gc.collect()
            torch.cuda.empty_cache()
            res, _, rec, _ = _one(plan, args.seed + 1, args.seconds, True)
            line["traced"] = res["metrics"]
            line["busy_s"] = res["device"].get("busy_s")
            line["window_s"] = res["device"].get("window_s")
        print(json.dumps(line), flush=True)
        del res, rec
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
