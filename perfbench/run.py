"""Run one cell of the benchmark once and print its result line.

  python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

The cell, its configuration, its traffic mix, its per-layer metrics and its
correctness limits are found by name from `BENCHMARK.json` (see
`perfbench/manifest.py`).  The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer ones), `device`, with `--trace 1`
`breakdown`, and last `checks`, each number compared with its limit; the
same numbers end standard error.  It needs a CUDA card: without one, or
with fewer than the cell asks for, it prints no result and exits 2.
"""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "perfbench"


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # a run that hangs prints every thread's stack and ends inside the
    # limit of a first run, which builds the kernel library
    faulthandler.dump_traceback_later(1150, exit=True)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import manifest
    plan = manifest.plan(args.workload)
    manifest.prepare_env(plan.traffic)
    import torch
    torch.set_num_threads(int(plan.traffic["host_threads"]))
    from perfbench import cell
    import repro_torch  # noqa: F401  (the program must be there)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(plan.cell["chips"]):
        print(f"error: {args.workload} needs {plan.cell['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks, rec, extra = cell.execute(
        plan, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS,
        build_dir=BUILD)
    loaded = extra["loaded"]
    if loaded:
        print(f"error: the run loaded {loaded} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    result["device"]["power"] = _power_limit()
    classes = rec.trace["classes"] if rec.trace else None
    print(f"window {rec.window_s:.3f} s: {len(rec.jobs)} jobs, "
          f"{len(rec.results)} requests, {len(rec.log)} log events, "
          f"{rec.host_syncs} host syncs; trace classes (s, events seen): "
          f"{classes}", file=sys.stderr)
    result["checks"] = checks
    print(f"readings: {json.dumps(extra.get('values'))}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
