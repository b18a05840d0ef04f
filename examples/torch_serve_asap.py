"""End-to-end ASAP serving demo on the PyTorch/CUDA port through the online
`ServingEngine` API (the twin of examples/serve_asap.py on repro_torch):
heterogeneous requests arrive with jitter on a replayable trace clock ->
length-aware batching in the admission loop -> disaggregated asynchronous
pipeline (real threads + shared-buffer primitives, one CUDA stream per
thread on the card) -> streaming OUT-OF-ORDER completions with per-request
TTFT decompositions, first tokens, and measured per-expert router
statistics.

  PYTHONPATH=src python examples/torch_serve_asap.py                # card
  PYTHONPATH=src python examples/torch_serve_asap.py --device cpu   # CPU

Params come from the port's own init under --seed.  The exit code is 0 only
if every request completed.
"""
import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import ExecutorEngine
from repro_torch.core.executor import DisaggregatedExecutor
from repro_torch.core.scheduler import LengthAwareBatcher
from repro_torch.core.trace import Request, TraceClock
from repro_torch.kernels import launch_counts
from repro_torch.models.lm import init_lm_params


def model_config():
    return get_config("qwen3-moe-235b-a22b").smoke().replace(
        num_layers=4, num_experts=8, top_k=2)


def requests():
    """A jittered stream of heterogeneous requests (the DP-imbalance
    trigger).  Arrivals are NOT all at t=0: the engine replays them on the
    trace clock, so late requests genuinely miss the first batching wave."""
    rng = np.random.RandomState(0)
    lengths = rng.choice([8, 12, 16, 24, 32, 48], size=10)
    arrivals = np.cumsum(rng.exponential(0.25, size=10))
    return [Request(rid=i, arrival=float(t), length=int(n))
            for i, (t, n) in enumerate(zip(arrivals, lengths))]


def serve(cfg, params, reqs, device, verbose: bool = True) -> dict:
    """One ServingEngine over the real pipeline (D=2 groups + E=4 MoE
    devices): submit timed requests, stream completions as they land."""
    ex = DisaggregatedExecutor(params, cfg, D=2, E=4, device=device)
    engine = ExecutorEngine(
        ex, clock=TraceClock(speed=25.0),  # 25 trace-seconds per wall second
        batcher=LengthAwareBatcher(inflection=48, max_tokens=96,
                                   exclusive_cutoff=1_000, max_wait=0.1))
    t0 = time.time()
    engine.submit_all(reqs)
    results = []
    try:
        while len(results) < len(reqs) and time.time() - t0 < 300:
            for r in engine.poll():  # completions stream OUT OF ORDER
                results.append(r)
                if verbose:
                    d = {k: round(v, 2) for k, v in r.decomposition.items()}
                    print(f"  done rid={r.rid} batch={r.batch_id} "
                          f"group={r.group} ttft={r.ttft:.2f}s "
                          f"first_token={r.first_token} {d}")
            time.sleep(0.02)
        results += engine.drain(timeout=120)
        wall = time.time() - t0
    finally:
        engine.close()
    return {"results": results, "wall": wall, "stats": engine.stats(),
            "router_stats": engine.router_stats}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = model_config()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.inference_mode():
        params = init_lm_params(gen, cfg, device)
    reqs = requests()
    print("request (arrival s, length):",
          [(round(r.arrival, 2), r.length) for r in reqs])
    out = serve(cfg, params, reqs, device)
    results = out["results"]
    print(f"engine completed {len(results)}/{len(reqs)} requests "
          f"in {out['wall']:.1f}s wall  [{device}]")

    # the async-serving property, visible at the REQUEST level: a late short
    # request can finish before an early long one
    order = [r.rid for r in results]
    inversions = sum(1 for a, b in zip(order, order[1:]) if b < a)
    print(f"completion order: {order} -> {inversions} out-of-order "
          f"completions")

    # measured router statistics, recorded from the live run
    st = out["stats"]
    fr = st.expert_fractions
    hot = [int(e) for e in out["router_stats"].hot_experts(3)]
    print(f"measured router stats: {st.router_assignments:.0f} assignments; "
          f"hottest experts {hot} with fractions "
          f"{[round(float(fr[e]), 3) for e in hot]} (sum {fr.sum():.3f})")
    print(f"MoE device util {np.round(st.moe_device_util, 2)}  "
          f"attention group util {np.round(st.group_util, 2)}")
    print("kernel launches: " + json.dumps(launch_counts()))
    return 0 if sorted(order) == [r.rid for r in reqs] else 1


if __name__ == "__main__":
    sys.exit(main())
