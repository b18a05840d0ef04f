"""DP-imbalance demonstration (the paper's motivating experiment, §2.3) on
the PyTorch/CUDA port's analytic half (the twin of
examples/imbalance_demo.py on repro_torch): the same heterogeneous trace
through the synchronous engine vs ASAP, with the straggler stalls made
explicit.

  PYTHONPATH=src python examples/torch_imbalance_demo.py               # card
  PYTHONPATH=src python examples/torch_imbalance_demo.py --device cpu  # CPU

Every number is the port's copy of the reference's cost model and simulator
on the reference's TPU v5e preset (`cost_model.V5E`): model outputs, the
same on any device, not measurements on this card.  The simulator has no
path on another hardware preset yet.  --device and --seed are taken for a
uniform command line; the trace's seed is the reference's.
"""
import argparse
import sys

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.cost_model import V5E, CostModel, Deployment
from repro_torch.core.simulator import SimConfig, run_sim
from repro_torch.core.trace import TraceConfig

ANALYTIC = ("[analytic: the reference's TPU v5e preset, not measured on this "
            "card]")


def lines():
    """The demo's printed chunks, as the reference prints them."""
    cfg = get_config("deepseek_v32")
    # --- the Σs² effect: equal token budgets, very different latencies
    cm = CostModel(cfg, hw=V5E, dep=Deployment(D=4, T=4, E=16))
    yield "attention latency for a 32k-token budget (one DP group):"
    for mix in ([32768], [8192] * 4, [1024] * 32):
        lat = cm.attention_layer_latency(mix) * 1e3
        yield f"  {len(mix):>2} x {mix[0]:>5} tokens : {lat:7.2f} ms/layer"
    yield ("-> balancing DP groups by Σ tokens cannot equalize latency "
           "(Σ s²)\n")

    # --- full serving comparison on a heavy-tailed trace
    trace = TraceConfig(mean_len=5000, sigma=1.5, seed=7)
    for rps in (2.0, 4.0, 6.0):
        row = {}
        for mode in ("default", "chunked", "asap"):
            res = run_sim(cfg, SimConfig(mode=mode, rps=rps, duration=40.0,
                                         trace=trace))
            row[mode] = res.mean_ttft
        yield (f"RPS={rps}: TTFT default={row['default']:.2f}s "
               f"chunked={row['chunked']:.2f}s asap={row['asap']:.2f}s "
               f"(asap {row['default']/max(row['asap'],1e-9):.1f}x faster "
               f"than default)")

    # --- where the time goes for short requests under the sync engine
    res = run_sim(cfg, SimConfig(mode="default", rps=4.0, duration=40.0,
                                 trace=trace))
    short = [res.decomposition[r.rid] for r in res.requests
             if r.length < 1024 and r.rid in res.decomposition]
    k = np.mean([d["kernel"] for d in short])
    s = np.mean([d["sync_wait"] for d in short])
    q = np.mean([d["queuing"] for d in short])
    tot = k + s + q
    yield (f"\nshort (<1k) requests under Default: kernel {k/tot*100:.0f}%, "
           f"sync-wait {s/tot*100:.0f}%, queuing {q/tot*100:.0f}% "
           f"(paper Fig 15: sync 55% + queue 30%)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.parse_args(argv)
    for chunk in lines():
        for line in chunk.split("\n"):
            print(line + ("  " + ANALYTIC if line.strip() else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
