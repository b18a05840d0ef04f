"""Serving launcher: drives the ASAP prefill pipeline end to end through the
online `ServingEngine` API (core/engine.py) -- timed request arrivals,
streaming out-of-order completions, measured router statistics -- over the
REAL disaggregated threaded runtime (attention group threads + MoE device
threads + shared-buffer async primitives, one CUDA stream per thread).

Requests arrive on a replayable TraceClock at --rps (Poisson), flow through
the length-aware batcher into the shared admission queue, and whichever
attention group frees a dual-batch slot first pulls the batch.  Each
completion prints as it lands: TTFT with its queue/kernel/comm decomposition
and the sampled first token.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

On the card the model is qwen3_moe_235b_a22b at its full width in bf16 with
random weights from --seed, its depth cut to --layers (default 4; the full
depth does not fit one card).  --smoke selects the small fp32 config instead;
with --device cpu the kernels' plain PyTorch versions run.  The exit code is
0 only if every request has a result.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.cost_model import Placement
from repro_torch.core.engine import ExecutorEngine, RequestResult
from repro_torch.core.executor import DisaggregatedExecutor
from repro_torch.core.scheduler import LengthAwareBatcher
from repro_torch.core.trace import (Request, TraceClock, TraceConfig,
                                    sample_lengths)
from repro_torch.models.common import ModelConfig
from repro_torch.models.lm import init_lm_params

ARCH = "qwen3_moe_235b_a22b"


def _fmt_decomp(d):
    return " ".join(f"{k}={v * 1000:.0f}ms" for k, v in d.items())


def _print_result(r: RequestResult):
    print(f"  done rid={r.rid:<3d} batch={r.batch_id} "
          f"group={r.group} ttft={r.ttft:.3f}s "
          f"first_token={r.first_token} status={r.status}"
          f"  [{_fmt_decomp(r.decomposition)}]")


def serve_requests(cfg: ModelConfig, params, *, lengths: Sequence[int],
                   rps: float, time_scale: float = 1.0, seed: int = 0,
                   device="cuda", D: int = 2, E: int = 4,
                   placement: Optional[Placement] = None,
                   idle_backoff: Optional[float] = 0.05,
                   max_batch_tokens: int = 4096, verbose: bool = False,
                   executor: Optional[DisaggregatedExecutor] = None
                   ) -> dict:
    """Serve `len(lengths)` requests with Poisson arrivals at `rps` through
    `ExecutorEngine` over `DisaggregatedExecutor(D, E)`.  Returns the
    results, the engine stats and the executor's launch telemetry.

    `executor` hands in a long-lived executor from an earlier wave (its
    streams, and with them the allocator's pools, stay warm); its stats are
    reset, and it is returned under "executor" for the next wave."""
    rng = np.random.default_rng(seed + 1)
    n = len(lengths)
    arrivals = np.cumsum(rng.exponential(1.0 / max(rps, 1e-9), size=n))
    reqs = [Request(rid=i, arrival=float(arrivals[i]), length=int(lengths[i]))
            for i in range(n)]
    ex = executor
    if ex is None:
        ex = DisaggregatedExecutor(params, cfg, D=D, E=E,
                                   placement=placement,
                                   idle_backoff=idle_backoff, device=device)
        # the kernel library is built and the capacity buckets up to half a
        # full batch per expert are touched once before the clock starts
        ex.prewarm_buckets(max(max_batch_tokens // 2, 1))
    else:
        ex.reset_stats()
    engine = ExecutorEngine(
        ex, clock=TraceClock(speed=time_scale),
        batcher=LengthAwareBatcher(inflection=max(max_batch_tokens // 2, 1),
                                   max_tokens=max_batch_tokens,
                                   exclusive_cutoff=1 << 30, max_wait=0.05),
        token_seed=seed)
    t0 = time.time()
    handles = engine.submit_all(reqs)
    results: List[RequestResult] = []
    while len(results) < n and time.time() - t0 < 600:
        for r in engine.poll():
            results.append(r)
            if verbose:
                _print_result(r)
        time.sleep(0.01)
    for r in engine.drain(timeout=120):
        results.append(r)
        if verbose:
            _print_result(r)
    wall = time.time() - t0
    st = engine.stats()
    router_stats = engine.router_stats
    engine.close()
    with ex._log_lock:
        log = list(ex.log)
    return {
        "results": results, "handles": handles, "wall": wall, "stats": st,
        "router_stats": router_stats, "arrivals": arrivals, "executor": ex,
        "batch_layers": sum(1 for ev in log if ev[0] == "combine"),
        # (B, S) of every attention step; (n_e, C) and the per-expert row
        # counts of every FFN launch
        "shapes": [ev[4] for ev in log if ev[0] == "attn"],
        "buckets": [(ev[2], ev[3]) for ev in log if ev[0] == "launch"],
        "counts": [ev[4] for ev in log if ev[0] == "launch"],
    }


def run_executor(args) -> int:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("ERROR: --device cuda but no CUDA device is available (pass "
              "--device cpu --smoke for the CPU check)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 stays fp32
    if args.smoke:
        cfg = get_config(ARCH).smoke().replace(
            num_layers=args.layers if args.layers is not None else 3,
            num_experts=8, top_k=2)
        trace = TraceConfig(mean_len=48, max_len=64, seed=args.seed)
        lo, hi, max_tokens = 8, 64, 128
    else:
        cfg = get_config(ARCH).replace(
            num_layers=args.layers if args.layers is not None else 4)
        trace = TraceConfig(mean_len=1024, max_len=2048, seed=args.seed)
        lo, hi, max_tokens = 64, 2048, 4096
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.inference_mode():
        params = init_lm_params(gen, cfg, device)
    D = args.dp_groups if args.dp_groups is not None else 2
    E = args.moe_devices if args.moe_devices is not None else 4
    placement = Placement.parse(args.placement,
                                replicate_hot=args.replicate_hot)
    print(f"disaggregated executor engine on {device}: D={D} attention "
          f"groups, E={E} MoE devices, {cfg.name} {cfg.num_layers}L x "
          f"{cfg.num_experts}e d_model={cfg.d_model} "
          f"{str(cfg.dtype).replace('torch.', '')}  "
          f"[placement={placement.policy}"
          + (f"(hot={placement.replicate_hot})" if placement.replicate_hot
             else "") + f" time-scale={args.time_scale}x]")
    lengths = np.clip(sample_lengths(args.requests, trace), lo, hi)
    print(f"{args.requests} requests, Poisson arrivals at {args.rps} req/s, "
          f"lengths {[int(x) for x in lengths]}")

    out = serve_requests(cfg, params, lengths=[int(x) for x in lengths],
                         rps=args.rps, time_scale=args.time_scale,
                         seed=args.seed, device=device, D=D, E=E,
                         placement=placement, idle_backoff=args.idle_backoff,
                         max_batch_tokens=max_tokens, verbose=True)
    results, st = out["results"], out["stats"]

    # out-of-order completion evidence (the async-serving property)
    order = [r.rid for r in results]
    ooo = sum(1 for a, b in zip(order, order[1:]) if b < a)
    print(f"completed {len(results)}/{args.requests} requests in "
          f"{out['wall']:.1f}s wall ({st.elapsed:.1f}s trace); out-of-order "
          f"completions: {ooo}")
    u = st.moe_device_util
    print(f"MoE device util: mean {u.mean() * 100:.0f}%  max "
          f"{u.max() * 100:.0f}%  imbalance {st.moe_imbalance():.2f}x; "
          f"attention group util: {np.round(st.group_util, 2)}")
    if st.moe_launches:
        print(f"super-kernel launches: {st.moe_launches} "
              f"({st.regions_per_launch():.2f} regions/launch, occupancy "
              f"{st.moe_batch_occupancy * 100:.0f}%, capacity buckets "
              f"{st.bucket_hits} hit / {st.bucket_misses} new)")
    fr = st.expert_fractions
    hot = [int(e) for e in out["router_stats"].hot_experts(3)]
    print(f"measured router stats: {st.router_assignments:.0f} assignments, "
          f"fractions sum {fr.sum():.3f}, hottest experts {hot} "
          f"({', '.join(f'{fr[e]:.3f}' for e in hot)})")
    if st.statuses:
        print("request statuses: "
              + " ".join(f"{k}={v}" for k, v in sorted(st.statuses.items())))
    if args.save_router_stats:
        out["router_stats"].save(args.save_router_stats)
        print(f"router stats saved to {args.save_router_stats}")
    if args.save_stats:
        with open(args.save_stats, "w") as f:
            json.dump({
                "engine": st.engine, "device": str(device),
                "elapsed": st.elapsed,
                "submitted": st.submitted, "completed": st.completed,
                "placement_policy": st.placement_policy,
                "moe_device_util": [float(x) for x in st.moe_device_util],
                "group_util": [float(x) for x in st.group_util],
                "expert_fractions": [float(x) for x in st.expert_fractions],
                "router_assignments": st.router_assignments,
                "mean_ttft": float(np.mean([r.ttft for r in results]))
                if results else None,
                "statuses": st.statuses,
                "moe_launches": st.moe_launches,
                "moe_batch_regions": st.moe_batch_regions,
                "regions_per_launch": st.regions_per_launch(),
                "moe_batch_occupancy": st.moe_batch_occupancy,
                "bucket_hits": st.bucket_hits,
                "bucket_misses": st.bucket_misses,
            }, f, indent=2)
        print(f"engine stats saved to {args.save_stats}")

    missing = [h.rid for h in out["handles"] if not h.done()]
    if missing:  # smoke gate: per-request results must all exist
        print(f"ERROR: missing results for rids {missing}", file=sys.stderr)
        return 1
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Serve prefill requests through the disaggregated "
                    "executor (PyTorch/CUDA port).")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rps", type=float, default=4.0,
                    help="Poisson arrival rate of the timed admission")
    ap.add_argument("--dp-groups", type=int, default=None,
                    help="attention DP groups D (default 2)")
    ap.add_argument("--moe-devices", type=int, default=None,
                    help="MoE expert devices E (default 4)")
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="trace seconds replayed per wall second (TraceClock "
                         "speed); raise it on a slow CPU")
    ap.add_argument("--placement", default="round_robin",
                    help="expert placement policy: round_robin | "
                         "greedy_balanced | replicated | replicated(k)")
    ap.add_argument("--replicate-hot", type=int, default=0,
                    help="replicate the k hottest experts across the least-"
                         "loaded MoE devices (implies --placement replicated)")
    ap.add_argument("--idle-backoff", type=float, default=0.05,
                    help="max seconds a MoE worker waits on its condition "
                         "variable before re-checking the stop flag")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-stats", default=None, metavar="PATH",
                    help="write EngineStats as JSON after the run")
    ap.add_argument("--save-router-stats", default=None, metavar="PATH",
                    help="write measured per-expert routing stats (JSON)")
    ap.add_argument("--smoke", action="store_true",
                    help="the small fp32 config (3 layers, 8 experts top-2) "
                         "instead of the full-width model")
    ap.add_argument("--layers", type=int, default=None,
                    help="model depth (default 4 at full width, 3 with "
                         "--smoke)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions (use with --smoke)")
    args = ap.parse_args(argv)
    if args.requests < 1:
        ap.error("--requests must be >= 1")
    if args.layers is not None and args.layers < 1:
        ap.error("--layers must be >= 1")
    return run_executor(args)


if __name__ == "__main__":
    sys.exit(main())
