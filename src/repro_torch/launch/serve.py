"""Serving launcher: drives the ASAP prefill pipeline end to end through the
online `ServingEngine` API (core/engine.py) -- timed request arrivals,
streaming out-of-order completions, measured router statistics -- over
either runtime:

  --engine executor : the REAL disaggregated threaded runtime (attention
                      group threads + MoE device threads + shared-buffer
                      async primitives, one CUDA stream per thread).
  --engine sim      : the same lifecycle over the discrete-event simulator
                      at production scale (virtual time, host code only):
                      deepseek_v32 on D=4 attention groups x T=4 and E=16
                      MoE devices by default, Poisson arrivals at --rps for
                      --duration seconds, `--mode asap|default|chunked`
                      (ASAP or the synchronous baselines), routing skew
                      --ep-skew / --ep-skew-mode or --measured-from (router
                      stats JSON saved by --save-router-stats, of either
                      package).  The simulator prices the reference's
                      hardware preset: its times are model outputs.

  PYTHONPATH=src python -m repro_torch.launch.serve --engine sim --rps 2 \
      --duration 20 --ep-skew 1.2 --replicate-hot 2 --rebalance-interval 5

Requests arrive on a replayable TraceClock at --rps (Poisson), flow through
the length-aware batcher into the shared admission queue, and whichever
attention group frees a dual-batch slot first pulls the batch.  Each
completion prints as it lands: TTFT with its queue/kernel/comm decomposition
and the sampled first token.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

`--save-spans PATH` records the serving path's spans (`core/spans.py`: per
request, job, batch-layer and MoE drain, with their ids) and writes them as
Chrome-trace JSON, to open beside a `torch.profiler` trace of the same run.

On the card the model is qwen3_moe_235b_a22b at its full width in bf16 with
random weights from --seed, its depth cut to --layers (default 4; the full
depth does not fit one card).  --smoke selects the small fp32 config instead;
with --device cpu the kernels' plain PyTorch versions run.  The exit code is
0 only if every request has a result.

Prefill/decode disaggregation: `--mode pd` runs the whole request lifecycle.
The prefill executor (built with `emit_kv`) keeps each prompt's KV on the
device; the `PDOrchestrator` hands it to a `DecodeExecutor` (a copy into the
request's cache slot), which generates the remaining tokens in continuous
batches through the capacity-mode MoE layer (the dispatch/combine kernels);
every completion line carries tokens_out and TPOT.  Knobs: --out-len-mean /
--out-len-cv (sampled decode lengths, deterministic per rid),
--decode-width (decode cache slots), --colocated (baseline: no KV transfer
cost, no handoffs logged).  The run FAILS unless every request reaches a
definite status, ok requests produced exactly out_len tokens, and
(disaggregated) at least one KV handoff happened.

The MoE stage: `--moe-batch-window W` (wall seconds) makes every MoE worker
a continuous batcher that merges the regions of many attention groups into
one Super Kernel launch per layer (`--moe-batch-max-tokens` caps the merged
rows); 0, the default, serves one region per launch.  `--moe-path eager` runs
the pre-fusion baseline (dense attention, per-expert matmuls, host
round trips; prefill serving only).

  PYTHONPATH=src python -m repro_torch.launch.serve --moe-batch-window 0.002 \
      --moe-batch-max-tokens 4096

`--tuning-table PATH` (executor and `--mode pd`) installs a Super Kernel
tile table written by `python -m repro_torch.launch.tune_superkernel`:
every launch whose geometry and capacity bucket it names runs that (BM, BN)
tile, the same bits as the default tile.
  PYTHONPATH=src python -m repro_torch.launch.serve --mode pd
  PYTHONPATH=src python -m repro_torch.launch.serve --mode pd --smoke \
      --device cpu --time-scale 20

Faults and the request lifecycle (prefill serving): `--fail-moe-device D
--failure-at T` crashes MoE device D at trace second T (a `FaultPlan`); the
executor's supervisor fences the dead worker, re-serves its orphaned
regions, evacuates its experts onto the survivors and restarts it, and the
summary prints the failover.  `--request-deadline S` ends requests past
their TTFT deadline with status=timeout, `--max-queue N` sheds arrivals
beyond a batcher backlog of N (status=shed), `--hedge-factor F` clones a
batch overdue by F x the EWMA batch service time (the first completion of
each request wins).

  PYTHONPATH=src python -m repro_torch.launch.serve --fail-moe-device 1 \
      --failure-at 0.5

Placement control (both engines): `--rebalance-interval S` ticks the
`PlacementController` every S seconds (trace seconds on the executor,
virtual on the sim).  The run boots round-robin and migrates toward
--placement / --replicate-hot once the policy decides; the executor
re-places experts LIVE between polls (quiesce, new resident stacks, atomic
table swap).  --rebalance-threshold R (busy-time max/mean trigger),
--rebalance-policy one_shot_threshold|hysteresis|partial|drift,
--rebalance-release R, --rebalance-cooldown N, --rebalance-max-bytes B.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --time-scale 20 --replicate-hot 2 --rebalance-interval 0.5 \
      --rebalance-threshold 1.0
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
from repro_torch.core import spans
from repro_torch.core.cost_model import H100, Deployment, Placement
from repro_torch.core.decode import (DecodeExecutor, ExecDecodeEngine,
                                     SimDecodeEngine)
from repro_torch.core.engine import (ExecutorEngine, RequestResult,
                                     RouterStatsCollector, SimEngine)
from repro_torch.core.executor import DisaggregatedExecutor
from repro_torch.core.faults import FaultPlan
from repro_torch.core.orchestrator import PDOrchestrator
from repro_torch.core.placement_control import POLICIES
from repro_torch.core.scheduler import LengthAwareBatcher
from repro_torch.core.simulator import SimConfig
from repro_torch.core.trace import (Request, TraceClock, TraceConfig,
                                    generate_requests, sample_lengths,
                                    sample_out_len)
from repro_torch.kernels.super_gmm import tuning
from repro_torch.models.common import ModelConfig
from repro_torch.models.lm import init_lm_params

ARCH = "qwen3_moe_235b_a22b"


def _fmt_decomp(d):
    return " ".join(f"{k}={v * 1000:.0f}ms" for k, v in d.items())


def _print_result(r: RequestResult):
    print(f"  done rid={r.rid:<3d} batch={r.batch_id} "
          f"group={r.group} ttft={r.ttft:.3f}s "
          f"first_token={r.first_token} status={r.status}"
          + (f" retries={r.retries}" if r.retries else "")
          + f"  [{_fmt_decomp(r.decomposition)}]")


def prewarm_rows(max_batch_tokens: int, D: int, moe_batch_window: float,
                 moe_batch_max_tokens: Optional[int]) -> int:
    """Rows per expert up to which the capacity buckets are prewarmed: half a
    full batch for one region; under batching the merged bound, which is
    `moe_batch_max_tokens` if set (a single region may still exceed it),
    else D regions' worth."""
    one = max(max_batch_tokens // 2, 1)
    if moe_batch_window <= 0:
        return one
    if moe_batch_max_tokens is not None:
        return max(one, moe_batch_max_tokens)
    return D * one


def serve_requests(cfg: ModelConfig, params, *, lengths: Sequence[int],
                   rps: float, time_scale: float = 1.0, seed: int = 0,
                   device="cuda", D: int = 2, E: int = 4,
                   placement: Optional[Placement] = None,
                   idle_backoff: Optional[float] = 0.05,
                   max_batch_tokens: int = 4096, verbose: bool = False,
                   moe_path: str = "fused", moe_batch_window: float = 0.0,
                   moe_batch_max_tokens: Optional[int] = None,
                   executor: Optional[DisaggregatedExecutor] = None,
                   fault_plan: Optional[FaultPlan] = None,
                   request_deadline: Optional[float] = None,
                   max_queue: Optional[int] = None,
                   hedge_factor: Optional[float] = None,
                   engine_kw: Optional[dict] = None) -> dict:
    """Serve `len(lengths)` requests with Poisson arrivals at `rps` through
    `ExecutorEngine` over `DisaggregatedExecutor(D, E)`.  Returns the
    results, the engine stats and the executor's launch telemetry.

    `executor` hands in a long-lived executor from an earlier wave (its
    streams, and with them the allocator's pools, stay warm); its stats are
    reset, and it is returned under "executor" for the next wave.
    `fault_plan`, `request_deadline`, `max_queue` and `hedge_factor` go to
    the engine (its request lifecycle under faults and overload), and so
    does `engine_kw` (the `rebalance_*` arguments of its placement control
    plane)."""
    rng = np.random.default_rng(seed + 1)
    n = len(lengths)
    arrivals = np.cumsum(rng.exponential(1.0 / max(rps, 1e-9), size=n))
    reqs = [Request(rid=i, arrival=float(arrivals[i]), length=int(lengths[i]))
            for i in range(n)]
    ex = executor
    if ex is None:
        ex = DisaggregatedExecutor(
            params, cfg, D=D, E=E, placement=placement,
            idle_backoff=idle_backoff, moe_path=moe_path,
            moe_batch_window=moe_batch_window,
            moe_batch_max_tokens=moe_batch_max_tokens, device=device)
        if moe_path == "fused":
            # the kernel library is built and every capacity bucket a
            # launch can reach is touched once before the clock starts
            ex.prewarm_buckets(prewarm_rows(max_batch_tokens, D,
                                            moe_batch_window,
                                            moe_batch_max_tokens))
    else:
        ex.reset_stats()
    engine = ExecutorEngine(
        ex, clock=TraceClock(speed=time_scale),
        batcher=LengthAwareBatcher(inflection=max(max_batch_tokens // 2, 1),
                                   max_tokens=max_batch_tokens,
                                   exclusive_cutoff=1 << 30, max_wait=0.05),
        token_seed=seed, fault_plan=fault_plan,
        request_deadline=request_deadline, max_queue=max_queue,
        hedge_factor=hedge_factor, **(engine_kw or {}))
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
        "rebalance_windows": engine.rebalance_windows,
        "batch_layers": sum(1 for ev in log if ev[0] == "combine"),
        # (B, S) of every attention step; (n_e, C) and the per-expert row
        # counts of every FFN launch
        "shapes": [ev[4] for ev in log if ev[0] == "attn"],
        "buckets": [(ev[2], ev[3]) for ev in log if ev[0] == "launch"],
        "counts": [ev[4] for ev in log if ev[0] == "launch"],
    }


def _load_tuning_table(args):
    if args.tuning_table:
        tuning.set_table(tuning.TuningTable.load(args.tuning_table))
        print(f"super-kernel tuning table loaded from {args.tuning_table}")


def _print_batching(args):
    if args.moe_batch_window:
        print(f"continuous MoE batching: window="
              f"{args.moe_batch_window * 1e3:g}ms"
              + (f" max_tokens={args.moe_batch_max_tokens}"
                 if args.moe_batch_max_tokens else ""))


def _setup(args):
    """(device, cfg, params) of the CLI's model, or None without a card."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("ERROR: --device cuda but no CUDA device is available (pass "
              "--device cpu --smoke for the CPU check)", file=sys.stderr)
        return None
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 stays fp32
    if args.smoke:
        cfg = get_config(ARCH).smoke().replace(
            num_layers=args.layers if args.layers is not None else 3,
            num_experts=8, top_k=2)
    else:
        cfg = get_config(ARCH).replace(
            num_layers=args.layers if args.layers is not None else 4)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.inference_mode():
        params = init_lm_params(gen, cfg, device)
    return device, cfg, params


def _placement(args) -> Placement:
    """--placement / --replicate-hot as the simulator resolves them:
    `--replicate-hot k` alone means replicated(k) on both engines."""
    return SimConfig(placement=args.placement,
                     replicate_hot=args.replicate_hot).resolved_placement()


def run_executor(args) -> int:
    setup = _setup(args)
    if setup is None:
        return 2
    device, cfg, params = setup
    if args.smoke:
        trace = TraceConfig(mean_len=48, max_len=64, seed=args.seed)
        lo, hi, max_tokens = 8, 64, 128
    else:
        trace = TraceConfig(mean_len=1024, max_len=2048, seed=args.seed)
        lo, hi, max_tokens = 64, 2048, 4096
    D = args.dp_groups if args.dp_groups is not None else 2
    E = args.moe_devices if args.moe_devices is not None else 4
    placement = _placement(args)
    print(f"disaggregated executor engine on {device}: D={D} attention "
          f"groups, E={E} MoE devices, {cfg.name} {cfg.num_layers}L x "
          f"{cfg.num_experts}e d_model={cfg.d_model} "
          f"{str(cfg.dtype).replace('torch.', '')}  "
          f"[placement={placement.policy}"
          + (f"(hot={placement.replicate_hot})" if placement.replicate_hot
             else "") + f" moe-path={args.moe_path} "
          f"time-scale={args.time_scale}x]")
    _load_tuning_table(args)
    _print_batching(args)
    lengths = np.clip(sample_lengths(args.requests, trace), lo, hi)
    print(f"{args.requests} requests, Poisson arrivals at {args.rps} req/s, "
          f"lengths {[int(x) for x in lengths]}")
    # validated against E in main()
    plan = FaultPlan.from_flags(args.failure_at, args.failure_duration,
                                args.fail_moe_device)
    if plan is not None:
        print(f"fault plan armed (supervised failover): "
              f"{[ev.to_dict() for ev in plan.events]}")
    # With a rebalance interval the executor boots on the cold round-robin
    # placement (the simulator's semantics) and the placement control plane
    # migrates LIVE toward --placement once it observes imbalance.
    boot = Placement() if args.rebalance_interval else placement
    engine_kw = {}
    if args.rebalance_interval:
        engine_kw = dict(rebalance_interval=args.rebalance_interval,
                         rebalance_threshold=args.rebalance_threshold,
                         rebalance_policy=args.rebalance_policy,
                         rebalance_target=placement,
                         rebalance_release=args.rebalance_release,
                         rebalance_cooldown=args.rebalance_cooldown,
                         rebalance_max_bytes=args.rebalance_max_bytes)
        print(f"placement control plane: policy={args.rebalance_policy} "
              f"interval={args.rebalance_interval}s "
              f"threshold={args.rebalance_threshold} -> target "
              f"{placement.policy}"
              + (f"(hot={placement.replicate_hot})"
                 if placement.replicate_hot else ""))

    if args.save_spans:
        spans.SPANS.start()
    out = serve_requests(cfg, params, lengths=[int(x) for x in lengths],
                         rps=args.rps, time_scale=args.time_scale,
                         seed=args.seed, device=device, D=D, E=E,
                         placement=boot, idle_backoff=args.idle_backoff,
                         max_batch_tokens=max_tokens, verbose=True,
                         moe_path=args.moe_path,
                         moe_batch_window=args.moe_batch_window,
                         moe_batch_max_tokens=args.moe_batch_max_tokens,
                         fault_plan=plan,
                         request_deadline=args.request_deadline,
                         max_queue=args.max_queue,
                         hedge_factor=args.hedge_factor,
                         engine_kw=engine_kw)
    if args.save_spans:
        spans.SPANS.stop()
        taken = spans.SPANS.take()
        with open(args.save_spans, "w") as f:
            json.dump(spans.chrome_trace(taken), f)
        print(f"{len(taken)} spans saved to {args.save_spans}")
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
    rebalances = [m for m in out["executor"].migrations
                  if m["kind"] == "rebalance"]
    if rebalances:
        print(f"live re-placement: {len(rebalances)} migration(s), "
              f"{sum(m['bytes'] for m in rebalances) / 1e6:.2f} MB of expert "
              f"weights moved, now serving placement={st.placement_policy}")
        for now, window, imb in out["rebalance_windows"]:
            print(f"  fired at t={now:.3f}s on the window busy="
                  f"{np.round(window, 4).tolist()} (imbalance {imb:.3f})")
    if st.statuses:
        print("request statuses: "
              + " ".join(f"{k}={v}" for k, v in sorted(st.statuses.items())))
    if st.failovers:
        fo = [m for m in out["executor"].migrations if m["kind"] == "failover"]
        print(f"supervised failover: {st.failovers} MoE-device "
              f"evacuation(s) executed live; dead device(s) "
              f"{list(out['executor'].placement.dead)} evacuated onto "
              f"survivors ({sum(m['bytes'] for m in fo) / 1e6:.2f} MB of "
              f"expert weights gained)")
    if st.hedges_issued:
        print(f"hedged dispatch: {st.hedges_issued} clone(s) issued, "
              f"{st.hedge_wins} won")
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
                "failovers": st.failovers,
                "dead_devices": list(out["executor"].placement.dead),
                "migrations": st.migrations,
                "migrated_bytes": st.migrated_bytes,
                "migration_log": [dict(m, devices=list(m["devices"]))
                                  for m in out["executor"].migrations],
                "hedges_issued": st.hedges_issued,
                "hedge_wins": st.hedge_wins,
                "moe_path": args.moe_path,
                "moe_batch_window": args.moe_batch_window,
                "moe_batch_max_tokens": args.moe_batch_max_tokens,
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


def run_simulation(args) -> int:
    """The serving lifecycle over the discrete-event simulator (virtual
    time, the reference's hardware preset): deepseek_v32, Poisson arrivals
    at --rps for --duration seconds."""
    cfg = get_config("deepseek_v32")
    measured = None
    if args.measured_from:
        col = RouterStatsCollector.load(args.measured_from)
        measured = col.resampled(max(cfg.num_experts, 1))
        print(f"expert-load model driven by MEASURED fractions from "
              f"{args.measured_from} ({col.total:.0f} assignments over "
              f"{col.num_experts} experts, resampled to {cfg.num_experts})")
    sim = SimConfig(mode=args.mode, rps=args.rps, duration=args.duration,
                    ep_skew=args.ep_skew, ep_skew_mode=args.ep_skew_mode,
                    placement=args.placement,
                    replicate_hot=args.replicate_hot,
                    rebalance_interval=args.rebalance_interval,
                    rebalance_threshold=args.rebalance_threshold,
                    rebalance_policy=args.rebalance_policy,
                    rebalance_release=args.rebalance_release,
                    rebalance_cooldown=args.rebalance_cooldown,
                    rebalance_max_bytes=args.rebalance_max_bytes,
                    failure_at=args.failure_at,
                    failure_duration=args.failure_duration,
                    failure_moe_device=args.fail_moe_device,
                    measured_fractions=measured)
    deps = {}
    if args.dp_groups is not None or args.moe_devices is not None:
        D = args.dp_groups if args.dp_groups is not None else 4
        E = args.moe_devices if args.moe_devices is not None else 16
        deps = dict(asap_dep=Deployment(D=D, T=4, E=E),
                    sync_dep=Deployment(D=2 * D, T=4, E=2 * E))
    engine = SimEngine(cfg, sim, **deps)
    engine.submit_all(generate_requests(args.rps, args.duration, sim.trace))
    results = engine.drain()
    st = engine.stats()

    pl = sim.resolved_placement()
    print(f"mode={args.mode} rps={args.rps} duration={args.duration}s "
          f"ep_skew={args.ep_skew} ({args.ep_skew_mode})"
          + (" [measured fractions]" if measured else ""))
    extra = f"placement={pl.policy}"
    if pl.replicate_hot:
        extra += f"(hot={pl.replicate_hot})"
    if args.rebalance_interval:
        extra += (f" rebalance every {args.rebalance_interval}s "
                  f"({args.rebalance_policy}); {st.migrations} migration(s), "
                  f"{st.migrated_bytes / 1e6:.1f} MB moved")
    if args.fail_moe_device is not None and args.failure_at is not None:
        extra += (f"  [MoE device {args.fail_moe_device} killed at "
                  f"t={args.failure_at}s]")
    print(f"  {extra}")
    ok = [r for r in results if r.status == "ok"]
    ttfts = np.array([r.ttft for r in ok])
    print(f"  completed: {len(ok)}/{st.submitted}"
          + (f"  (timeout: {len(results) - len(ok)})"
             if len(results) > len(ok) else ""))
    if len(ttfts):
        print(f"  mean TTFT: {ttfts.mean() * 1000:.0f} ms   "
              f"p99: {np.percentile(ttfts, 99) * 1000:.0f} ms")
    if st.moe_device_util is not None:
        u = st.moe_device_util
        print(f"  MoE device util: mean {u.mean() * 100:.0f}%  "
              f"max {u.max() * 100:.0f}%  imbalance {st.moe_imbalance():.2f}x")
    return 0


# ---------------------------------------------------------------------------
# Prefill/decode disaggregation (--mode pd)
# ---------------------------------------------------------------------------


def _pd_gate(results, reqs, kv_log, colocated) -> int:
    """The pd contract: every request reached a definite status, every ok
    request produced exactly its sampled out_len tokens, and the
    disaggregated path performed at least one KV handoff."""
    out_len = {r.rid: r.out_len for r in reqs}
    rc = 0
    if len(results) != len(reqs):
        print(f"ERROR: {len(reqs) - len(results)} request(s) without a "
              f"result", file=sys.stderr)
        rc = 1
    for r in results:
        if r.status not in ("ok", "timeout", "failed"):
            print(f"ERROR: rid={r.rid} indefinite status {r.status!r}",
                  file=sys.stderr)
            rc = 1
        if r.status == "ok" and r.tokens_out != out_len[r.rid]:
            print(f"ERROR: rid={r.rid} produced {r.tokens_out} tokens, "
                  f"expected out_len={out_len[r.rid]}", file=sys.stderr)
            rc = 1
    if not colocated and kv_log.count < 1:
        print("ERROR: disaggregated run performed no KV handoff",
              file=sys.stderr)
        rc = 1
    return rc


def _pd_summary(results, kv_log, colocated):
    ok = [r for r in results if r.status == "ok"]
    ttfts = np.array([r.ttft for r in ok]) if ok else np.array([0.0])
    tpots = [r.tpot for r in ok if r.tpot is not None]
    toks = sum(r.tokens_out for r in ok)
    print(f"completed {len(ok)}/{len(results)} ok, {toks} tokens out; "
          f"mean TTFT {ttfts.mean() * 1000:.0f} ms"
          + (f", mean TPOT {np.mean(tpots) * 1000:.1f} ms" if tpots else ""))
    if colocated:
        print("kv handoffs: 0 (colocated baseline)")
    else:
        print(f"kv handoffs: {kv_log.count} "
              f"({kv_log.bytes / 1e6:.2f} MB, "
              f"{kv_log.seconds * 1000:.2f} ms link time)")


def _print_pd_result(r: RequestResult):
    print(f"  done rid={r.rid:<3d} tokens_out={r.tokens_out} "
          f"ttft={r.ttft:.3f}s"
          + (f" tpot={r.tpot * 1000:.1f}ms" if r.tpot else "")
          + f" status={r.status}  [{_fmt_decomp(r.decomposition)}]")


def pd_requests(lengths: Sequence[int], out_lens: Sequence[int], rps: float,
                seed: int) -> List[Request]:
    """Requests with Poisson arrivals at `rps` (the serve phase's draw)."""
    rng = np.random.default_rng(seed + 1)
    arrivals = np.cumsum(rng.exponential(1.0 / max(rps, 1e-9),
                                         size=len(lengths)))
    return [Request(rid=i, arrival=float(arrivals[i]), length=int(n),
                    out_len=int(o))
            for i, (n, o) in enumerate(zip(lengths, out_lens))]


def serve_pd(cfg: ModelConfig, params, reqs: Sequence[Request], *,
             prompts: Optional[dict] = None, device="cuda", D: int = 2,
             E: int = 4, slots: int = 8, max_len: int = 256, time_scale: float = 1.0,
             colocated: bool = False, max_batch_tokens: int = 4096,
             idle_backoff: Optional[float] = 0.05, verbose: bool = False,
             moe_batch_window: float = 0.0,
             moe_batch_max_tokens: Optional[int] = None,
             executor: Optional[DisaggregatedExecutor] = None) -> dict:
    """Serve `reqs` through prefill/decode disaggregation: ExecutorEngine
    (keep_kv) over an emit_kv DisaggregatedExecutor(D, E) -> KV handoff
    priced on the H100's link -> DecodeExecutor(slots, max_len) behind
    ExecDecodeEngine, federated by a PDOrchestrator.  `prompts` maps rid
    to its token ids (synthesised from the rid when absent).  Returns the
    results, the orchestrator, the decode runtime and the executor.

    `executor` hands in a long-lived executor from an earlier wave (workers
    stopped between waves); it is switched to emit_kv and its stats are
    reset."""
    ex = executor
    if ex is None:
        ex = DisaggregatedExecutor(
            params, cfg, D=D, E=E, emit_kv=True, idle_backoff=idle_backoff,
            moe_batch_window=moe_batch_window,
            moe_batch_max_tokens=moe_batch_max_tokens, device=device)
        ex.prewarm_buckets(prewarm_rows(max_batch_tokens, D,
                                        moe_batch_window,
                                        moe_batch_max_tokens))
    else:
        ex.emit_kv = True
        ex.reset_stats()
    clock = TraceClock(speed=time_scale)
    pre = ExecutorEngine(
        ex, clock=clock, keep_kv=True,
        batcher=LengthAwareBatcher(inflection=max(max_batch_tokens // 2, 1),
                                   max_tokens=max_batch_tokens,
                                   exclusive_cutoff=1 << 30, max_wait=0.05))
    rt = DecodeExecutor(params, cfg, slots=slots, max_len=max_len,
                        clock=clock.now)
    orch = PDOrchestrator([pre], [ExecDecodeEngine(rt)], hw=H100,
                          colocated=colocated)
    t0 = time.time()
    for q in reqs:
        orch.submit(q, None if prompts is None else prompts[q.rid])
    results: List[RequestResult] = []
    while len(results) < len(reqs) and time.time() - t0 < 600:
        for r in orch.poll():
            results.append(r)
            if verbose:
                _print_pd_result(r)
        time.sleep(0.002)
    for r in orch.drain(timeout=120):
        results.append(r)
        if verbose:
            _print_pd_result(r)
    wall = time.time() - t0
    orch.close()  # closes the prefill engine too
    return {"results": results, "orch": orch, "runtime": rt, "wall": wall,
            "executor": ex, "kv_log": orch.kv_log}


def run_pd_sim(args) -> int:
    """`--mode pd --engine sim`: the simulator's prefill engine feeds
    `SimDecodeEngine` (analytic continuous batching) through the KV-handoff
    layer, priced on the prefill simulator's hardware."""
    out_mean = args.out_len_mean if args.out_len_mean is not None else 4.0
    out_cv = args.out_len_cv if args.out_len_cv is not None else 0.5
    label = "colocated baseline" if args.colocated else "disaggregated"
    cfg = get_config("deepseek_v32")
    tc = TraceConfig(out_len_mean=out_mean, out_len_cv=out_cv)
    sim = SimConfig(mode="asap", rps=args.rps, duration=args.duration,
                    ep_skew=args.ep_skew, ep_skew_mode=args.ep_skew_mode,
                    trace=tc)
    width = args.decode_width if args.decode_width is not None else 32
    pre = SimEngine(cfg, sim)
    dec = SimDecodeEngine(cfg, pre._sim.cm,
                          load_model=pre._sim.load_model, width=width)
    orch = PDOrchestrator([pre], [dec], hw=pre._sim.cm.hw,
                          colocated=args.colocated)
    reqs = generate_requests(args.rps, args.duration, tc)
    print(f"sim pd engine ({label}): rps={args.rps} "
          f"duration={args.duration}s out_len~lognorm(mean={out_mean}, "
          f"cv={out_cv}) decode_width={width}")
    orch.submit_all(reqs)
    results = orch.drain()
    for r in sorted(results, key=lambda x: x.completion_time
                    if x.completion_time is not None
                    else x.first_token_time)[:12]:
        print(f"  done rid={r.rid:<3d} tokens_out={r.tokens_out} "
              f"ttft={r.ttft:.3f}s"
              + (f" tpot={r.tpot * 1000:.1f}ms" if r.tpot else "")
              + f" status={r.status}")
    _pd_summary(results, orch.kv_log, args.colocated)
    return _pd_gate(results, reqs, orch.kv_log, args.colocated)


def run_pd(args) -> int:
    """Disaggregated prefill/decode serving (`--mode pd`)."""
    if args.engine == "sim":
        return run_pd_sim(args)
    setup = _setup(args)
    if setup is None:
        return 2
    device, cfg, params = setup
    out_mean = args.out_len_mean if args.out_len_mean is not None else 4.0
    out_cv = args.out_len_cv if args.out_len_cv is not None else 0.5
    label = "colocated baseline" if args.colocated else "disaggregated"
    D = args.dp_groups if args.dp_groups is not None else 2
    E = args.moe_devices if args.moe_devices is not None else 4
    if args.smoke:  # the reference's pd config: 3 layers, 8 experts top-2
        slots = args.decode_width if args.decode_width is not None else 4
        max_len, max_tokens = 64, 128
        tc = TraceConfig(mean_len=24, max_len=32, seed=args.seed,
                         out_len_mean=out_mean, out_len_cv=out_cv)
        lengths = np.clip(sample_lengths(args.requests, tc), 8, 32)
    else:
        slots = args.decode_width if args.decode_width is not None else 8
        max_len, max_tokens = 2048 + 64, 4096
        tc = TraceConfig(mean_len=1024, max_len=2048, seed=args.seed,
                         out_len_mean=out_mean, out_len_cv=out_cv)
        lengths = np.clip(sample_lengths(args.requests, tc), 64, 2048)
    out_lens = [min(sample_out_len(i, tc), max_len - int(n))
                for i, n in enumerate(lengths)]
    reqs = pd_requests(lengths, out_lens, args.rps, args.seed)
    print(f"executor pd engine on {device} ({label}): D={D} prefill groups, "
          f"E={E} MoE devices, {cfg.name} {cfg.num_layers}L x "
          f"{cfg.num_experts}e d_model={cfg.d_model} "
          f"{str(cfg.dtype).replace('torch.', '')} -> decode runtime with "
          f"{slots} slots x {max_len} tokens; {args.requests} requests, "
          f"lengths {[int(x) for x in lengths]}, out_lens {out_lens}")
    _load_tuning_table(args)
    _print_batching(args)
    out = serve_pd(cfg, params, reqs, device=device, D=D, E=E, slots=slots,
                   max_len=max_len, time_scale=args.time_scale,
                   colocated=args.colocated, max_batch_tokens=max_tokens,
                   idle_backoff=args.idle_backoff, verbose=True,
                   moe_batch_window=args.moe_batch_window,
                   moe_batch_max_tokens=args.moe_batch_max_tokens)
    results, rt, kv_log = out["results"], out["runtime"], out["kv_log"]
    _pd_summary(results, kv_log, args.colocated)
    print(f"decode runtime: {rt.steps} steps, {rt.trace_counts['decode_step']}"
          f" step signature(s) (shapes and capacity never changed == 1)")
    rc = _pd_gate(results, reqs, kv_log, args.colocated)
    if args.save_stats:
        ok = [r for r in results if r.status == "ok"]
        tpots = [r.tpot for r in ok if r.tpot is not None]
        with open(args.save_stats, "w") as f:
            json.dump({
                "engine": f"pd:{'colocated' if args.colocated else 'remote'}",
                "device": str(device),
                "requests": len(reqs),
                "completed_ok": len(ok),
                "tokens_out": int(sum(r.tokens_out for r in ok)),
                "expected_tokens": int(sum(r.out_len for r in reqs)),
                "mean_ttft": float(np.mean([r.ttft for r in ok]))
                if ok else None,
                "mean_tpot": float(np.mean(tpots)) if tpots else None,
                "kv_handoffs": kv_log.count,
                "kv_bytes": kv_log.bytes,
                "decode_steps": rt.steps,
                "decode_step_signatures": rt.trace_counts["decode_step"],
                "moe_batch_window": args.moe_batch_window,
                "statuses": {r.rid: r.status for r in results},
            }, f, indent=2)
        print(f"pd stats saved to {args.save_stats}")
    return rc


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Serve prefill requests through the disaggregated "
                    "executor or the simulator (PyTorch/CUDA port).")
    ap.add_argument("--engine", choices=["executor", "sim"],
                    default="executor",
                    help="executor: the threaded runtime on the card; sim: "
                         "the discrete-event simulator (virtual time)")
    ap.add_argument("--requests", type=int, default=8,
                    help="executor engine: number of requests")
    ap.add_argument("--rps", type=float, default=4.0,
                    help="Poisson arrival rate of the timed admission "
                         "(both engines)")
    ap.add_argument("--duration", type=float, default=30.0,
                    help="sim engine: seconds of Poisson arrivals")
    ap.add_argument("--dp-groups", type=int, default=None,
                    help="attention DP groups D (default 2 executor / 4 "
                         "sim)")
    ap.add_argument("--moe-devices", type=int, default=None,
                    help="MoE expert devices E (default 4 executor / 16 "
                         "sim)")
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="trace seconds replayed per wall second (TraceClock "
                         "speed); raise it on a slow CPU")
    ap.add_argument("--placement", default="round_robin",
                    help="expert placement policy: round_robin | "
                         "greedy_balanced | replicated | replicated(k)")
    ap.add_argument("--replicate-hot", type=int, default=0,
                    help="replicate the k hottest experts across the least-"
                         "loaded MoE devices (implies --placement replicated)")
    ap.add_argument("--ep-skew", type=float, default=0.0,
                    help="sim engine: Zipf exponent of expert-routing skew "
                         "(0 = uniform)")
    ap.add_argument("--ep-skew-mode", default="zipf",
                    choices=["uniform", "zipf", "layer"],
                    help="sim engine: hot experts per-layer (zipf) or "
                         "layer-correlated")
    ap.add_argument("--measured-from", default=None, metavar="PATH",
                    help="sim engine: drive expert load from measured router "
                         "stats JSON (--save-router-stats) instead of "
                         "synthetic --ep-skew")
    ap.add_argument("--rebalance-interval", type=float, default=None,
                    help="seconds between placement-control ticks (both "
                         "engines): start round-robin, migrate to the target "
                         "placement once the policy decides -- the executor "
                         "engine re-places experts LIVE")
    ap.add_argument("--rebalance-threshold", type=float, default=1.05,
                    help="observed busy-time max/mean imbalance that "
                         "triggers a migration")
    ap.add_argument("--rebalance-policy", default=None, choices=POLICIES,
                    help="placement-control policy (default "
                         "one_shot_threshold); requires --rebalance-interval")
    ap.add_argument("--rebalance-release", type=float, default=None,
                    help="hysteresis policy: imbalance below which the "
                         "placement reverts to the boot layout")
    ap.add_argument("--rebalance-cooldown", type=int, default=1,
                    help="min windows between migrations (hysteresis/drift)")
    ap.add_argument("--rebalance-max-bytes", type=float, default=None,
                    help="partial policy: cap on expert-weight bytes "
                         "migrated per window")
    ap.add_argument("--idle-backoff", type=float, default=0.05,
                    help="max seconds a MoE worker waits on its condition "
                         "variable before re-checking the stop flag")
    ap.add_argument("--moe-path", default="fused", choices=["fused", "eager"],
                    help="the MoE stage: the fused Super Kernel hot path, or "
                         "the pre-fusion per-expert loop (baseline; prefill "
                         "serving only)")
    ap.add_argument("--moe-batch-window", type=float, default=0.0,
                    help="cross-region continuous batching: after the first "
                         "drained region each MoE worker keeps accumulating "
                         "arrivals for up to this many WALL seconds and "
                         "launches the Super Kernel once per layer over the "
                         "merged capacity buffer; 0 (default) serves one "
                         "region per launch")
    ap.add_argument("--moe-batch-max-tokens", type=int, default=None,
                    help="cap on the merged token rows of one batched launch; "
                         "requires --moe-batch-window > 0")
    ap.add_argument("--tuning-table", default=None, metavar="PATH",
                    help="Super Kernel tuning table JSON (from python -m "
                         "repro_torch.launch.tune_superkernel) consulted per "
                         "launch for the kernel's (BM, BN) tile; absent "
                         "entries take the default tile")
    ap.add_argument("--failure-at", type=float, default=None,
                    help="crash the --fail-moe-device MoE device at this "
                         "trace second (sim engine: without "
                         "--fail-moe-device, a DP-group outage)")
    ap.add_argument("--failure-duration", type=float, default=5.0,
                    help="the fault event's duration (trace seconds; a "
                         "crash's failover is permanent)")
    ap.add_argument("--fail-moe-device", type=int, default=None,
                    help="kill this MoE device at --failure-at: the "
                         "supervisor re-serves its orphaned regions and "
                         "evacuates its experts onto the survivors")
    ap.add_argument("--request-deadline", type=float, default=None,
                    help="TTFT deadline in trace seconds: requests that age "
                         "past it expire in queue or end status=timeout")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="batcher backlog at which arrivals are shed "
                         "(status=shed) instead of queueing")
    ap.add_argument("--hedge-factor", type=float, default=None,
                    help="clone a batch overdue by this factor x the EWMA "
                         "batch service time onto the shared queue; the "
                         "first completion of each request wins")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-stats", default=None, metavar="PATH",
                    help="write EngineStats as JSON after the run")
    ap.add_argument("--save-router-stats", default=None, metavar="PATH",
                    help="write measured per-expert routing stats (JSON)")
    ap.add_argument("--save-spans", default=None, metavar="PATH",
                    help="record the serving path's spans and write them as "
                         "Chrome-trace JSON (to open beside a torch.profiler "
                         "trace)")
    ap.add_argument("--smoke", action="store_true",
                    help="the small fp32 config (3 layers, 8 experts top-2) "
                         "instead of the full-width model")
    ap.add_argument("--layers", type=int, default=None,
                    help="model depth (default 4 at full width, 3 with "
                         "--smoke)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions (use with --smoke)")
    ap.add_argument("--mode", default="asap",
                    choices=["asap", "default", "chunked", "pd"],
                    help="asap: prefill serving; default / chunked: the "
                         "simulator's synchronous baselines (--engine sim); "
                         "pd: the disaggregated prefill/decode lifecycle "
                         "(either engine)")
    ap.add_argument("--out-len-mean", type=float, default=None,
                    help="pd mode: mean sampled decode length (tokens, "
                         "lognormal, deterministic per rid; default 4)")
    ap.add_argument("--out-len-cv", type=float, default=None,
                    help="pd mode: coefficient of variation of the sampled "
                         "decode lengths (default 0.5)")
    ap.add_argument("--decode-width", type=int, default=None,
                    help="pd mode: decode cache slots (default 8 at full "
                         "width, 4 with --smoke)")
    ap.add_argument("--colocated", action="store_true",
                    help="pd mode: colocated baseline -- prefill and decode "
                         "share the device, KV transfer costs nothing and no "
                         "handoff is logged")
    args = ap.parse_args(argv)
    # a policy knob without the interval that would ever tick it is a
    # configuration mistake the user should hear about, not a silent no-op
    if args.rebalance_interval is None:
        for flag, val, default in (
                ("--rebalance-policy", args.rebalance_policy, None),
                ("--rebalance-threshold", args.rebalance_threshold, 1.05),
                ("--rebalance-release", args.rebalance_release, None),
                ("--rebalance-cooldown", args.rebalance_cooldown, 1),
                ("--rebalance-max-bytes", args.rebalance_max_bytes, None)):
            if val != default:
                ap.error(f"{flag} requires --rebalance-interval (the "
                         f"control plane never ticks without an interval)")
    if args.rebalance_policy == "partial" and not args.rebalance_max_bytes:
        ap.error("--rebalance-policy partial requires --rebalance-max-bytes "
                 "(the per-window migration budget)")
    if args.rebalance_release is not None \
            and args.rebalance_release > args.rebalance_threshold:
        ap.error(f"--rebalance-release ({args.rebalance_release}) must not "
                 f"exceed --rebalance-threshold ({args.rebalance_threshold})")
    if args.rebalance_policy is None:
        args.rebalance_policy = "one_shot_threshold"
    if args.rebalance_interval is not None \
            and args.rebalance_interval <= 0:
        ap.error("--rebalance-interval must be positive")
    if args.save_spans and (args.engine == "sim" or args.mode == "pd"):
        ap.error("--save-spans records the executor engine's prefill "
                 "serving; it requires --engine executor without --mode pd")
    if args.engine == "sim":
        for flag, val, default in (
                ("--request-deadline", args.request_deadline, None),
                ("--max-queue", args.max_queue, None),
                ("--hedge-factor", args.hedge_factor, None)):
            if val != default:
                ap.error(f"{flag} is an executor-engine request-lifecycle "
                         f"knob; --engine sim does not consume it")
        for flag, val, default in (
                ("--moe-batch-window", args.moe_batch_window, 0.0),
                ("--moe-batch-max-tokens", args.moe_batch_max_tokens, None),
                ("--tuning-table", args.tuning_table, None)):
            if val != default:
                ap.error(f"{flag} batches/tunes the REAL executor's super-"
                         f"kernel launches; --engine sim does not consume it")
        if args.moe_path != "fused":
            ap.error("--moe-path selects the REAL executor's MoE path; "
                     "--engine sim does not consume it")
        for flag, val, default in (("--smoke", args.smoke, False),
                                   ("--layers", args.layers, None)):
            if val != default:
                ap.error(f"{flag} sizes the executor's model; --engine sim "
                         f"simulates deepseek_v32 at full size")
    else:
        if args.mode in ("default", "chunked"):
            ap.error(f"--mode {args.mode} is a synchronous baseline of the "
                     f"simulator; it requires --engine sim")
        for flag, val, default in (
                ("--measured-from", args.measured_from, None),
                ("--ep-skew", args.ep_skew, 0.0),
                ("--ep-skew-mode", args.ep_skew_mode, "zipf"),
                ("--duration", args.duration, 30.0)):
            if val != default:
                ap.error(f"{flag} drives the simulator's trace and load "
                         f"model; it requires --engine sim")
    try:
        placement = _placement(args)
    except ValueError as ex:
        ap.error(f"--placement/--replicate-hot: {ex}")
    if args.rebalance_interval is not None and placement == Placement():
        print("warning: --rebalance-interval with the default round_robin "
              "--placement arms a control plane that is already at its "
              "target — no migration will ever fire; pass --placement/"
              "--replicate-hot to give it somewhere to go", file=sys.stderr)
    if args.requests < 1:
        ap.error("--requests must be >= 1")
    if args.layers is not None and args.layers < 1:
        ap.error("--layers must be >= 1")
    if args.moe_batch_window < 0:
        ap.error("--moe-batch-window must be >= 0")
    if args.moe_batch_window > 0 and args.moe_path == "eager":
        ap.error("--moe-batch-window requires --moe-path fused (batching "
                 "merges regions into ONE capacity buffer)")
    if args.moe_batch_max_tokens is not None:
        if args.moe_batch_max_tokens < 1:
            ap.error("--moe-batch-max-tokens must be >= 1")
        if args.moe_batch_window <= 0:
            ap.error("--moe-batch-max-tokens bounds the accumulation window; "
                     "it requires --moe-batch-window > 0")
    # fault / lifecycle flags: unsupported combinations fail loudly instead
    # of silently dropping the fault
    if args.fail_moe_device is not None and args.failure_at is None:
        ap.error("--fail-moe-device requires --failure-at (when should the "
                 "device die?)")
    if args.engine == "executor" and args.failure_at is not None \
            and args.fail_moe_device is None:
        ap.error("--failure-at needs --fail-moe-device D: the executor has "
                 "no DP-group failure path, it kills an MoE device")
    if args.fail_moe_device is not None:
        E = args.moe_devices if args.moe_devices is not None \
            else (16 if args.engine == "sim" else 4)
        try:
            FaultPlan.from_flags(args.failure_at, args.failure_duration,
                                 args.fail_moe_device).validate(E)
        except ValueError as ex:
            ap.error(f"--fail-moe-device/--failure-at: {ex}")
    for flag, val in (("--request-deadline", args.request_deadline),
                      ("--max-queue", args.max_queue),
                      ("--hedge-factor", args.hedge_factor)):
        if val is not None and val <= 0:
            ap.error(f"{flag} must be > 0")
    # decode knobs without the mode that consumes them are configuration
    # mistakes, not silent no-ops
    if args.mode != "pd":
        for flag, val in (("--out-len-mean", args.out_len_mean),
                          ("--out-len-cv", args.out_len_cv),
                          ("--decode-width", args.decode_width)):
            if val is not None:
                ap.error(f"{flag} requires --mode pd (only the "
                         f"disaggregated lifecycle runs a decode stage)")
        if args.colocated:
            ap.error("--colocated requires --mode pd (it selects the "
                     "colocated prefill+decode baseline)")
        if args.engine == "sim":
            return run_simulation(args)
        return run_executor(args)
    if args.out_len_mean is not None and args.out_len_mean < 1.0:
        ap.error("--out-len-mean must be >= 1 (every request emits at "
                 "least the first token)")
    if args.out_len_cv is not None and args.out_len_cv < 0.0:
        ap.error("--out-len-cv must be >= 0")
    if args.decode_width is not None and args.decode_width < 1:
        ap.error("--decode-width must be >= 1")
    if args.save_router_stats:
        ap.error("--save-router-stats is not supported with --mode pd")
    for flag, val in (("--rebalance-interval", args.rebalance_interval),
                      ("--failure-at", args.failure_at),
                      ("--request-deadline", args.request_deadline),
                      ("--max-queue", args.max_queue),
                      ("--hedge-factor", args.hedge_factor)):
        if val is not None:
            ap.error(f"{flag} is not supported with --mode pd (the "
                     f"disaggregated path runs the plain prefill lifecycle; "
                     f"run it without --mode pd)")
    if args.moe_path == "eager":
        ap.error("--moe-path eager is not supported with --mode pd (the "
                 "prefill executor exports KV from the fused attention step)")
    return run_pd(args)


if __name__ == "__main__":
    sys.exit(main())
