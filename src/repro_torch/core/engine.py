"""`ServingEngine` -- the request-lifecycle API over the ASAP runtime.

ASAP's argument is about *online* prefill serving: variance in arrival rates
and sequence lengths is what creates DP imbalance and sync stalls.  The
engine gives the real executor a continuous-ingestion interface:

    engine.submit(Request) -> RequestHandle     # timed admission
    engine.poll()          -> [RequestResult]   # streamed, OUT OF ORDER
    engine.drain()         -> [RequestResult]   # block until all complete
    engine.stats()         -> EngineStats       # device util + MEASURED
                                                #   per-expert routing stats
    engine.close()

Backends:

  SimEngine      -- wraps AsapSim/SyncSim.  Virtual time: submit() injects an
                   arrival event, poll()/drain() advance the discrete-event
                   heap incrementally (`step`), completions stream out in
                   simulated completion order.
  ExecutorEngine -- wraps the long-lived `DisaggregatedExecutor`.  Wall time:
                   a replayable `TraceClock` (trace seconds, optionally
                   time-scaled) gates admission so `Request.arrival` is
                   honored; a `LengthAwareBatcher` forms batches online;
                   un-pinned jobs are pulled by whichever attention group
                   frees a dual-batch slot first (least-loaded assignment);
                   completions surface out of order from the group worker
                   threads.

`RouterStatsCollector` records MEASURED per-expert token fractions (from the
executor's real router assignments, or expectation-weighted from the sim's
load model) and feeds them back as `expert_fractions` / `Placement`
popularity input or as `SimConfig.measured_fractions`.  With
`rebalance_interval` the executor engine runs the placement control plane
the simulator runs (`PlacementController`): every interval it observes the
window's measured busy time and routing fractions and executes the plans it
emits through the executor's live swap.  The request lifecycle
survives faults: a `FaultPlan` is armed on the executor at start (its
supervisor fails dead MoE devices over), `max_queue` sheds arrivals under
overload, `request_deadline` expires aged requests, `hedge_factor` clones
overdue batches (the first completion of each request wins), and drain()
ends every request with a definite status.  With `keep_kv=True` the
engine keeps each ok request's prompt KV (from an `emit_kv` executor) until
the prefill/decode orchestrator claims it with `take_kv`.
"""
from __future__ import annotations

import abc
import dataclasses
import heapq
import itertools
import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cost_model import (Deployment, Placement,
                                         resample_fractions)
from repro_torch.core.executor import (BatchJob, DisaggregatedExecutor,
                                       SwapAborted)
from repro_torch.core.faults import FaultPlan
from repro_torch.core.kv import KVHandle, KVSpec
from repro_torch.core.placement_control import (PlacementController,
                                                WindowObservation)
from repro_torch.core.scheduler import Batch, LengthAwareBatcher
from repro_torch.core.simulator import (AsapSim, SimConfig, SyncSim,
                                        drain_horizon)
from repro_torch.core.spans import SPANS
from repro_torch.core.trace import Request, TraceClock
from repro_torch.kernels import _launch
from repro_torch.models.lm import lm_head


# ---------------------------------------------------------------------------
# Results, handles, stats
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RequestResult:
    """Terminal record of one request's prefill (the 'first token' event).

    `decomposition` is the TTFT split in trace seconds.  Contract (pinned by
    the engine tests): every component is
    >= 0 and the components sum to <= ttft (+ float slack).  Common keys:
    "queue" (admission wait), "kernel" (attention-side compute), "comm"
    (blocked on dispatch/combine + remote MoE), "other".
    """
    rid: int
    arrival: float
    length: int
    first_token_time: float
    decomposition: Dict[str, float]
    batch_id: Optional[int] = None
    group: Optional[int] = None  # attention group that served the batch
    first_token: Optional[int] = None  # sampled token id (executor engine)
    # Terminal status: "ok" (served), "timeout" (served, or expired, past
    # its deadline; or a decode stage did not finish in time), "shed"
    # (rejected at admission under overload) or "failed" (retry budget
    # exhausted or the backend died).  Every submitted request ends in
    # exactly one of these -- drain() never strands a handle.
    status: str = "ok"
    retries: int = 0  # fault-aborted region replays the batch survived
    # --- decode extension --------------------------------------------------
    # tokens_out counts EVERY emitted token (first token included), so a
    # prefill-only request has tokens_out == 1 and completion_time ==
    # first_token_time.  When a decode stage served the request the
    # decomposition grows "kv_transfer" / "decode_queue" / "decode" keys:
    # components >= 0 summing <= the completion latency, and
    # tpot == (completion_time - first_token_time) / (tokens_out - 1).
    tokens_out: int = 1
    completion_time: Optional[float] = None  # last-token timestamp
    token_times: Optional[List[float]] = None  # per-token timestamps
    output_tokens: Optional[List[int]] = None  # the ids, first token first

    @property
    def ttft(self) -> float:
        return self.first_token_time - self.arrival

    @property
    def completion_latency(self) -> float:
        t = self.completion_time if self.completion_time is not None \
            else self.first_token_time
        return t - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        """Mean time per output token over the decode tail (None until a
        decode stage produced more than the first token)."""
        if self.completion_time is None or self.tokens_out <= 1:
            return None
        return (self.completion_time - self.first_token_time) \
            / (self.tokens_out - 1)

    @property
    def ok(self) -> bool:
        return self.status == "ok"


class RequestHandle:
    """Per-request future returned by `ServingEngine.submit`."""

    def __init__(self, engine: "ServingEngine", request: Request):
        self.rid = request.rid
        self.arrival = request.arrival
        self.length = request.length
        self._engine = engine
        self._event = threading.Event()
        self._result: Optional[RequestResult] = None

    def _fulfill(self, result: RequestResult):
        self._result = result
        self._event.set()

    def done(self) -> bool:
        return self._result is not None

    def result(self, timeout: Optional[float] = None) -> RequestResult:
        """Block until this request completes."""
        if self._result is None:
            self._engine._wait_handle(self, timeout)
        assert self._result is not None
        return self._result


@dataclasses.dataclass
class EngineStats:
    """Point-in-time serving statistics (ServingEngine.stats())."""
    engine: str
    elapsed: float  # trace seconds since serving started
    submitted: int
    completed: int
    expert_fractions: np.ndarray  # MEASURED per-expert token fractions
    router_assignments: float  # assignments behind expert_fractions
    moe_device_util: Optional[np.ndarray] = None  # busy fraction per device
    group_util: Optional[np.ndarray] = None  # attention groups (if tracked)
    placement_policy: Optional[str] = None  # installed placement
    migrations: int = 0  # live re-placements executed (failovers included)
    migrated_bytes: float = 0.0  # expert weight bytes they gained
    # fault tolerance
    failovers: int = 0  # supervised MoE-device evacuations executed
    statuses: Optional[Dict[str, int]] = None  # terminal status histogram
    hedges_issued: int = 0  # duplicate batches launched for overdue ones
    hedge_wins: int = 0  # hedges that finished before their primary
    # super-kernel launch telemetry
    moe_launches: int = 0  # super-kernel FFN launches issued
    moe_batch_regions: float = 0.0  # regions served by those launches
    moe_batch_occupancy: float = 0.0  # launched rows / capacity slots
    bucket_hits: int = 0  # launches reusing an already-seen C bucket
    bucket_misses: int = 0  # first-sighting launches (a new buffer shape);
    # growth AFTER warm-up means traffic left the pre-warmed buckets

    def regions_per_launch(self) -> float:
        """Mean regions served per super-kernel launch (1.0 on the
        per-region path)."""
        if self.moe_launches <= 0:
            return 0.0
        return float(self.moe_batch_regions / self.moe_launches)

    def moe_imbalance(self) -> float:
        u = self.moe_device_util
        if u is None or not len(u) or u.mean() <= 0:
            return 1.0
        return float(u.max() / u.mean())


# ---------------------------------------------------------------------------
# Measured router statistics
# ---------------------------------------------------------------------------


class RouterStatsCollector:
    """Accumulates MEASURED per-expert token-assignment counts from live runs.

    The executor records every real `router_topk` assignment here (before
    placement routing, so the collector sees expert popularity rather than
    device load); the SimEngine records the load model's expectation per
    batch-layer.  `fractions()` always sums to 1 and ranks hot experts
    exactly as the recorded assignments do; `fractions_tuple()` feeds back
    into `DisaggregatedExecutor(expert_fractions=...)` / `Placement` tables,
    and `resampled(n)` / `SimConfig.measured_fractions` drive the simulator's
    skew model from measurements instead of synthetic Zipf.  `save` writes,
    and `load` reads, the reference's JSON format.
    Thread-safe: group workers record concurrently.
    """

    def __init__(self, num_experts: int):
        self.num_experts = max(int(num_experts), 1)
        self._lock = threading.Lock()
        self._counts = np.zeros(self.num_experts, dtype=np.float64)  # guarded_by: _lock
        self._layer_counts: Dict[int, np.ndarray] = {}  # guarded_by: _lock

    def record(self, layer: int, expert_ids: Optional[np.ndarray] = None,
               *, counts: Optional[np.ndarray] = None):
        """Record one batch-layer's assignments, either raw expert ids
        (measured) or a per-expert count vector (expectation-weighted)."""
        if counts is None:
            ids = np.asarray(expert_ids, dtype=np.int64).reshape(-1)
            counts = np.bincount(ids, minlength=self.num_experts)
        counts = np.asarray(counts, dtype=np.float64)
        assert len(counts) == self.num_experts, \
            f"expected {self.num_experts} experts, got {len(counts)}"
        with self._lock:
            self._counts += counts
            lc = self._layer_counts.get(int(layer))
            if lc is None:
                self._layer_counts[int(layer)] = counts.copy()
            else:
                lc += counts

    @property
    def total(self) -> float:
        with self._lock:
            return float(self._counts.sum())

    def fractions(self, layer: Optional[int] = None) -> np.ndarray:
        """Measured per-expert token fractions (sum exactly 1; uniform prior
        before anything was recorded)."""
        with self._lock:
            c = self._layer_counts.get(int(layer)) if layer is not None \
                else self._counts
            c = None if c is None else c.copy()
        if c is None or c.sum() <= 0:
            return np.full(self.num_experts, 1.0 / self.num_experts)
        return c / c.sum()

    def fractions_tuple(self, layer: Optional[int] = None) -> Tuple[float, ...]:
        return tuple(float(x) for x in self.fractions(layer))

    def hot_experts(self, k: Optional[int] = None) -> np.ndarray:
        """Expert ids sorted hottest-first (stable)."""
        order = np.argsort(-self.fractions(), kind="stable")
        return order if k is None else order[:k]

    def resampled(self, n: int) -> Tuple[float, ...]:
        """Measured fractions fitted onto `n` experts — the bridge from a
        smoke-scale measured run to a production-scale simulator
        (`SimConfig.measured_fractions`).  A matching expert count returns
        the fractions VERBATIM (identities preserved — the hot expert stays
        the hot expert); a mismatch resamples the sorted popularity curve
        (identities are synthetic and get scattered by the consumer)."""
        if n == self.num_experts:
            return self.fractions_tuple()
        return tuple(float(x)
                     for x in resample_fractions(self.fractions_tuple(), n))

    # ------------------------------------------------------- persistence --
    def to_dict(self) -> dict:
        with self._lock:
            return {"num_experts": self.num_experts,
                    "counts": [float(x) for x in self._counts],
                    "layer_counts": {str(l): [float(x) for x in c]
                                     for l, c in self._layer_counts.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "RouterStatsCollector":
        c = cls(int(d["num_experts"]))
        c._counts = np.asarray(d["counts"], dtype=np.float64)
        c._layer_counts = {int(l): np.asarray(v, dtype=np.float64)
                           for l, v in d.get("layer_counts", {}).items()}
        return c

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    @classmethod
    def load(cls, path: str) -> "RouterStatsCollector":
        with open(path) as f:
            return cls.from_dict(json.load(f))


# ---------------------------------------------------------------------------
# The protocol
# ---------------------------------------------------------------------------


class ServingEngine(abc.ABC):
    """One request lifecycle over an ASAP runtime: submit timed requests,
    stream out-of-order completions, read measured routing stats, close."""

    # True for a backend in virtual time (SimEngine); the executor engine
    # runs against a wall/trace clock
    virtual = False

    @abc.abstractmethod
    def submit(self, request: Request,
               tokens: Optional[np.ndarray] = None) -> RequestHandle:
        """Register one request for admission at `request.arrival`.
        `tokens` (the prompt; synthesized when omitted) is consumed by
        backends that run real compute and ignored by analytical ones."""

    @abc.abstractmethod
    def poll(self) -> List[RequestResult]:
        """Completions since the last poll()/drain(), in COMPLETION order
        (out of order w.r.t. submission — the async-serving property)."""

    @abc.abstractmethod
    def drain(self, timeout: Optional[float] = None) -> List[RequestResult]:
        """Block until every submitted request completed; return the
        completions not yet handed out by poll()."""

    @abc.abstractmethod
    def stats(self) -> EngineStats:
        """Per-device utilization + measured per-expert routing fractions."""

    @abc.abstractmethod
    def close(self):
        """Release backend resources.  drain() first; in-flight work may be
        abandoned."""

    @abc.abstractmethod
    def _wait_handle(self, handle: RequestHandle, timeout: Optional[float]):
        """Backend-specific block until `handle` completes."""

    def submit_all(self, requests: Sequence[Request]) -> List[RequestHandle]:
        return [self.submit(r) for r in requests]

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# Simulator backend
# ---------------------------------------------------------------------------


class SimEngine(ServingEngine):
    """ServingEngine over the discrete-event simulators (virtual time).

    submit() injects the arrival event; poll()/drain() advance the event
    heap (`step()`), so completions stream out in simulated completion
    order.  Time is virtual: poll() returns instantly no matter how long the
    simulated horizon is, and `result()` on a handle fast-forwards the sim
    until that request completes.
    """

    virtual = True

    def __init__(self, cfg, sim: SimConfig,
                 asap_dep: Deployment = Deployment(D=4, T=4, E=16),
                 sync_dep: Deployment = Deployment(D=8, T=4, E=32)):
        self.cfg = cfg
        self.sim_cfg = sim
        self._sim = AsapSim(cfg, sim, asap_dep) if sim.mode == "asap" \
            else SyncSim(cfg, sim, sync_dep)
        self._sim.arm()
        # drop-detection horizon: the offline run_sim bound (duration*4+60)
        # plus an expected-decode-steps budget when the trace samples output
        # lengths — long-generation traces must not be mislabeled `timeout`
        # by a prefill-sized cutoff.  out_len_mean <= 1 reproduces the
        # run_sim bound exactly.
        self._horizon = drain_horizon(sim, self._sim.cm)
        self.router_stats = RouterStatsCollector(max(cfg.num_experts, 1))
        self._sim.router_hook = self._record_routing
        self._handles: Dict[int, RequestHandle] = {}
        self._emitted = 0  # index into the sim's completion list
        self._outbox: List[RequestResult] = []
        self._status_counts: Dict[str, int] = {}
        self._closed = False

    # ----------------------------------------------------------- plumbing --
    def _step(self) -> bool:
        """One event, bounded by the horizon (mirrors run_sim's cutoff)."""
        heap = self._sim._heap
        if heap and heap[0][0] > self._horizon:
            return False
        return self._sim.step()

    def _record_routing(self, tokens: float, lkey: int):
        """Expectation-weighted routing record: the sim routes no real
        tokens, so each batch-layer contributes tokens*top_k assignments
        split by the load model's per-expert fractions."""
        lm = self._sim.load_model
        counts = float(tokens) * lm.top_k * lm.expert_fractions(lkey)
        self.router_stats.record(lkey, counts=counts)

    def _normalized_decomp(self, r: Request) -> Dict[str, float]:
        d = dict(self._sim.decomp.get(r.rid, {}))
        ttft = r.ttft or 0.0
        if "non_kernel" in d:  # AsapSim: kernel / non_kernel (+ queue)
            queue = d.get("queue", 0.0)
            kernel = d.get("kernel", 0.0)
            return {"queue": queue, "kernel": kernel,
                    "comm": max(ttft - queue - kernel, 0.0)}
        # SyncSim: kernel / sync_wait / queuing already partition the TTFT
        return {"queue": d.get("queuing", 0.0),
                "kernel": d.get("kernel", 0.0),
                "sync_wait": d.get("sync_wait", 0.0)}

    def _drain_completions(self) -> List[RequestResult]:
        new = []
        done = self._sim.done
        while self._emitted < len(done):
            r = done[self._emitted]
            self._emitted += 1
            res = RequestResult(
                rid=r.rid, arrival=r.arrival, length=r.length,
                first_token_time=r.first_token_time,
                decomposition=self._normalized_decomp(r),
                batch_id=r.batch_id)
            h = self._handles.get(r.rid)
            if h is not None:
                h._fulfill(res)
            self._status_counts["ok"] = self._status_counts.get("ok", 0) + 1
            new.append(res)
        return new

    # ---------------------------------------------------------------- API --
    def submit(self, request: Request,
               tokens: Optional[np.ndarray] = None) -> RequestHandle:
        assert not self._closed, "submit() after close()"
        assert request.rid not in self._handles, f"duplicate rid {request.rid}"
        h = RequestHandle(self, request)
        self._handles[request.rid] = h
        self._sim.inject([request])
        return h

    def poll(self) -> List[RequestResult]:
        out, self._outbox = self._outbox, []
        out += self._drain_completions()
        while not out and self._step():
            out += self._drain_completions()
        return out

    def drain(self, timeout: Optional[float] = None) -> List[RequestResult]:
        """Advance virtual time until the heap empties or the horizon is
        reached.  Requests an overloaded config could not serve by the
        horizon do not strand their handles: they terminate with status
        "timeout" — drain() leaves every submitted request in a definite
        state on BOTH backends."""
        out, self._outbox = self._outbox, []
        while self._step():
            pass
        out += self._drain_completions()
        now = self._sim.now
        for rid, h in self._handles.items():
            if h._result is None:
                res = RequestResult(
                    rid=rid, arrival=h.arrival, length=h.length,
                    first_token_time=max(now, h.arrival),
                    decomposition={"queue": max(now - h.arrival, 0.0)},
                    status="timeout")
                h._fulfill(res)
                self._status_counts["timeout"] = \
                    self._status_counts.get("timeout", 0) + 1
                out.append(res)
        return out

    def _wait_handle(self, handle: RequestHandle, timeout: Optional[float]):
        while handle._result is None and self._step():
            self._outbox += self._drain_completions()
        if handle._result is None:
            raise TimeoutError(
                f"request {handle.rid} did not complete by the simulation "
                f"horizon ({self._horizon:.0f}s; now t={self._sim.now:.3f}s)")

    def take_kv(self, rid: int) -> KVHandle:
        """Export a completed request's prefill KV state.  The simulator's
        handle is ANALYTIC: no payload, byte/transfer accounting from the
        spec — the orchestrator charges the link's wire cost."""
        h = self._handles.get(rid)
        assert h is not None and h._result is not None, \
            f"take_kv({rid}) before the prefill completed"
        return KVHandle(rid=rid, prompt_len=h.length,
                        spec=KVSpec.from_config(self.cfg),
                        created_at=h._result.first_token_time)

    def stats(self) -> EngineStats:
        elapsed = max(self._sim.now, 1e-9)
        if isinstance(self._sim, AsapSim):
            util = self._sim.moe_dev_busy_time / elapsed
        else:
            util = self._sim.moe_rank_time / elapsed
        ctrl = getattr(self._sim, "controller", None)
        plans = ctrl.plans if ctrl is not None else []
        return EngineStats(
            engine=f"sim:{self.sim_cfg.mode}", elapsed=elapsed,
            submitted=self._sim.total_requests, completed=len(self._sim.done),
            expert_fractions=self.router_stats.fractions(),
            router_assignments=self.router_stats.total,
            moe_device_util=util,
            placement_policy=self._sim.load_model.placement.policy,
            migrations=len(plans),
            migrated_bytes=float(sum(p.total_bytes for p in plans)),
            statuses=dict(self._status_counts))

    def close(self):
        self._closed = True


# ---------------------------------------------------------------------------
# Real-executor backend
# ---------------------------------------------------------------------------


def _pad_bucket(n: int, floor: int = 8) -> int:
    """Next power-of-two sequence bucket -- keeps the set of batch shapes
    finite under online batching (same trick as the MoE capacity buckets)."""
    s = max(int(n), floor)
    return 1 << (s - 1).bit_length()


class ExecutorEngine(ServingEngine):
    """ServingEngine over the long-lived `DisaggregatedExecutor`.

    An admission thread replays `Request.arrival` against a `TraceClock`
    (speed-scalable trace seconds), feeds admitted requests through a
    `LengthAwareBatcher`, pads each emitted batch into a power-of-two token
    bucket, and submits it UN-pinned to the executor's shared job queue --
    whichever attention group frees a dual-batch slot first pulls it
    (least-loaded assignment).  Group workers call back on completion, out
    of order; the engine then decomposes TTFT (queue/kernel/comm/other, all
    in trace seconds), samples the first token from the returned hidden
    states (on the executor's device; the token id is the one value read
    back), and fulfills the per-request handles.  All measured router
    assignments land in `router_stats`.

    With `rebalance_interval` (trace seconds) the placement control plane
    ticks between polls: `_maybe_rebalance` runs on whichever thread calls
    poll(), drain() or a handle's result().

    Lock order (the reference's): `_rebalance_lock` -> the executor's
    `_swap_lock` (inside `apply_placement`) and `_rebalance_lock` -> `_lock`
    (the batcher's retarget).  The supervisor's `_on_failover` runs after
    its failover released `_swap_lock`, and takes `_rebalance_lock` before
    `_lock`.  Nothing takes `_rebalance_lock` while holding `_lock` or
    `_swap_lock`.
    """

    def __init__(self, executor: DisaggregatedExecutor, *,
                 clock: Optional[TraceClock] = None,
                 batcher: Optional[LengthAwareBatcher] = None,
                 sample_first_token: bool = True,
                 token_seed: int = 0,
                 rebalance_interval: Optional[float] = None,
                 rebalance_threshold: float = 1.05,
                 rebalance_policy: str = "one_shot_threshold",
                 rebalance_target: Optional[Placement] = None,
                 rebalance_release: Optional[float] = None,
                 rebalance_cooldown: int = 1,
                 rebalance_max_bytes: Optional[float] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 request_deadline: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 hedge_factor: Optional[float] = None,
                 keep_kv: bool = False):
        self.ex = executor
        self.cfg = executor.cfg
        # keep_kv retains each ok request's per-layer KV until the
        # orchestrator claims it via take_kv(); needs an emit_kv executor
        if keep_kv and not executor.emit_kv:
            raise ValueError("keep_kv=True requires "
                             "DisaggregatedExecutor(emit_kv=True)")
        self.keep_kv = keep_kv
        self.clock = clock if clock is not None else TraceClock()
        self.batcher = batcher if batcher is not None else LengthAwareBatcher(
            inflection=64, max_tokens=4096, exclusive_cutoff=1 << 30,
            max_wait=0.05)
        self.router_stats = RouterStatsCollector(max(self.cfg.num_experts, 1))
        self.sample_first_token = sample_first_token
        self._token_seed = token_seed
        # --- live placement control ---------------------------------------
        # The SAME PlacementController the simulator's rebalancer runs,
        # observing MEASURED windows here: per-device busy time from the
        # executor's clock accounting + per-expert fractions from
        # router_stats.  Plans execute through `apply_placement` between
        # polls -- quiesce, new resident stacks, atomic table swap.
        self.controller: Optional[PlacementController] = None
        self._rebalance_interval = rebalance_interval
        # created unconditionally: the supervisor's failover callback
        # (`_on_failover`) serializes against the rebalance tick through it
        self._rebalance_lock = threading.Lock()
        # (now, busy-time window, imbalance) of the window each plan came
        # from: what the controller saw when it fired
        self.rebalance_windows: List[Tuple[float, np.ndarray, float]] = []
        if rebalance_interval:
            target = rebalance_target if rebalance_target is not None \
                else executor.placement
            per_copy = executor.expert_copy_bytes
            self.controller = PlacementController(
                ep=executor.E, num_experts=max(self.cfg.num_experts, 1),
                layers=max(self.cfg.num_layers, 1), target=target,
                policy=rebalance_policy, threshold=rebalance_threshold,
                release_threshold=rebalance_release,
                cooldown_windows=rebalance_cooldown,
                max_bytes_per_window=rebalance_max_bytes,
                bytes_per_copy=per_copy,
                initial=executor.placement,
                initial_fractions=executor.expert_fractions)
            self._next_rebalance = float(rebalance_interval)  # guarded_by: _rebalance_lock
            self._busy_snapshot = executor.moe_busy.copy()  # guarded_by: _rebalance_lock
            self._base_inflection = self.batcher.inflection
            self._base_hot = float(executor.placement.device_fractions(
                executor.expert_fractions, executor.E).max())
        # --- fault tolerance / request lifecycle --------------------------
        self._fault_plan = fault_plan
        self.request_deadline = request_deadline  # trace s; None = none
        self.max_queue = max_queue  # batcher backlog at which arrivals shed
        self.hedge_factor = hedge_factor  # x EWMA service time; None = off
        # wire the engine into the executor
        executor.clock = self.clock.now
        executor.router_stats = self.router_stats
        executor.on_complete = self._on_job_done
        executor.on_failover = self._on_failover
        # admission state
        self._lock = threading.Lock()
        # _done_cv shares _lock: holding either means holding the same lock
        self._done_cv = threading.Condition(self._lock)
        self._arrivals: List[Tuple[float, int, Request]] = []  # heap  guarded_by: _lock
        self._seq = itertools.count()
        self._tokens: Dict[int, np.ndarray] = {}  # guarded_by: _lock
        self._handles: Dict[int, RequestHandle] = {}  # guarded_by: _lock
        self._outbox: List[RequestResult] = []  # guarded_by: _lock
        self._submitted = 0  # guarded_by: _lock
        self._finished = 0  # guarded_by: _lock
        self._draining = False  # guarded_by: _lock
        # request-lifecycle state: rids with a terminal result (dedup -- a
        # hedged twin's second completion is dropped), the terminal status
        # histogram, live batches eligible for hedging, the batch
        # service-time EWMA overdue-ness is judged against, and the hedge
        # accounting for stats()
        self._completed_rids: set = set()  # guarded_by: _lock
        self._status_counts: Dict[str, int] = {}  # guarded_by: _lock
        self._live_jobs: List[BatchJob] = []  # guarded_by: _lock
        self._svc_ewma: Optional[float] = None  # guarded_by: _lock
        self._hedges_issued = 0  # guarded_by: _lock
        self._hedge_wins = 0  # guarded_by: _lock
        # rid -> (k, v, ready): [L, len, kvh, hd] each, on the device
        self._kv: Dict[int, tuple] = {}  # guarded_by: _lock
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._admit_thread: Optional[threading.Thread] = None
        self._admit_error: Optional[BaseException] = None

    # ------------------------------------------------------------ intake --
    def start(self) -> "ExecutorEngine":
        """Anchor the trace clock and spawn the workers + admission loop."""
        assert not self._stop.is_set(), "engine reused after close()"
        if self._admit_thread is None:
            self.clock.start()
            if self._fault_plan is not None:
                # the trace clock is zero-based: plan times are trace seconds
                self.ex.arm_faults(self._fault_plan, t0=0.0)
            self.ex.ensure_started()
            self._admit_thread = threading.Thread(
                target=self._admit_loop, name="admission", daemon=True)
            self._admit_thread.start()
        return self

    def submit(self, request: Request,
               tokens: Optional[np.ndarray] = None) -> RequestHandle:
        self.start()
        if tokens is None:
            rng = np.random.RandomState(
                (self._token_seed * 1_000_003 + request.rid) % (1 << 31))
            tokens = rng.randint(0, self.cfg.vocab_size,
                                 size=request.length).astype(np.int32)
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        assert len(tokens) == request.length, \
            f"tokens ({len(tokens)}) != request.length ({request.length})"
        h = RequestHandle(self, request)
        with self._lock:
            assert request.rid not in self._handles, \
                f"duplicate rid {request.rid}"
            self._handles[request.rid] = h
            self._tokens[request.rid] = tokens
            heapq.heappush(self._arrivals,
                           (request.arrival, next(self._seq), request))
            self._submitted += 1
            self._draining = False
        self._wake.set()
        return h

    def _admit_loop(self):
        """Replay arrivals on the trace clock; admitted requests flow through
        the length-aware batcher and onto the executor's shared queue."""
        try:
            while not self._stop.is_set():
                now = self.clock.now()
                emitted: List[Batch] = []
                with self._lock:
                    while self._arrivals and self._arrivals[0][0] <= now:
                        _, _, req = heapq.heappop(self._arrivals)
                        if (self.max_queue is not None
                                and self.batcher.pending_count
                                >= self.max_queue):
                            # overload shedding at admission: a full queue
                            # rejects instead of queueing forever
                            self._finalize_locked(req.rid, req.arrival,
                                                  req.length, now, "shed")
                            continue
                        if (self.request_deadline is not None
                                and now - req.arrival
                                > self.request_deadline):
                            self._finalize_locked(req.rid, req.arrival,
                                                  req.length, now, "timeout")
                            continue
                        emitted += self.batcher.add(req, now)
                    if self.request_deadline is not None:
                        # expire requests that aged out INSIDE the batcher
                        # before any compute is spent on them
                        for req in self.batcher.expel(
                                lambda r: now - r.arrival
                                > self.request_deadline):
                            self._finalize_locked(req.rid, req.arrival,
                                                  req.length, now, "timeout")
                    emitted += self.batcher.poll(now)
                    if self._draining and not self._arrivals:
                        emitted += self.batcher.flush(now)
                    next_arrival = self._arrivals[0][0] \
                        if self._arrivals else None
                    flush_due = self.batcher.next_flush_due(now)
                for b in emitted:
                    self._launch(b)
                targets = [t for t in (next_arrival, flush_due)
                           if t is not None]
                if targets:
                    self.clock.sleep_until(min(targets), event=self._wake)
                else:
                    self._wake.wait(0.05)
                self._wake.clear()
        except BaseException as ex:
            self._admit_error = ex
            with self._done_cv:
                self._done_cv.notify_all()

    def _finalize_locked(self, rid: int, arrival: float, length: int,
                         now: float, status: str):
        """Mint a terminal non-ok result the engine decided on its own
        (shed at admission, deadline expiry, backend death).  Caller holds `_lock` -- which IS `_done_cv`'s
        lock, so the fulfill + notify happen inline without re-acquiring."""
        if rid in self._completed_rids:  # race-ok: caller holds _lock (documented contract)
            return
        self._completed_rids.add(rid)  # race-ok: caller holds _lock (documented contract)
        self._tokens.pop(rid, None)  # race-ok: caller holds _lock (documented contract)
        res = RequestResult(
            rid=rid, arrival=arrival, length=length,
            first_token_time=max(now, arrival),
            decomposition={"queue": max(now - arrival, 0.0)},
            status=status)
        self._outbox.append(res)  # race-ok: caller holds _lock (documented contract)
        h = self._handles.get(rid)  # race-ok: caller holds _lock (documented contract)
        if h is not None:
            h._fulfill(res)
        self._finished += 1  # race-ok: caller holds _lock (documented contract)
        self._status_counts[status] = self._status_counts.get(status, 0) + 1  # race-ok: caller holds _lock (documented contract)
        self._done_cv.notify_all()

    def _launch(self, batch: Batch):
        reqs = batch.requests
        # _tokens is written by submit() on caller threads; the admission
        # loop must not read it unlocked
        with self._lock:
            toks = [self._tokens.pop(r.rid) for r in reqs]
        S = _pad_bucket(max(len(t) for t in toks))
        arr = np.zeros((len(reqs), S), np.int32)
        for i, t in enumerate(toks):
            arr[i, :len(t)] = t  # zero-pad; causal attention keeps the
            # valid prefix exact, so row i's position len-1 is unaffected
        job = BatchJob(tokens=arr, bid=batch.bid,
                       lengths=[len(t) for t in toks], meta=reqs,
                       t_submitted=self.clock.now())
        for r in reqs:
            r.batch_id = batch.bid
        with self._lock:
            self._live_jobs.append(job)
        self.ex.submit_job(job)

    # ------------------------------------------------------- completions --
    def _on_job_done(self, job: BatchJob):
        """Runs in the completing group-worker thread (out of order), on
        that worker's stream.  Idempotent per request: with hedging both
        twins of a batch eventually complete -- the first one here wins each
        rid, the loser's copies are dropped, so handles fulfill exactly once
        and `_finished` counts every request exactly once."""
        reqs: List[Request] = job.meta or []
        if not reqs:
            return
        t_first = time.monotonic_ns() if SPANS.on else 0
        first = None
        if self.sample_first_token and job.result is not None:
            dev = job.result.device
            rows = torch.arange(len(reqs), device=dev)
            pos = torch.as_tensor(np.asarray(job.lengths, np.int64) - 1,
                                  device=dev)
            h_last = job.result[rows, pos]
            first = torch.argmax(lm_head(self.ex.params, h_last, self.cfg),
                                 -1)
            if first.is_cuda:
                _launch.note_host_sync()
            first = first.cpu().numpy()
        if t_first:
            SPANS.add("first_token", t_first, time.monotonic_ns(),
                      bid=job.bid)
        t_done = job.t_finished
        won_reqs: List[Request] = []
        with self._done_cv:
            self._live_jobs = [j for j in self._live_jobs if j is not job]
            if job.failed is None and job.t_submitted is not None \
                    and t_done is not None:
                svc = max(t_done - job.t_submitted, 0.0)
                self._svc_ewma = svc if self._svc_ewma is None \
                    else 0.8 * self._svc_ewma + 0.2 * svc
            if job.failed is not None and any(j.bid == job.bid
                                              for j in self._live_jobs):
                # this copy exhausted its retries but its hedged twin is
                # still running -- let the twin decide the terminal status
                self._done_cv.notify_all()
                return
            won = False
            for i, r in enumerate(reqs):
                if r.rid in self._completed_rids:
                    continue  # the hedged twin already finished this rid
                self._completed_rids.add(r.rid)
                won = True
                won_reqs.append(r)
                r.first_token_time = t_done
                ttft = max(t_done - r.arrival, 0.0)
                queue = min(max((job.t_started or t_done) - r.arrival, 0.0),
                            ttft)
                kernel = min(max(job.kernel_time, 0.0), ttft - queue)
                comm = min(max(job.comm_time, 0.0), ttft - queue - kernel)
                if job.failed is not None:
                    status = "failed"
                elif (self.request_deadline is not None
                      and ttft > self.request_deadline):
                    status = "timeout"  # served, but past its deadline
                else:
                    status = "ok"
                if self.keep_kv and job.kv is not None and status == "ok":
                    self._kv[r.rid] = job.kv[i]
                res = RequestResult(
                    rid=r.rid, arrival=r.arrival, length=r.length,
                    first_token_time=t_done,
                    decomposition={
                        "queue": queue, "kernel": kernel, "comm": comm,
                        "other": max(ttft - queue - kernel - comm, 0.0)},
                    batch_id=job.bid, group=job.group,
                    first_token=int(first[i]) if first is not None else None,
                    status=status, retries=job.retries)
                self._outbox.append(res)
                h = self._handles.get(res.rid)
                if h is not None:
                    h._fulfill(res)
                self._finished += 1
                self._status_counts[status] = \
                    self._status_counts.get(status, 0) + 1
            if job.is_hedge and won:
                self._hedge_wins += 1
            self._done_cv.notify_all()
        if t_first:
            self._request_spans(job, won_reqs)

    def _request_spans(self, job: BatchJob, reqs: List[Request]):
        """The admission thread's spans of a finished job: its wait for a
        group ("admission_wait"), and for each request it completed the
        "request" from its due time to its first token and, inside it, the
        "batcher_hold" until its batch was emitted.  With the job's
        "executor" span these tile the request; the first two sum to its
        "queue" share."""
        if job.t_submitted is None or job.t_started is None:
            return
        ns = self.clock.monotonic_ns
        tid = self._admit_thread.native_id \
            if self._admit_thread is not None else None
        t_sub, t_start = ns(job.t_submitted), ns(job.t_started)
        SPANS.add("admission_wait", t_sub, t_start, tid=tid, bid=job.bid,
                  g=job.group)
        if job.t_finished is None:
            return
        t_done = ns(job.t_finished)
        for r in reqs:
            t_due = ns(r.arrival)
            SPANS.add("request", t_due, t_done, tid=tid, rid=r.rid,
                      bid=job.bid)
            SPANS.add("batcher_hold", t_due, t_sub, tid=tid, rid=r.rid,
                      bid=job.bid)

    def _check_errors(self):
        if self._admit_error is not None:
            raise RuntimeError("admission thread failed") \
                from self._admit_error
        if self.ex.errors:
            raise RuntimeError("executor thread failed") from self.ex.errors[0]

    # --------------------------------------------------- fault tolerance --
    def _on_failover(self, device: int):
        """Supervisor callback after a failover evacuated `device` (runs on
        the supervisor thread, OUTSIDE the executor's `_swap_lock`).  Keeps
        the placement controller's view in sync with the degraded reality:
        without this, the next rebalance window would emit a plan that
        routes traffic back onto the dead device."""
        c = self.controller
        if c is None:
            return
        with self._rebalance_lock:
            c.sync(placement=self.ex.placement,
                   target=c.target.fail(device),
                   base=c.base.fail(device))
            hot = float(self.ex.placement.device_fractions(
                self.ex.expert_fractions, self.ex.E).max())
            with self._lock:
                self.batcher.retarget(
                    self._base_inflection * self._base_hot / max(hot, 1e-9))

    def _maybe_hedge(self):
        """Overdue-batch hedging: when a live batch has been out for more
        than `hedge_factor` x the EWMA batch service time, clone it
        un-pinned onto the shared queue.  Whichever copy completes first
        wins each request (`_on_job_done` dedups per rid); the loser's
        output is dropped, so hedging trades compute for tail latency
        without ever duplicating a completion."""
        if self.hedge_factor is None:
            return
        now = self.clock.now()
        clones: List[BatchJob] = []
        with self._lock:
            if self._svc_ewma is None:
                return  # no service-time baseline yet
            cutoff = self.hedge_factor * self._svc_ewma
            for j in self._live_jobs:
                if j.hedged or j.is_hedge or j.t_submitted is None:
                    continue
                if now - j.t_submitted <= cutoff:
                    continue
                j.hedged = True
                clone = BatchJob(tokens=j.tokens, bid=j.bid,
                                 lengths=list(j.lengths), meta=j.meta,
                                 t_submitted=now, is_hedge=True)
                self._live_jobs.append(clone)
                self._hedges_issued += 1
                clones.append(clone)
        for c in clones:
            self.ex.submit_job(c)

    def _fail_pending_locked(self) -> List[RequestResult]:
        """The backend died mid-run (panic or admission failure) and the
        caller is drain(): honor the lifecycle contract anyway.  Whatever
        completed keeps its result; every other submitted request ends
        `failed` right now.  poll() and handle.result() still RAISE on
        backend death -- drain() alone is the bookend that must terminate
        with definite states.  Caller holds `_lock`."""
        now = self.clock.now()
        for rid, h in list(self._handles.items()):  # race-ok: caller holds _lock (documented contract)
            self._finalize_locked(rid, h.arrival, h.length, now, "failed")
        out, self._outbox = self._outbox, []  # race-ok: caller holds _lock (documented contract)
        return out

    # ------------------------------------------------- placement control --
    def _maybe_rebalance(self):
        """Placement-control tick, run between polls: every
        `rebalance_interval` trace seconds, hand the controller the window's
        MEASURED observations (per-device busy time, per-expert routing
        fractions) and execute the MigrationPlan it emits -- quiesce the
        affected MoE devices, build their new resident stacks, swap the
        dispatch tables, and retarget the batcher's inflection for the new
        hot fraction."""
        c = self.controller
        if c is None or not c.active or self._stop.is_set():
            return
        if not self._rebalance_lock.acquire(blocking=False):
            return  # another caller's tick is mid-migration
        try:
            now = self.clock.now()
            if now < self._next_rebalance:
                return
            self._next_rebalance = now + float(self._rebalance_interval)
            window = self.ex.moe_busy - self._busy_snapshot
            self._busy_snapshot = self.ex.moe_busy.copy()
            frac = self.router_stats.fractions() \
                if self.router_stats.total > 0 else None
            plan = c.observe(WindowObservation(now=now, busy=window,
                                               fractions=frac))
            if plan is None:
                return
            self.rebalance_windows.append((now, window, c.imbalance(window)))
            try:
                self.ex.apply_placement(plan.placement,
                                        expert_fractions=c.fractions)
            except SwapAborted:
                # a worker died mid-quiesce: nothing was swapped, the
                # supervisor's failover runs next and `_on_failover` syncs
                # the controller; a later tick retries the plan
                c.sync(placement=self.ex.placement)
                return
            except BaseException:
                # the controller committed the plan when it emitted it; a
                # failed swap (quiesce timeout, dying worker) must roll its
                # view back to what the executor actually serves, so the
                # migration is retried instead of assumed installed
                c.sync(placement=self.ex.placement)
                raise
            # the hottest device's compute-bound knee moved: scale the
            # batching target by the hot-fraction ratio (the executor-side
            # analogue of the sim's moe_inflection_tokens re-derivation)
            hot = float(plan.placement.device_fractions(
                c.fractions, self.ex.E).max())
            with self._lock:
                self.batcher.retarget(
                    self._base_inflection * self._base_hot / max(hot, 1e-9))
        finally:
            self._rebalance_lock.release()

    # ---------------------------------------------------------------- API --
    def take_kv(self, rid: int) -> KVHandle:
        """Claim the completed prefill's KV cache for the decode handoff.
        Pops the retained tensors -- each handle is claimable exactly once;
        needs keep_kv=True and a completed ok prefill for `rid`."""
        with self._lock:
            kv = self._kv.pop(rid, None)
            h = self._handles.get(rid)
        if kv is None or h is None or h._result is None:
            raise KeyError(f"take_kv({rid}): no retained KV (keep_kv off, "
                           f"not ok, or already taken)")
        k, v, ready = kv
        return KVHandle(rid=rid, prompt_len=h.length,
                        spec=KVSpec.from_config(self.cfg),
                        created_at=h._result.first_token_time,
                        payload=(k, v), ready=ready)

    def poll(self) -> List[RequestResult]:
        self._check_errors()
        self._maybe_rebalance()
        self._maybe_hedge()
        with self._lock:
            out, self._outbox = self._outbox, []
        return out

    def drain(self, timeout: Optional[float] = None) -> List[RequestResult]:
        """Block (wall time) until every submitted request completed --
        including ones whose trace arrival is still in the future.  The
        placement-control loop keeps ticking while we wait."""
        self.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            self._draining = True
        self._wake.set()
        while True:
            # outside the lock: a migration quiesce must not stall
            # completion callbacks on _done_cv; hedging submits jobs
            self._maybe_rebalance()
            self._maybe_hedge()
            with self._done_cv:
                if self._admit_error is not None or self.ex.errors:
                    # mid-crash drain still terminates with every request
                    # in a definite state
                    return self._fail_pending_locked()
                if self._finished >= self._submitted:
                    out, self._outbox = self._outbox, []
                    return out
                wait = 0.1
                if deadline is not None:
                    wait = min(wait, deadline - time.monotonic())
                    if wait <= 0:
                        raise TimeoutError(
                            f"drain: {self._submitted - self._finished} of "
                            f"{self._submitted} requests still in flight")
                self._done_cv.wait(wait)

    def _wait_handle(self, handle: RequestHandle, timeout: Optional[float]):
        deadline = None if timeout is None else time.monotonic() + timeout
        # slice the wait so a dead worker/admission thread surfaces as an
        # error instead of deadlocking a timeout=None caller
        while not handle._event.wait(0.1):
            self._check_errors()
            self._maybe_rebalance()
            self._maybe_hedge()
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"request {handle.rid} still in flight")

    def stats(self) -> EngineStats:
        now = self.clock.now()
        t0 = self.ex._t_serving_start
        elapsed = max(now - t0, 1e-9) if t0 is not None else 1e-9
        with self._lock:
            submitted, finished = self._submitted, self._finished
            statuses = dict(self._status_counts)
            hedges, wins = self._hedges_issued, self._hedge_wins
        return EngineStats(
            engine="executor", elapsed=elapsed,
            submitted=submitted, completed=finished,
            expert_fractions=self.router_stats.fractions(),
            router_assignments=self.router_stats.total,
            moe_device_util=self.ex.moe_busy / elapsed,
            group_util=self.ex.group_busy / elapsed,
            placement_policy=self.ex.placement.policy,
            migrations=len(self.ex.migrations),
            migrated_bytes=self.ex.migrated_bytes,
            failovers=self.ex.failovers,
            statuses=statuses, hedges_issued=hedges, hedge_wins=wins,
            moe_launches=int(self.ex.moe_launches.sum()),
            moe_batch_regions=float(self.ex.moe_launch_regions.sum()),
            moe_batch_occupancy=float(
                self.ex.moe_launch_rows.sum()
                / max(self.ex.moe_launch_slots.sum(), 1.0)),
            bucket_hits=int(self.ex.bucket_hits.sum()),
            bucket_misses=int(self.ex.bucket_misses.sum()))

    def close(self):
        self._stop.set()
        self._wake.set()
        if self._admit_thread is not None:
            self._admit_thread.join(timeout=10)
            self._admit_thread = None
        self.ex.close()
        # unhook: the executor (and its resident weight stacks) must not stay
        # alive through a reference cycle with this engine
        self.ex.on_complete = None
