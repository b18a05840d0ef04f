"""Discrete-event simulation of MoE prefill serving at production scale.

Two engines over one hardware/cost model (core/cost_model.py; `hw`
defaults to the reference's preset `V5E`, so the outputs are those of the
reference's simulator -- a model, not a measurement of any card):

  AsapSim — the paper's system: disaggregated attention (D groups × T chips) +
    MoE stage modeled as E *individual* expert-parallel devices (§3.4.2): each
    device has its own region queue, polls dispatch regions out-of-order
    (arrival order, not layer/group order), and charges latency from the
    per-device expert-load model (ExpertLoadModel — uniform / Zipf-hot-expert /
    layer-correlated routing skew). Triple-stream comm/compute overlap and
    host-dispatch cost are applied per MoE device (§4.3). A batch's MoE layer
    completes when the LAST of the E devices drains its region, so expert-load
    stragglers lengthen the layer. Because each device serves its queue FIFO,
    the per-device clocks advance in virtual time (one vectorized numpy step +
    one event per batch-layer) — exact queueing semantics at one event per
    batch-layer. Barrier-free async pipeline; length-aware batching (inflection
    derived from the HOTTEST device under skew); dual-batch interleaving;
    layer-oblivious super kernel. Every mechanism is an ablation flag
    (Figs 16–18).

  SyncSim — synchronous baselines: `default` (token-count-balanced DP batching,
    global barrier per MoE layer — vLLM-like) and `chunked` (8k chunked
    prefill). Attention/MoE share the same chips (DP·T == EP geometry). The
    blocking all-to-all and the per-layer MoE step straddle the SLOWEST EP
    rank (not the mean), so routing skew widens the sync-vs-async gap.

Routing skew knob: `SimConfig.ep_skew` / `ep_skew_mode` (override) falling
back to `TraceConfig.ep_skew` / `ep_skew_mode` (workload-level default).
skew 0 == uniform routing and reproduces the aggregate-server model's
latencies exactly.

Expert placement & replication: `SimConfig.placement` selects the
expert→device Placement policy (core/cost_model.py) — `round_robin`,
`greedy_balanced` (LPT on expert popularity) or `replicated`
(`replicate_hot` hottest experts split across several hosts,
MegaScale-Infer-style).  With `rebalance_interval` set, AsapSim starts from
round-robin and hands each interval's per-device busy-time window to the
shared `PlacementController` (core/placement_control.py — the same
control plane that re-places experts LIVE in the real executor); the
controller's policy (`rebalance_policy`: one_shot_threshold / hysteresis /
partial / drift) decides when and what to migrate, and this engine executes
the emitted MigrationPlan — charging expert_bytes/ici_bw per moved expert
copy to the receiving device, invalidating the per-layer latency cache, and
re-deriving the batcher inflection from the new hot fraction.  The async pipeline never drains for this (no global barrier) — the cheap-
rebalance property of arXiv 2505.08944.

Failure injection, two flavors:
  * DP-group outage (`failure_group`, default): ASAP requeues only that
    group's batches from layer 0 with their kernel-time accounting reset
    (stale in-flight events are invalidated by a per-batch epoch counter);
    a synchronous engine loses the whole in-flight iteration (global
    barrier) — cancelled, requeued, re-run after the repair window.
  * MoE-device outage (`failure_moe_device`): the dead device's
    buffered regions are re-dispatched to the survivors that inherit its
    experts.  Experts with surviving replicas fail over instantly; orphaned
    experts are re-placed greedily on the least-loaded survivors, which pay
    the weight migration AND cannot serve their region queue before the
    repair window ends (`failure_at + failure_duration`).  The device itself
    stays dead.  In-flight batch-layers keep their originally scheduled
    combine events (expectation-level approximation); the lost backlog is
    conserved by pushing the inheriting survivors' queue clocks.  SyncSim
    freezes for the repair window (global barrier) and afterwards straddles
    the DEGRADED slowest rank forever.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cost_model import (CostModel, Deployment,
                                         ExpertLoadModel, Hardware, Placement,
                                         V5E)
from repro_torch.core.faults import FaultPlan
from repro_torch.core.placement_control import (MigrationPlan,
                                                PlacementController,
                                                WindowObservation)
from repro_torch.core.scheduler import (Batch, LengthAwareBatcher,
                                        balanced_partition)
from repro_torch.core.trace import Request, TraceConfig, generate_requests
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass
class SimConfig:
    mode: str = "asap"  # asap | default | chunked
    rps: float = 4.0
    duration: float = 60.0
    slo: float = 5.0
    trace: TraceConfig = dataclasses.field(default_factory=TraceConfig)
    # ASAP ablations (paper §5.5)
    interleave: bool = True
    overlap: bool = True
    super_kernel: bool = True
    # expert-parallel routing skew (None -> fall back to trace.ep_skew*)
    ep_skew: Optional[float] = None  # Zipf exponent; 0 == uniform
    ep_skew_mode: Optional[str] = None  # uniform | zipf | layer
    # MEASURED per-expert token fractions from a live run: overrides the synthetic Zipf knob when set — the load model
    # runs in "measured" mode on this vector (resampled onto the model's
    # expert count when the lengths differ).
    measured_fractions: Optional[Tuple[float, ...]] = None
    # expert placement / hot-expert replication / online rebalancing
    placement: str = "round_robin"  # round_robin|greedy_balanced|replicated(k)
    replicate_hot: int = 0  # top-k hottest experts replicated (forces policy)
    rebalance_interval: Optional[float] = None  # s; None = static placement
    rebalance_threshold: float = 1.05  # observed busy max/mean that triggers
    # placement-control policy family (core/placement_control.py)
    rebalance_policy: str = "one_shot_threshold"
    rebalance_release: Optional[float] = None  # hysteresis revert threshold
    rebalance_cooldown: int = 1  # min windows between migrations (hysteresis)
    rebalance_max_bytes: Optional[float] = None  # per-window cap (partial)
    # ChunkedPrefill
    chunk: int = 8192
    # failure injection
    failure_at: Optional[float] = None
    failure_duration: float = 5.0
    failure_group: int = 0
    failure_moe_device: Optional[int] = None  # kill an MoE device instead
    # shared deterministic fault schedule (core/faults.py): the
    # SAME FaultPlan the real executor consumes.  The legacy flag triple
    # above is one interpretation of it (`FaultPlan.from_flags`); setting
    # both is ambiguous and `resolved_fault_plan` raises.
    fault_plan: Optional[FaultPlan] = None

    def resolved_fault_plan(self) -> Optional[FaultPlan]:
        """Effective MoE-device fault schedule: `fault_plan` wins; the
        legacy `failure_at/failure_duration/failure_moe_device` triple
        becomes a single-crash plan.  Returns None when only the DP-group
        failure path (`failure_at` without a MoE device) is in play."""
        if self.fault_plan is not None:
            if self.failure_moe_device is not None:
                raise ValueError(
                    "set either fault_plan or failure_moe_device, not both")
            return self.fault_plan
        return FaultPlan.from_flags(self.failure_at, self.failure_duration,
                                    self.failure_moe_device)

    def resolved_skew(self) -> Tuple[str, float]:
        """Effective (mode, alpha): SimConfig overrides TraceConfig; a
        measured-fractions vector overrides both (alpha unused)."""
        if self.measured_fractions is not None:
            return "measured", 0.0
        alpha = self.ep_skew if self.ep_skew is not None else self.trace.ep_skew
        mode = self.ep_skew_mode if self.ep_skew_mode is not None \
            else self.trace.ep_skew_mode
        if alpha <= 0.0:
            mode = "uniform"
        return mode, float(alpha)

    def resolved_placement(self) -> Placement:
        """Effective Placement: `replicate_hot > 0` promotes the DEFAULT
        round-robin policy to `replicated`, so `--replicate-hot 2` alone
        means replicated(2).  Combining it with an explicitly different
        policy is a conflict and raises rather than silently rewriting."""
        pl = Placement.parse(self.placement, self.replicate_hot)
        if self.replicate_hot > 0 and pl.policy != "replicated":
            if pl.policy != "round_robin":
                raise ValueError(
                    f"replicate_hot={self.replicate_hot} conflicts with "
                    f"placement={self.placement!r} (replication implies the "
                    f"'replicated' policy)")
            pl = dataclasses.replace(pl, policy="replicated",
                                     replicate_hot=int(self.replicate_hot))
        return pl


@dataclasses.dataclass
class SimResult:
    requests: List[Request]
    decomposition: Dict[int, Dict[str, float]]  # rid -> component seconds
    total_requests: int = 0
    # per-MoE-device stage stats (None when the engine does not model them)
    moe_device_util: Optional[np.ndarray] = None  # busy fraction per device
    moe_device_mean_qdepth: Optional[np.ndarray] = None  # time-avg region queue
    moe_device_peak_qdepth: Optional[np.ndarray] = None

    @property
    def ttfts(self) -> np.ndarray:
        return np.array([r.ttft for r in self.requests if r.ttft is not None])

    @property
    def mean_ttft(self) -> float:
        t = self.ttfts
        return float(t.mean()) if len(t) else float("inf")

    @property
    def p99_ttft(self) -> float:
        t = self.ttfts
        return float(np.percentile(t, 99)) if len(t) else float("inf")

    def completed_fraction(self, total: Optional[int] = None) -> float:
        return len(self.ttfts) / max(total or self.total_requests, 1)

    def moe_imbalance(self) -> float:
        """max/mean per-device utilization — 1.0 means perfectly balanced."""
        u = self.moe_device_util
        if u is None or not len(u) or u.mean() <= 0:
            return 1.0
        return float(u.max() / u.mean())


# ---------------------------------------------------------------------------
# Event engine base
# ---------------------------------------------------------------------------


class _Engine:
    def __init__(self):
        self._heap: List[Tuple[float, int, Callable]] = []
        self._ctr = itertools.count()
        self.now = 0.0

    def at(self, t: float, fn: Callable):
        heapq.heappush(self._heap, (t, next(self._ctr), fn))

    def step(self) -> bool:
        """Pop and execute ONE event; False when the heap is empty.  The
        incremental drive the SimEngine uses to stream completions out of a
        batch-oriented simulation (virtual time advances event by event)."""
        if not self._heap:
            return False
        t, _, fn = heapq.heappop(self._heap)
        self.now = max(self.now, t)  # events injected late never rewind time
        fn()
        return True

    def run(self, horizon: float):
        while self._heap:
            t, _, fn = heapq.heappop(self._heap)
            if t > horizon:
                break
            self.now = t
            fn()


# ---------------------------------------------------------------------------
# ASAP async engine
# ---------------------------------------------------------------------------


class _BatchState:
    __slots__ = ("batch", "layer", "group", "kernel_time", "t_enqueued",
                 "t_started", "_phase", "epoch")

    def __init__(self, batch: Batch):
        self.batch = batch
        self.layer = 0
        self.group: Optional[int] = None
        self.kernel_time = 0.0
        self.t_enqueued = 0.0
        self.t_started: Optional[float] = None
        self._phase = "wait_attn"
        # Generation counter: bumped whenever the batch is reset (failure
        # requeue). Every scheduled event captures the epoch at schedule time
        # and is dropped on fire if the batch has since been reset — a stale
        # _attn_done/_moe_*/_combined can no longer advance a victim batch
        # that is simultaneously sitting in `pending`.
        self.epoch = 0


class AsapSim(_Engine):
    def __init__(self, cfg: ModelConfig, sim: SimConfig,
                 dep: Deployment = Deployment(), hw: Hardware = V5E):
        super().__init__()
        self.cfg, self.sim, self.dep = cfg, sim, dep
        self.cm = CostModel(cfg, hw, dep)
        mode, alpha = sim.resolved_skew()
        # With a rebalance interval the system boots on the cold round-robin
        # placement and the online rebalancer migrates toward the target once
        # it observes imbalance; otherwise the target is static from t=0.
        self._placement_target = sim.resolved_placement()
        initial = Placement() if sim.rebalance_interval \
            else self._placement_target
        self.load_model = ExpertLoadModel(
            num_experts=max(cfg.num_experts, 1), top_k=max(cfg.top_k, 1),
            ep=dep.E, mode=mode, alpha=alpha, seed=sim.trace.seed,
            placement=initial, measured=sim.measured_fractions)
        if initial != Placement():
            self.cm = dataclasses.replace(
                self.cm, copies_override=self.load_model.expected_copies())
        # Placement control plane: the measure→decide half of the
        # online rebalancer lives in the backend-agnostic controller; this
        # engine only observes busy-time windows and EXECUTES the plans
        # (charging migration to the receivers' queue clocks).
        self.controller: Optional[PlacementController] = None
        if sim.rebalance_interval:
            self.controller = PlacementController(
                ep=dep.E, num_experts=max(cfg.num_experts, 1),
                layers=max(cfg.num_layers, 1),
                target=self._placement_target,
                policy=sim.rebalance_policy,
                threshold=sim.rebalance_threshold,
                release_threshold=sim.rebalance_release,
                cooldown_windows=sim.rebalance_cooldown,
                max_bytes_per_window=sim.rebalance_max_bytes,
                bytes_per_copy=self.cm.expert_bytes(),
                initial=initial,
                table_fn=self._controller_tables)
        self.batcher = LengthAwareBatcher(
            inflection=self.cm.moe_inflection_tokens(
                self.load_model.hot_fraction()),
            max_tokens=dep.max_batch_tokens)
        self.pending: deque[_BatchState] = deque()
        # group state
        self.g_active: List[List[_BatchState]] = [[] for _ in range(dep.D)]
        self.g_busy: List[bool] = [False] * dep.D
        self.g_alive: List[bool] = [True] * dep.D
        # Per-MoE-device state. Each device serves its region queue FIFO, so
        # the queues are modeled EXACTLY in virtual time: `moe_dev_free[d]` is
        # when device d drains everything currently buffered for it, and a
        # batch-layer needs only ONE completion event (at the slowest
        # device's finish time) instead of E per-device events — the numpy
        # vectorization that makes slo_throughput's bisection loop fast.
        self.ep = dep.E
        self.moe_dev_free = np.zeros(self.ep)
        self.moe_dev_busy_time = np.zeros(self.ep)
        self._busy_snapshot = np.zeros(self.ep)  # rebalance-window baseline
        # dead MoE devices do no work at all — not even the shared-expert
        # share moe_device_latency charges to every device (that 1/E of
        # shared compute is dropped, a small optimism documented in
        # _fail_moe); mask applied when the latency cache is (re)filled.
        self._moe_alive = np.ones(self.ep)
        self._moe_backlog: deque = deque()  # per-job end-time vectors (stats)
        self._q_area = np.zeros(self.ep)  # ∫ waiting-region count dt
        self._q_peak = np.zeros(self.ep, dtype=np.int64)
        # (tokens, layer-key) -> (max base latency, per-device drain latency
        # vector); batches repeat the same token count across all layers, so
        # this collapses the per-event cost-model math to a dict hit
        self._moe_lat_cache: Dict[Tuple[int, int],
                                  Tuple[float, np.ndarray]] = {}
        self.done: List[Request] = []
        self.decomp: Dict[int, Dict[str, float]] = {}
        self.total_requests = 0
        self._armed = False
        # router-statistics hook: callable(tokens, lkey) invoked
        # once per batch-layer the MoE stage serves — the SimEngine feeds a
        # RouterStatsCollector with the load model's per-expert fractions so
        # sim and executor expose the same measured-stats surface.
        self.router_hook: Optional[Callable] = None

    # --------------------------------------------------------------- intake
    def arm(self):
        """Schedule the non-request events (failure injection, rebalancer
        ticks) exactly once.  Split out of start() so the SimEngine can drive
        submissions itself: arm() + inject() == start()."""
        if self._armed:
            return self
        self._armed = True
        plan = self.sim.resolved_fault_plan()
        if plan is not None:
            plan.validate(self.ep)
            for ev in plan.events:
                # crash -> permanent device failure + evacuation; every
                # non-fatal kind (stall/drop/delay) -> a device-time stall
                # of `duration` (the analytical analogue of a wedged worker
                # or a retransmitted payload)
                if ev.kind == "crash_moe":
                    self.at(ev.t, lambda ev=ev: self._fail_moe(
                        ev.device, ev.duration))
                else:
                    self.at(ev.t, lambda ev=ev: self._stall_moe(
                        ev.device, ev.duration))
        elif self.sim.failure_at is not None:
            self.at(self.sim.failure_at, self._fail)
            self.at(self.sim.failure_at + self.sim.failure_duration,
                    self._repair)
        if self.sim.rebalance_interval:
            self.at(self.sim.rebalance_interval, self._rebalance)
        return self

    def inject(self, reqs: List[Request]):
        """Schedule externally supplied requests (engine submissions).  An
        arrival in the virtual past is admitted 'now' — time never rewinds."""
        self.total_requests += len(reqs)
        for r in reqs:
            self.at(max(r.arrival, self.now), lambda r=r: self._arrive(r))

    def start(self):
        self.arm()
        self.inject(generate_requests(self.sim.rps, self.sim.duration,
                                      self.sim.trace))
        return self

    def _arrive(self, r: Request):
        for b in self.batcher.add(r, self.now):
            self._enqueue(b)
        # age-based flush check
        self.at(self.now + self.batcher.max_wait * 1.01, self._poll)

    def _poll(self):
        for b in self.batcher.poll(self.now):
            self._enqueue(b)

    def _enqueue(self, b: Batch):
        st = _BatchState(b)
        st.t_enqueued = self.now
        self.pending.append(st)
        self._assign()

    # ----------------------------------------------------------- scheduling
    def _capacity(self, g: int) -> int:
        if not self.g_alive[g]:
            return 0
        cap = 2 if self.sim.interleave else 1
        if any(s.batch.exclusive for s in self.g_active[g]):
            return 0
        return cap - len(self.g_active[g])

    def _assign(self):
        progress = True
        while self.pending and progress:
            progress = False
            st = self.pending[0]
            need_empty = st.batch.exclusive
            for g in range(self.dep.D):
                if need_empty and (self.g_active[g] or not self.g_alive[g]):
                    continue
                if not need_empty and self._capacity(g) <= 0:
                    continue
                self.pending.popleft()
                st.group = g
                if st.t_started is None:
                    st.t_started = self.now
                self.g_active[g].append(st)
                self._try_attn(g)
                progress = True
                break

    # ------------------------------------------------------------ attention
    def _try_attn(self, g: int):
        if self.g_busy[g] or not self.g_alive[g]:
            return
        ready = [s for s in self.g_active[g] if s.layer >= 0 and
                 getattr(s, "_phase", "wait_attn") == "wait_attn"]
        if not ready:
            return
        st = min(ready, key=lambda s: s.layer)
        st._phase = "in_attn"
        # attention-side dispatch send is always serial on the main stream
        # (triple-stream deployed on MoE devices only, paper §4.3)
        lat = self.cm.attention_layer_latency(st.batch.seq_lens) \
            + self.cm.dispatch_send_occupancy(st.batch.total_tokens)
        st.kernel_time += lat
        self.g_busy[g] = True
        self.at(self.now + lat,
                lambda st=st, g=g, e=st.epoch: self._attn_done(st, g, e))

    def _attn_done(self, st: _BatchState, g: int, epoch: int):
        if epoch != st.epoch:
            return  # stale: batch was reset by a failure after scheduling
        self.g_busy[g] = False
        st._phase = "dispatch"
        self._try_attn(g)
        self.at(self.now + self.cm.hw.hop_latency,
                lambda st=st, e=epoch: self._moe_arrive(st, e))

    # ------------------------------------------------------------------ moe
    def _moe_arrive(self, st: _BatchState, epoch: int):
        """Batch tokens land in the shared buffer: one dispatch region per MoE
        device. Every device drains its FIFO region queue independently
        (out-of-order w.r.t. layer/group ids — arrival order); the layer's
        combine fires when the LAST device finishes its region. Per-device
        drain latencies and queue clocks advance in one vectorized numpy step
        per batch-layer, not per device event.

        A region buffered for a batch that is later reset by a failure is
        still drained (the MoE devices cannot know the attention group died);
        the completion event is dropped via the epoch guard."""
        if epoch != st.epoch:
            return
        tokens = st.batch.total_tokens
        lkey = st.layer if self.load_model.mode == "zipf" else 0
        if self.router_hook is not None:
            self.router_hook(tokens, lkey)
        cached = self._moe_lat_cache.get((tokens, lkey))
        if cached is None:
            loads = self.load_model.device_loads(tokens, lkey)
            hits = self.load_model.device_experts_hit(tokens, lkey)
            base = self.cm.moe_device_latency(loads, hits, tokens)
            lats = base
            if not self.sim.super_kernel:
                # out-of-order layer id -> kernels cannot be pre-launched
                # (§3.4.2); every device pays the host dispatch per region
                lats = lats + self.cm.hw.host_dispatch
            if not self.sim.overlap:
                # no comm streams: recv-migrate + combine-send run on each
                # device's main stream (moe_comm_occupancy is per-device share)
                lats = lats + self.cm.moe_comm_occupancy(tokens)
            if not self._moe_alive.all():
                base = base * self._moe_alive
                lats = lats * self._moe_alive
            cached = (float(np.max(base)), lats)
            self._moe_lat_cache[(tokens, lkey)] = cached
        base_max, lats = cached
        st.kernel_time += base_max
        starts = np.maximum(self.moe_dev_free, self.now)
        ends = starts + lats
        self.moe_dev_free = ends
        self.moe_dev_busy_time += lats
        # stats: each region waits (start - now) in its device's queue, which
        # integrates to the time-weighted waiting-region count
        self._q_area += starts - self.now
        bl = self._moe_backlog
        while bl and float(bl[0].max()) <= self.now:
            bl.popleft()
        # the snapshot INCLUDES the region that just arrived (taken before
        # the append it under-counts peak depth by one — a device that was
        # never doubly backlogged would report peak 0)
        bl.append(ends)
        depth = (np.vstack(bl) > self.now).sum(axis=0)
        np.maximum(self._q_peak, depth, out=self._q_peak)
        c = self.cm.combine_wire_latency(tokens)
        self.at(float(ends.max()) + c,
                lambda st=st, e=epoch: self._combined(st, e))

    def _combined(self, st: _BatchState, epoch: int):
        if epoch != st.epoch:
            return
        st.layer += 1
        if st.layer >= self.cfg.num_layers:
            self._complete(st)
            return
        st._phase = "wait_attn"
        if st.group is not None:
            self._try_attn(st.group)

    def _complete(self, st: _BatchState):
        g = st.group
        if g is not None and st in self.g_active[g]:
            self.g_active[g].remove(st)
        for r in st.batch.requests:
            r.first_token_time = self.now
            self.done.append(r)
            non_kernel = max((r.ttft or 0.0) - st.kernel_time, 0.0)
            started = st.t_started if st.t_started is not None else r.arrival
            self.decomp[r.rid] = {
                "kernel": st.kernel_time,
                "non_kernel": non_kernel,
                # admission wait (a component OF non_kernel, reported
                # separately for the engine's RequestResult decomposition)
                "queue": min(max(started - r.arrival, 0.0), non_kernel),
            }
        self._assign()
        if g is not None:
            self._try_attn(g)

    # ---------------------------------------------------- placement dynamics
    def _placement_migration(self, old_lm: ExpertLoadModel,
                             new_lm: ExpertLoadModel) -> np.ndarray:
        """Per-device weight-migration seconds for a placement switch: every
        (expert, device) copy present in the new placement but not the old
        must be shipped over ICI (expert_bytes / ici_bw per expert per MoE
        layer — each layer owns its own expert weights); receivers pay."""
        per = self.cm.expert_bytes() / self.cm.hw.ici_bw
        L = max(self.cfg.num_layers, 1)
        # zipf mode has a distinct table per layer; other modes share one
        lkeys, scale = (range(L), 1) if old_lm.mode == "zipf" else ((0,), L)
        mig = np.zeros(self.ep)
        for l in lkeys:
            told = old_lm.placement_table(l)
            tnew = new_lm.placement_table(l)
            for e, hosts in enumerate(tnew):
                old_hosts = told[e]
                for d in hosts:
                    if d not in old_hosts:
                        mig[d] += per * scale
        return mig

    def _switch_placement(self, placement: Placement,
                          stall_until: Optional[float] = None,
                          mig: Optional[np.ndarray] = None) -> np.ndarray:
        """Swap the live placement: charge weight migration to the receiving
        devices' queue clocks, invalidate the per-layer latency cache, and
        re-derive the batcher inflection from the new hot fraction.  With
        `stall_until` set (MoE-device failure), receivers of re-placed
        weights additionally cannot serve their region queue before the
        repair window ends.  `mig` (per-device migration seconds) comes from
        a controller MigrationPlan when one drives the switch; the failure
        path computes it directly."""
        old = self.load_model
        new = dataclasses.replace(old, placement=placement)
        if mig is None:
            mig = self._placement_migration(old, new)
        self.load_model = new
        self._moe_lat_cache.clear()
        # non-default placements need the measured dispatch fan-out; a revert
        # to the round-robin default (hysteresis release) must RESTORE the
        # closed-form copies, not keep the replicated fan-out
        self.cm = dataclasses.replace(
            self.cm, copies_override=new.expected_copies()
            if placement != Placement() else None)
        self.batcher.retarget(
            self.cm.moe_inflection_tokens(new.hot_fraction()))
        free = np.maximum(self.moe_dev_free, self.now)
        if stall_until is not None:
            free = np.where(mig > 0, np.maximum(free, stall_until), free)
        self.moe_dev_free = free + mig
        self.moe_dev_busy_time += mig  # migration occupies the device
        return mig

    def _controller_tables(self, placement: Placement, fractions):
        """Per-lkey placement tables for the controller's plan diffs, built
        from the CURRENT load model (zipf mode keeps one table per layer —
        per-layer migration accounting).  `fractions` is ignored:
        the sim's popularity is the load model's, not a measured window."""
        lm = dataclasses.replace(self.load_model, placement=placement)
        L = max(self.cfg.num_layers, 1)
        lkeys = range(L) if lm.mode == "zipf" else (0,)
        return {l: lm.placement_table(l) for l in lkeys}

    def _apply_plan(self, plan: MigrationPlan):
        """Execute a controller MigrationPlan: charge each moved expert copy
        (expert_bytes over ICI, receivers pay) to the device queue clocks and
        install the plan's placement — barrier-free, nothing drains."""
        per = self.cm.expert_bytes() / self.cm.hw.ici_bw
        self._switch_placement(plan.placement,
                               mig=plan.device_cost(per, self.ep))

    def _rebalance(self):
        """Online rebalancer tick: hand the window's per-device busy time to
        the PlacementController (the decision is a pluggable policy) and execute
        whatever MigrationPlan it emits.  Barrier-free: nothing drains while
        weights move — only the receiving devices' queue clocks are pushed."""
        window = self.moe_dev_busy_time - self._busy_snapshot
        self._busy_snapshot = self.moe_dev_busy_time.copy()
        plan = self.controller.observe(WindowObservation(
            now=self.now, busy=window,
            fractions=self.load_model.expert_fractions(0)))
        if plan is not None:
            self._apply_plan(plan)
        # keep ticking through the whole drain tail (the backlog above the
        # knee is where migrating pays off most) — but stop once the policy
        # has nothing further to say or once every request completed, so an
        # idle recurring event never pins the heap and inflates the
        # utilization denominator
        if self.controller.active and len(self.done) < self.total_requests:
            self.at(self.now + self.sim.rebalance_interval, self._rebalance)

    # -------------------------------------------------------------- failure
    def _fail(self):
        g = self.sim.failure_group
        self.g_alive[g] = False
        self.g_busy[g] = False  # in-flight attention is lost with the group
        victims = self.g_active[g]
        self.g_active[g] = []
        # reversed so the OLDEST victim ends up at the head of `pending`
        for st in reversed(victims):  # restart from layer 0 (state lost)
            st.epoch += 1  # invalidate every in-flight event for this batch
            st.layer = 0
            st.group = None
            st._phase = "wait_attn"
            # the lost run's kernel seconds are NOT kernel work of the final
            # run (counted twice they would inflate the TTFT decomposition
            # and clamp non_kernel to 0) — they reappear in
            # non_kernel, which is where failure overhead belongs.
            # st.t_started intentionally KEEPS the first dispatch time: it
            # records when the batch first reached a group, not the start of
            # the run that eventually completed.
            st.kernel_time = 0.0
            self.pending.appendleft(st)
        self._assign()

    def _fail_moe(self, d: Optional[int] = None,
                  duration: Optional[float] = None):
        """Kill one MoE device.  Experts with surviving replicas
        fail over instantly; orphaned experts are re-placed on the least-
        loaded survivors, which pay the weight migration and stall until the
        repair window ends.  The dead device's buffered regions are
        re-dispatched to the survivors that inherit its traffic share.
        Defaults reproduce the legacy `failure_moe_device` config path
        bit-exactly; a FaultPlan crash event passes explicit args."""
        d = int(self.sim.failure_moe_device) if d is None else int(d)
        duration = self.sim.failure_duration if duration is None \
            else float(duration)
        repair_end = self.now + duration
        self._placement_target = self._placement_target.fail(d)
        self._moe_alive[d] = 0.0
        old_frac = self.load_model.device_fractions(0).copy()
        backlog = float(max(self.moe_dev_free[d] - self.now, 0.0))
        self._switch_placement(self.load_model.placement.fail(d),
                               stall_until=repair_end)
        if self.controller is not None:
            # the failure re-placed experts without consulting the control
            # plane; realign its view of installed/target/boot placement
            # (the hysteresis release layout must exclude the dead device)
            self.controller.sync(placement=self.load_model.placement,
                                 target=self._placement_target,
                                 base=self.controller.base.fail(d))
        # re-dispatch the dead device's queued regions to its inheritors,
        # pro-rated by the share of its traffic each one absorbs; the busy
        # time charged (at arrival) to the dead device for work it will
        # never finish moves with the regions
        gain = np.clip(self.load_model.device_fractions(0) - old_frac,
                       0.0, None)
        gain[d] = 0.0
        if backlog > 0 and gain.sum() > 0:
            share = backlog * gain / gain.sum()
            self.moe_dev_free += share
            self.moe_dev_busy_time += share
            self.moe_dev_busy_time[d] = max(
                self.moe_dev_busy_time[d] - backlog, 0.0)
        self.moe_dev_free[d] = self.now  # hosts nothing from here on

    def _stall_moe(self, d: int, duration: float):
        """Non-fatal device fault (FaultPlan stall_moe/drop_*/delay_wake):
        device `d` serves nothing for `duration` device-seconds.  Queued and
        future regions are served LATE, not lost — throughput dips and
        recovers with no placement change, which is exactly the asymmetry
        vs. `_fail_moe` the executor's supervisor mirrors (stalls detected
        past `stall_timeout` escalate to failover there; short ones just
        ride out).  Busy time is NOT accrued: a wedged device does no
        work."""
        d = int(d)
        self.moe_dev_free[d] = max(float(self.moe_dev_free[d]), self.now) \
            + float(duration)

    def _repair(self):
        self.g_alive[self.sim.failure_group] = True
        self._assign()
        self._try_attn(self.sim.failure_group)

    # ------------------------------------------------------------------ run
    def simulate(self) -> SimResult:
        self.start()
        self.run(horizon=self.sim.duration * 4 + 60.0)
        elapsed = max(self.now, 1e-9)
        return SimResult(
            self.done, self.decomp, self.total_requests,
            moe_device_util=self.moe_dev_busy_time / elapsed,
            moe_device_mean_qdepth=self._q_area / elapsed,
            moe_device_peak_qdepth=self._q_peak.copy())


# ---------------------------------------------------------------------------
# Synchronous baselines
# ---------------------------------------------------------------------------


class SyncSim(_Engine):
    """`default` and `chunked` modes. Attention DP and EP share the chips
    (e.g. D=8, T=4, EP=32 on 32 chips — DeepSeek-V3 prefill geometry).

    The per-layer MoE step and the blocking all-to-all both straddle the
    SLOWEST EP rank: with routing skew the iteration is gated by the hottest
    device, which is exactly the straggler effect the async engine sidesteps.
    """

    def __init__(self, cfg: ModelConfig, sim: SimConfig,
                 dep: Deployment = Deployment(D=8, T=4, E=32), hw: Hardware = V5E):
        super().__init__()
        self.cfg, self.sim, self.dep = cfg, sim, dep
        self.cm = CostModel(cfg, hw, dep)
        mode, alpha = sim.resolved_skew()
        # Static placement only: an online rebalancer would have to drain the
        # global barrier first, exactly the cost the async engine avoids.
        self.load_model = ExpertLoadModel(
            num_experts=max(cfg.num_experts, 1), top_k=max(cfg.top_k, 1),
            ep=dep.E, mode=mode, alpha=alpha, seed=sim.trace.seed,
            placement=sim.resolved_placement(),
            measured=sim.measured_fractions)
        if self.load_model.placement != Placement():
            self.cm = dataclasses.replace(
                self.cm, copies_override=self.load_model.expected_copies())
        self.queue: deque[Request] = deque()
        self.chunk_progress: Dict[int, int] = {}  # rid -> tokens prefilled
        self.engine_busy = False
        self.frozen_until = 0.0
        # in-flight iteration bookkeeping (failure cancel/re-run)
        self._iter_epoch = 0
        self._inflight: Optional[List[Request]] = None
        self.moe_rank_time = np.zeros(dep.E)
        self.done: List[Request] = []
        self.decomp: Dict[int, Dict[str, float]] = {}
        self.total_requests = 0
        self._armed = False
        self.router_hook: Optional[Callable] = None  # see AsapSim

    def arm(self):
        """Schedule the failure event once (SimEngine split, see AsapSim)."""
        if self._armed:
            return self
        self._armed = True
        plan = self.sim.resolved_fault_plan()
        if plan is not None:
            plan.validate(self.dep.E)
            for ev in plan.events:
                if ev.kind == "crash_moe":
                    self.at(ev.t, lambda ev=ev: self._fail(
                        ev.device, ev.duration))
                else:
                    self.at(ev.t, lambda ev=ev: self._stall(ev.duration))
        elif self.sim.failure_at is not None:
            self.at(self.sim.failure_at, self._fail)
        return self

    def inject(self, reqs: List[Request]):
        self.total_requests += len(reqs)
        for r in reqs:
            self.at(max(r.arrival, self.now), lambda r=r: self._arrive(r))

    def start(self):
        self.arm()
        self.inject(generate_requests(self.sim.rps, self.sim.duration,
                                      self.sim.trace))
        return self

    def _arrive(self, r: Request):
        self.queue.append(r)
        self._try_iteration()

    def _fail(self, moe_device: Optional[int] = None,
              duration: Optional[float] = None):
        # global barrier: whole engine stalls for the repair window AND the
        # in-flight iteration is lost — cancel its completion event (epoch
        # bump), requeue its requests at the head of the queue, and re-run
        # the iteration once the engine thaws.  Defaults reproduce the
        # legacy config path bit-exactly; FaultPlan crash events pass args.
        if moe_device is None:
            moe_device = self.sim.failure_moe_device
        duration = self.sim.failure_duration if duration is None \
            else float(duration)
        self.frozen_until = self.now + duration
        if moe_device is not None:
            # MoE-device outage: after the freeze the dead rank's
            # experts live on the survivors, so every later iteration
            # straddles the DEGRADED slowest EP rank — the barrier pins the
            # whole instance to the inherited load forever.
            self.load_model = self.load_model.with_failed(int(moe_device))
            self.cm = dataclasses.replace(
                self.cm, copies_override=self.load_model.expected_copies())
        if self.engine_busy:
            self._iter_epoch += 1  # the scheduled _iteration_done is now stale
            self.engine_busy = False
            if self._inflight:  # default mode removed them from the queue
                self.queue.extendleft(reversed(self._inflight))
            self._inflight = None
        self.at(self.frozen_until, self._try_iteration)

    def _stall(self, duration: float):
        """Non-fatal rank fault (FaultPlan stall_moe/drop_*/delay_wake):
        under the global barrier ANY rank's stall freezes the whole engine
        for `duration` — the sync baseline's structural weakness vs. ASAP's
        per-device stall (`AsapSim._stall_moe`).  The in-flight iteration
        finishes late rather than being lost (no state is destroyed)."""
        self.frozen_until = max(self.frozen_until, self.now) \
            + float(duration)
        self.at(self.frozen_until, self._try_iteration)

    def _moe_layer_latencies(self, tokens: int) -> np.ndarray:
        """L×E per-rank MoE latencies for one iteration, fully vectorized."""
        L = self.cfg.num_layers
        loads = self.load_model.layer_device_loads(tokens, L)
        hits = self.load_model.layer_device_hits(tokens, L)
        return np.atleast_2d(self.cm.moe_device_latency(loads, hits, tokens))

    def _sync_comm_latency(self, tokens: int,
                           hot_factor: Optional[np.ndarray] = None
                           ) -> np.ndarray:
        """Blocking all-to-all dispatch+combine over all chips: rendezvous
        (log-depth handshake) + transfer at derated effective bandwidth
        (no compute overlap inside a blocking collective). The transfer term
        straddles the most-loaded EP rank: `hot_factor` (>= 1) is the hottest
        rank's share of traffic relative to uniform, per layer."""
        hw = self.cm.hw
        b = 2.0 * self.cm.dispatch_bytes(tokens)  # dispatch + combine
        rendezvous = 2.0 * hw.p2p_handshake * math.log2(self.dep.total_chips)
        transfer = b / (self.dep.total_chips * hw.ici_bw * hw.sync_bw_derate)
        hf = np.ones(1) if hot_factor is None else np.asarray(hot_factor)
        return rendezvous + transfer * hf + 2 * hw.base_latency

    def _try_iteration(self):
        if self.engine_busy or not self.queue:
            return
        if self.now < self.frozen_until:
            self.at(self.frozen_until, self._try_iteration)
            return
        self.engine_busy = True
        D = self.dep.D
        cap = self.dep.max_batch_tokens
        if self.sim.mode == "chunked":
            # ChunkedPrefill reduces per-device seq budget to `chunk`/T tokens
            # (paper §5.1: 8k chunks -> 2k per attention device with T=4).
            picked, lens, prefixes = self._pick_chunks(D, self.sim.chunk)
            self._inflight = None  # chunked keeps requests in the queue
        else:
            take: List[Request] = list(self.queue)
            groups, overflow = balanced_partition(take, D, cap)
            picked = groups
            kept = set(r.rid for g in groups for r in g)
            self.queue = deque([r for r in self.queue if r.rid not in kept])
            lens = [[r.length for r in g] for g in groups]
            prefixes = [[0] * len(g) for g in groups]
            self._inflight = [r for g in groups for r in g]

        total_tokens = sum(sum(l) for l in lens)
        if total_tokens == 0:
            self.engine_busy = False
            self._inflight = None
            return
        if self.router_hook is not None:
            zipf = self.load_model.mode == "zipf"
            for l in range(self.cfg.num_layers):
                self.router_hook(total_tokens, l if zipf else 0)
        attn = [self.cm_group_attention(lens[g], prefixes[g]) for g in range(D)]
        attn_max = max(attn)
        L = self.cfg.num_layers
        moe_ranks = self._moe_layer_latencies(total_tokens)  # L×E
        moe_layers = moe_ranks.max(axis=1)  # barrier: slowest EP rank
        hot = self.load_model.layer_hot_factors(L)
        comm_layers = self._sync_comm_latency(total_tokens, hot)
        moe = float(moe_layers.mean())
        comm = float(np.mean(comm_layers))
        iter_time = L * attn_max + float(moe_layers.sum()) \
            + float(np.sum(comm_layers))
        t_end = self.now + iter_time
        t_start = self.now
        epoch = self._iter_epoch
        # rank busy time is charged at COMPLETION so a failure-cancelled
        # iteration is not double-counted when it re-runs
        rank_time = moe_ranks.sum(axis=0)
        self.at(t_end, lambda: self._iteration_done(picked, lens, attn,
                                                    attn_max, moe, comm,
                                                    t_start, epoch, rank_time))

    def cm_group_attention(self, lens: List[int], prefixes: List[int]) -> float:
        """Attention latency of one DP group for one layer (chunk-aware)."""
        c = self.cfg
        f = b = 0.0
        for s, p in zip(lens, prefixes):
            proj = 2.0 * s * c.d_model * (2 * c.q_dim + 2 * c.kv_dim)
            core = 4.0 * c.q_dim * s * (p + s / 2.0)
            f += proj + core
            b += 2.0 * s * c.d_model * 4
        b += 2.0 * c.d_model * (2 * c.q_dim + 2 * c.kv_dim)
        T = self.dep.T
        return max(f / (T * self.cm.hw.peak_flops * self.cm.hw.flop_efficiency),
                   b / (T * self.cm.hw.hbm_bw))

    def _pick_chunks(self, D: int, cap: int):
        """One chunk per queued request per iteration, LPT-balanced."""
        chunk = self.sim.chunk
        cands: List[Tuple[Request, int, int]] = []  # (req, start, len)
        for r in self.queue:
            startd = self.chunk_progress.get(r.rid, 0)
            if startd < r.length:
                cands.append((r, startd, min(chunk, r.length - startd)))
        groups: List[List[Tuple[Request, int, int]]] = [[] for _ in range(D)]
        loads = [0] * D
        for item in sorted(cands, key=lambda x: -x[2]):
            g = min(range(D), key=lambda i: loads[i])
            if loads[g] + item[2] > cap and loads[g] > 0:
                continue
            groups[g].append(item)
            loads[g] += item[2]
        picked = [[it[0] for it in g] for g in groups]
        lens = [[it[2] for it in g] for g in groups]
        prefixes = [[it[1] for it in g] for g in groups]
        self._picked_chunks = groups
        return picked, lens, prefixes

    def _iteration_done(self, picked, lens, attn, attn_max, moe, comm, t_start,
                        epoch: int, rank_time: np.ndarray):
        if epoch != self._iter_epoch:
            return  # iteration was cancelled by a failure; it will re-run
        L = self.cfg.num_layers
        self.engine_busy = False
        self._inflight = None
        self.moe_rank_time += rank_time
        if self.sim.mode == "chunked":
            for g in self._picked_chunks:
                for (r, start, clen) in g:
                    self.chunk_progress[r.rid] = start + clen
                    if start + clen >= r.length:
                        self._finish(r, t_start, L, attn, attn_max, moe, comm,
                                     gidx=None)
            done_ids = {r.rid for r in self.done}
            self.queue = deque([r for r in self.queue if r.rid not in done_ids])
        else:
            for gi, g in enumerate(picked):
                for r in g:
                    self._finish(r, t_start, L, attn, attn_max, moe, comm, gi)
        self._try_iteration()

    def _finish(self, r: Request, t_start, L, attn, attn_max, moe, comm, gidx):
        r.first_token_time = self.now
        self.done.append(r)
        a = attn[gidx] if gidx is not None else float(np.mean(attn))
        self.decomp[r.rid] = {
            "kernel": L * (a + moe + comm),
            "sync_wait": L * (attn_max - a),
            "queuing": max(t_start - r.arrival, 0.0),
        }

    def simulate(self) -> SimResult:
        self.start()
        self.run(horizon=self.sim.duration * 4 + 60.0)
        elapsed = max(self.now, 1e-9)
        return SimResult(self.done, self.decomp, self.total_requests,
                         moe_device_util=self.moe_rank_time / elapsed)


# ---------------------------------------------------------------------------
# Decode stage
# ---------------------------------------------------------------------------


class DecodeEntry:
    """One request resident in (or pending for) a decode batch."""
    __slots__ = ("rid", "kv_len", "remaining", "t_ready", "t_admitted",
                 "token_times")

    def __init__(self, rid: int, prompt_len: int, steps: int, t_ready: float):
        self.rid = rid
        self.kv_len = prompt_len  # grows one token per step
        self.remaining = steps  # decode tokens still to produce
        self.t_ready = t_ready  # KV landed; eligible for admission
        self.t_admitted: Optional[float] = None
        self.token_times: List[float] = []  # virtual per-token timestamps


class DecodeSim:
    """Analytic continuous-batching decode runtime in VIRTUAL time.

    The memory-bound counterpart of AsapSim's prefill pipeline: each step
    serves every active request one token for `CostModel.decode_step_latency`
    (KV-bytes-read dominated, batch-width amortized, per-step expert routing
    through the same `ExpertLoadModel`).  Requests JOIN between steps when
    their KV handoff has landed (`t_ready`) and a slot under `width` is
    free, and LEAVE the instant their sampled decode length is produced —
    continuous batching, no wave barriers.

    `advance(t_limit)` never steps past a caller-chosen frontier, which is
    how the orchestrator keeps a decode sim causally behind its prefill
    sim's virtual clock; time never rewinds (enrollments with t_ready in
    the past admit at `now`).
    """

    def __init__(self, cfg: ModelConfig, cm: CostModel,
                 load_model: Optional[ExpertLoadModel] = None,
                 width: int = 32):
        assert width >= 1
        self.cfg, self.cm = cfg, cm
        self.load_model = load_model
        self.width = width
        self.now = 0.0
        self._pending: List[Tuple[float, int, DecodeEntry]] = []  # heap
        self._seq = itertools.count()
        self._active: Dict[int, DecodeEntry] = {}
        self.completed: List[DecodeEntry] = []  # drained by the caller
        self.busy_time = 0.0
        self.steps = 0
        self.router_hook: Optional[Callable] = None  # (tokens, lkey)

    @property
    def load(self) -> int:
        """Requests enrolled but not finished (least-loaded routing key)."""
        return len(self._active) + len(self._pending)

    def enroll(self, rid: int, prompt_len: int, steps: int, t_ready: float):
        """Register one request whose KV handle lands at `t_ready`; it will
        produce `steps` decode tokens after admission."""
        assert steps >= 1
        e = DecodeEntry(rid, prompt_len, steps, t_ready)
        heapq.heappush(self._pending, (t_ready, next(self._seq), e))
        return e

    def _admit(self, t_limit: float) -> bool:
        admitted = False
        while self._pending and len(self._active) < self.width \
                and self._pending[0][0] <= max(self.now, t_limit):
            t_ready, _, e = heapq.heappop(self._pending)
            # continuous batching joins at step boundaries; time never
            # rewinds for handles that landed while a step was in flight
            e.t_admitted = max(self.now, t_ready)
            self._active[e.rid] = e
            admitted = True
        return admitted

    def advance(self, t_limit: float):
        """Run decode steps until `t_limit` (virtual seconds) or until no
        work is eligible before it.  A step in progress may finish past the
        limit — the caller's next advance() starts from that frontier."""
        while True:
            self._admit(self.now)
            if not self._active:
                if not self._pending or self._pending[0][0] > t_limit:
                    return
                # idle: jump to the next KV arrival (never rewinding)
                self.now = max(self.now, self._pending[0][0])
                continue
            if self.now >= t_limit:
                return
            entries = list(self._active.values())
            kv_lens = [e.kv_len for e in entries]
            dt = self.cm.decode_step_latency(kv_lens, self.load_model)
            if self.router_hook is not None:
                # expectation-weighted per-step routing: B tokens route
                # through every MoE layer of the step
                self.router_hook(len(entries) * self.cfg.num_layers, 0)
            self.now += dt
            self.busy_time += dt
            self.steps += 1
            for e in entries:
                e.kv_len += 1
                e.remaining -= 1
                e.token_times.append(self.now)
                if e.remaining <= 0:
                    del self._active[e.rid]
                    self.completed.append(e)

    def remaining_work(self) -> Tuple[int, int]:
        """(total decode steps still owed, max final KV length) over every
        unfinished enrollment — sizes the caller's drain horizon."""
        entries = list(self._active.values()) \
            + [e for _, _, e in self._pending]
        steps = sum(e.remaining for e in entries)
        kv_max = max((e.kv_len + e.remaining for e in entries), default=0)
        return steps, kv_max

    def drain(self, horizon: float):
        """Advance until everything enrolled finished or `horizon` passed.
        Returns entries still unfinished at the horizon (timeout cases)."""
        while (self._active or self._pending) and self.now < horizon:
            before = self.steps
            self.advance(horizon)
            if self.steps == before and not self._active:
                break  # nothing eligible before the horizon
        leftovers = list(self._active.values()) \
            + [e for _, _, e in self._pending]
        self._active.clear()
        self._pending = []
        return leftovers


def drain_horizon(sim_cfg: SimConfig, cm: CostModel) -> float:
    """Bounded drain horizon for the online SimEngine.

    The prefill-sized bound (`duration*4 + 60`) mislabels
    long-generation traces as `timeout`: a trace with sampled decode
    lengths legitimately runs ~total-decode-steps x per-step latency past
    the last arrival.  Budget that tail from the trace's expected step
    count at a conservative (serial, batch-width-1) per-step latency.
    Traces without decode (`out_len_mean <= 1`) return that bound
    EXACTLY, preserving bit-parity with the offline run_sim."""
    base = sim_cfg.duration * 4 + 60.0
    tc = sim_cfg.trace
    if tc.out_len_mean <= 1.0:
        return base
    total_steps = max(sim_cfg.rps * sim_cfg.duration, 1.0) * tc.out_len_mean
    kv = int(tc.mean_len + tc.out_len_mean) + 1
    per_step = cm.decode_step_latency([kv])
    return base + 2.0 * total_steps * per_step


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def run_sim(cfg: ModelConfig, sim: SimConfig,
            asap_dep: Deployment = Deployment(D=4, T=4, E=16),
            sync_dep: Deployment = Deployment(D=8, T=4, E=32)) -> SimResult:
    if sim.mode == "asap":
        return AsapSim(cfg, sim, asap_dep).simulate()
    return SyncSim(cfg, sim, sync_dep).simulate()


def slo_throughput(cfg: ModelConfig, mode: str, slo: float = 5.0,
                   duration: float = 60.0,
                   asap_dep: Deployment = Deployment(D=4, T=4, E=16),
                   sync_dep: Deployment = Deployment(D=8, T=4, E=32),
                   refine: float = 0.25, rps_max: float = 64.0,
                   **kw) -> float:
    """Max RPS sustained with mean TTFT <= slo and >=99% completion.

    Coarse doubling scan, then bisection refinement to `refine` RPS resolution
    (the paper's ablation effects are 6–14%, so resolution matters). When even
    the initial 0.5 RPS probe misses the SLO, the (0, 0.5] interval is still
    bisected — slow configs report their true (small) sustainable rate
    instead of a silent 0.0 floor."""

    def ok(rps: float) -> bool:
        sim = SimConfig(mode=mode, rps=rps, duration=duration, slo=slo, **kw)
        res = run_sim(cfg, sim, asap_dep=asap_dep, sync_dep=sync_dep)
        return res.mean_ttft <= slo and res.completed_fraction() >= 0.99

    lo, hi = 0.0, 0.5
    while hi <= rps_max and ok(hi):
        lo, hi = hi, hi * 2
    # the doubling scan can exit with hi = 2*lo > rps_max; clamp before
    # refining so bisection never explores (and returns a rate in)
    # (rps_max, 2*rps_max] — the result must respect the caller's cap
    hi = min(hi, rps_max)
    while hi - lo > refine:
        mid = (lo + hi) / 2
        if ok(mid):
            lo = mid
        else:
            hi = mid
    return lo
