"""Threaded MPMD runtime: ASAP's disaggregated asynchronous prefill pipeline
on one CUDA device (or, for tests, the CPU).

Topology: D attention DP groups (each a thread; T configurable protocol rows)
+ E MoE "device" threads, wired by the shared-buffer primitives of
core/async_primitives.py.  On a card every worker thread owns one
`torch.cuda.Stream`, so attention of group g overlaps the MoE stage of device
e as the threads do.  The mechanisms of the paper that this slice carries:

  * async dispatch/combine with bitmap flags + backpressure (§3.2)
  * dual-batch interleaving on attention devices (§3.3.2)
  * out-of-order MoE: devices block in `recv_any` and process whichever DP
    group's batch-layer completes first -- the layer id arrives as DATA and
    indexes the resident [L, n_e, ...] weight stack inside the MoE Super
    Kernel (§3.4.2)
  * shared-expert compute on the attention device, overlapped with the
    routed experts' remote execution (`shared_on_attention=False` disables)
  * replica-aware dispatch: expert->device assignment comes from a
    `core.cost_model.Placement`; a replicated hot expert's traffic goes to
    its least-loaded replica.
  * live expert re-placement: `apply_placement` swaps the resident weight
    stacks and dispatch tables mid-serve -- freeze the dispatch gate, drain
    the dispatchers, quiesce the affected MoE devices, build the new stacks,
    swap atomically, release.
  * supervised failover: a `core.faults.FaultPlan` injects crashes, stalls,
    delays and dropped payloads at the worker and buffer seams.  A
    supervisor thread detects a dead (or, with `stall_timeout`, a wedged)
    MoE worker, fences it out through a worker generation bumped under its
    buffer's lock, re-serves every region it took but never combined
    exactly once, evacuates its experts onto the survivors through the
    live re-placement swap (`Placement.fail`), and restarts it.  A group
    whose region never completes (a dropped payload) times out after
    `region_timeout`, scrubs the lane and replays the batch from layer 0,
    up to `max_job_retries` times.  A CUDA error is not a device failure:
    the E "devices" share one CUDA context, so it panics and is never
    failed over.

Hot path (`moe_path="fused"`, the default):

  * Attention side: one step computes norm + QKV/RoPE + flash attention +
    wo + norm + router (+ shared expert); the layer id indexes the stacked
    per-layer params (views, no copies).
  * Dispatch: one stable argsort over (device, expert) keys and ONE device
    gather build all E payloads per batch-layer.  Token rows and expert
    outputs stay device tensors; what crosses to the host per batch-layer is
    the router's expert ids (one device-to-host read).
  * Resident weights: with round-robin placement each device's [L, n_e, ...]
    stack is a strided view of the model's expert stacks (the kernel takes
    the strides); other placements gather a copy.
  * MoE side: each drain is packed into dropless per-expert capacity buffers
    ([n_e, C, d]; C bucketed to powers of two) from host counts, then ONE
    `super_moe_ffn` call per distinct layer runs the three expert
    projections against the device's resident [L, n_e, ...] stack with the
    layer id as a one-element device tensor and the per-expert row counts
    (the dispatch metadata, summed over the regions a launch merges) as
    device data, so the kernel skips the buffers' padding.  With
    `moe_batch_window == 0` a drain is one region; with a window > 0 the
    worker is a continuous batcher: a drain takes every pending region and
    keeps accumulating arrivals for up to `moe_batch_window` WALL seconds
    (bounded by `moe_batch_max_tokens` merged rows), so regions of many
    groups share one launch and one stream sync.
  * Combine: expert outputs are written by (token, k) into a [Tn, top_k, d]
    buffer (every pair is unique: no atomics) and reduced over k in order
    0..K-1 -- deterministic.  `combine_path="host"` does the same write and
    the same in-order multiply-then-add in numpy fp32 (the baseline; equal
    to the device combine bit for bit).
  * KV export (`emit_kv=True`): the attention step also returns the layer's
    post-RoPE (k, v).  They stay on the card; at the end of a job each
    request's [L, len, kvh, hd] K and V are gathered into contiguous tensors
    (a view would pin the whole padded batch) and travel with a CUDA event,
    for the prefill->decode handoff (`ExecutorEngine(keep_kv=True)`).

Pre-fusion baseline (`moe_path="eager"`, as the reference keeps it for the
hot-path benchmark): a per-layer Python-int param slice and the dense
attention oracle op by op, E boolean dispatch scans with token rows crossing
to the host, and per local expert three matmuls and one device-to-host copy.
It runs none of the port's kernels.

Numerical contract (tested against the JAX reference): pipeline output ==
lm_backbone(..., moe_mode="dense") for the same params -- asynchrony,
placement and fusion must not change the math.

Lifecycle: the executor is a LONG-LIVED engine.  `ensure_started()` spawns
the D group workers + E MoE workers once; group workers PULL work from a
shared admission queue (`submit_job`) -- an un-pinned job goes to whichever
group frees a dual-batch slot first.  Completions surface out of order
through the `on_complete` callback.  `run(jobs_per_group)` is the one-shot
shim: pin each job to its group, submit, block until the wave completes.

Cross-stream rule: a tensor produced on one worker's stream and consumed on
another's travels with a CUDA event the consumer's stream waits on, and is
`record_stream`-ed there so the caching allocator does not reuse its memory
early.  MoE workers synchronise their own stream before `combine_send`, which
also makes their host-clocked busy time real device time; so does the
supervisor, which serves orphaned regions and builds a swap's new stacks on a
stream of its own (never the fenced worker's: a stalled worker may still
enqueue there), and synchronises it before it combines or swaps.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.async_primitives import (AbortedError, AttnDeviceBuffer,
                                               CombinePayload,
                                               DispatchPayload,
                                               MoEDeviceBuffer)
from repro_torch.core.cost_model import Placement
from repro_torch.core.faults import FaultInjector, FaultPlan, InjectedFault
from repro_torch.core.spans import SPANS, clock_ns
from repro_torch.kernels import _launch
from repro_torch.kernels.super_gmm.ops import (pack_capacity_multi,
                                               round_capacity, super_moe_ffn,
                                               unpack_capacity_multi)
from repro_torch.models.attention import attention_forward, attention_prefill
from repro_torch.models.common import ModelConfig, act_fn, apply_norm
from repro_torch.models.lm import embed_tokens, layer_slice, lm_stages
from repro_torch.models.moe import gated_ffn, router_topk

# torch >= 2.8 raises device-side faults as AcceleratorError (a RuntimeError)
_ACCELERATOR_ERROR = getattr(torch, "AcceleratorError", ())


class SwapAborted(RuntimeError):
    """A live re-placement gave way to a failover: a MoE worker died while
    the swap quiesced (its buffered regions would never drain, and the
    supervisor's failover waits for `_swap_lock`).  Nothing was swapped;
    the caller may retry once the failover has run."""


def _is_cuda_error(exc: BaseException) -> bool:
    """A failure of the CUDA context, which every worker thread shares (an
    illegal address, a launch failure), as opposed to a host-side one."""
    return isinstance(exc, _ACCELERATOR_ERROR) or (
        isinstance(exc, RuntimeError) and str(exc).startswith("CUDA error"))


@dataclasses.dataclass(eq=False)
class BatchJob:
    """One batch through the pipeline.  Compared by identity: its fields
    hold arrays, which have no single truth value, and a group worker finds
    its finished slot (whose dict holds the job) by equality."""
    tokens: Any  # [B, S] integer array (numpy or tensor)
    result: Any = None  # final hidden states [B, S, d], on the device
    bid: int = 0
    # --- engine fields ------------------------------------------------------
    group: Optional[int] = None  # pinned attention group; None = least-loaded
    lengths: Optional[List[int]] = None  # per-row valid prompt lengths
    meta: Any = None  # opaque engine payload (the batched Requests)
    # timestamps/durations in `DisaggregatedExecutor.clock` units (trace
    # seconds when driven by a TraceClock, wall seconds otherwise)
    t_submitted: Optional[float] = None
    t_started: Optional[float] = None  # first attention dispatch
    t_finished: Optional[float] = None
    kernel_time: float = 0.0  # attention-side compute (this group's stream)
    comm_time: float = 0.0  # blocked in combine (MoE compute + wire + queue)
    # --- fault tolerance ----------------------------------------------------
    retries: int = 0  # region-timeout replays (capped backoff, from layer 0)
    failed: Optional[str] = None  # terminal failure reason (result stays None)
    hedged: bool = False  # a hedge clone of this job was issued
    is_hedge: bool = False  # this job IS the hedge clone
    # emit_kv: per batch row, (k, v, ready) -- k/v [L, lengths[i], kvh, hd]
    # contiguous device tensors, `ready` the CUDA event after their gather
    # (None on the CPU)
    kv: Optional[List[tuple]] = None


class DisaggregatedExecutor:
    def __init__(self, params, cfg: ModelConfig, D: int = 2, E: int = 4,
                 T: int = 1, interleave: bool = True,
                 shared_on_attention: bool = True,
                 placement: Optional[Placement] = None,
                 expert_fractions: Optional[Sequence[float]] = None,
                 idle_backoff: Optional[float] = 0.05,
                 supervise: bool = True,
                 stall_timeout: Optional[float] = None,
                 max_worker_restarts: int = 3,
                 region_timeout: float = 240.0,
                 max_job_retries: int = 2,
                 emit_kv: bool = False,
                 moe_path: str = "fused", combine_path: str = "device",
                 moe_batch_window: float = 0.0,
                 moe_batch_max_tokens: Optional[int] = None,
                 device: Any = "cuda"):
        if cfg.family != "moe":
            raise ValueError("executor drives MoE models")
        if moe_path not in ("fused", "eager"):
            raise ValueError(f"moe_path {moe_path!r}: 'fused' or 'eager'")
        if combine_path not in ("device", "host"):
            raise ValueError(f"combine_path {combine_path!r}: 'device' or "
                             f"'host'")
        if moe_batch_window < 0:
            raise ValueError(f"moe_batch_window {moe_batch_window} < 0")
        if moe_batch_max_tokens is not None and moe_batch_max_tokens < 1:
            raise ValueError(f"moe_batch_max_tokens {moe_batch_max_tokens} "
                             f"< 1")
        if moe_path == "eager" and moe_batch_window > 0:
            raise ValueError("cross-region batching merges regions into ONE "
                             "capacity buffer: it requires the fused path")
        if moe_path == "eager" and emit_kv:
            raise ValueError("emit_kv requires the fused attention step (the "
                             "eager step exports no KV cache)")
        (kind, n, opts), = lm_stages(cfg)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DisaggregatedExecutor(device='cuda'): no "
                               "CUDA device (pass device='cpu' to run the "
                               "plain versions)")
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"executor runs on {self.device}")
        self.params, self.cfg = params, cfg
        self.D, self.E, self.T = D, E, T
        self.L = cfg.num_layers
        self.interleave = interleave
        self.shared_on_attention = shared_on_attention
        self.idle_backoff = idle_backoff  # max CV wait in the MoE workers
        self.emit_kv = emit_kv  # attention step also returns the layer's KV
        self.moe_path, self.combine_path = moe_path, combine_path
        # cross-region continuous batching: window 0 serves one region per
        # drain (the per-region path)
        self.moe_batch_window = float(moe_batch_window)
        self.moe_batch_max_tokens = moe_batch_max_tokens
        self.stage = params["stages"][0]
        self._window = opts.get("window")
        # --- replica-aware expert placement -------------------------------
        self.placement = placement if placement is not None else Placement()
        fr = tuple(float(x) for x in expert_fractions) \
            if expert_fractions is not None \
            else Placement.uniform_fractions(cfg.num_experts)
        if len(fr) != cfg.num_experts:
            raise ValueError(f"expert_fractions has {len(fr)} entries for "
                             f"{cfg.num_experts} experts")
        self.expert_fractions = fr
        self.table = self.placement.table(fr, E)
        self.dev_experts = self.placement.device_experts(fr, E)
        # routing lookups: primary host per expert, replica sets, and the
        # per-device global->local expert index
        self._primary, self._replicated, self._g2l = \
            self._dispatch_lookups(self.table, self.dev_experts)
        self._dev_load = np.zeros(E, np.int64)  # dispatched assignments  guarded_by: _load_lock
        self._load_lock = threading.Lock()
        # buffers
        self.moe_bufs = [MoEDeviceBuffer(D, T) for _ in range(E)]
        self.attn_bufs = [[AttnDeviceBuffer(E) for _ in range(2)]
                          for _ in range(D)]  # per group x dual-batch slot
        # "resident" expert weights per MoE device: [L, n_e, ...] -- the
        # super-kernel layout (all layers resident; the layer id indexes at
        # run time).  n_e follows the placement: replicas are resident on
        # every host.  A device that hosts nothing keeps None and never
        # launches.
        self._experts = self.stage["ffn"]["experts"]
        self.resident = [self._resident_stack(self.dev_experts[e])
                         if len(self.dev_experts[e]) else None
                         for e in range(E)]
        # --- live re-placement state --------------------------------------
        # dispatch gate: apply_placement freezes new dispatches (readers of
        # the routing tables) and waits for in-flight ones to drain before
        # swapping tables + resident stacks; `_moe_active[e]` marks a device
        # mid-drain (set BEFORE recv_any/recv_many clear the flags, so "no
        # flags set and not active" really means quiescent)
        self._gate_cv = threading.Condition()
        self._gate_frozen = False  # guarded_by: _gate_cv
        self._dispatchers = 0  # guarded_by: _gate_cv
        # guarded_by: protocol
        # (single-writer per element: only MoE worker e flips _moe_active[e]
        # -- the supervisor after fencing it out; the quiesce loop tolerates
        # a stale read, it just polls again)
        self._moe_active = [False] * E
        self.migrations: List[Dict[str, Any]] = []  # live re-placement log
        self.migrated_bytes = 0.0
        # --- fault tolerance ----------------------------------------------
        # One lock serializes EVERY placement swap: apply_placement and the
        # supervisor's failover both funnel through
        # _apply_placement_locked, whose freeze/quiesce/swap phases must
        # never interleave.
        self.supervise = supervise
        self.stall_timeout = stall_timeout  # clock units; None = death-only
        self.max_worker_restarts = max_worker_restarts
        self.region_timeout = region_timeout  # wall s: combine_recv bound
        self.max_job_retries = max_job_retries
        self._swap_lock = threading.Lock()
        self.fault_injector: Optional[FaultInjector] = None
        self.on_failover: Optional[Any] = None  # callable(device), post-swap
        self.failovers = 0  # guarded_by: protocol
        # (single-writer: only the supervisor thread executes failovers)
        # guarded_by: protocol
        # (single-writer per element: worker e stamps its own heartbeat;
        # the supervisor tolerates a stale read -- one scan of extra latency)
        self._heartbeat = [0.0] * E
        # guarded_by: protocol
        # (worker-generation fence: bumped ONLY under the buffer's shared cv
        # via MoEDeviceBuffer.fenced, read by recv_any/recv_many's admission
        # check under the same cv; a worker's unlocked loop-top read may be
        # stale one iteration -- the next take re-validates under the cv)
        self._moe_gen = [0] * E
        # guarded_by: protocol
        # (the regions worker e took but has not combined yet -- a tuple of
        # (region, rows) entries (the continuous batcher may hold several;
        # per-region mode at most one), appended under the buffer cv by the
        # recv_any/recv_many on_take and each entry removed by the worker,
        # under the same cv and only while its generation is current,
        # BEFORE that region's combine_send; after the generation fence the
        # supervisor is the cell's only reader/writer -- "entry still
        # present" proves its combine never happened, so the failover
        # re-serve is exactly-once)
        self._moe_current: List[Optional[tuple]] = [None] * E
        # guarded_by: protocol
        # (written once by dying worker e, read by the supervisor after it
        # observed the thread dead -- the is_alive edge orders the two)
        self._moe_fail_exc: List[Optional[BaseException]] = [None] * E
        self._moe_restarts = [0] * E  # guarded_by: protocol
        # (single-writer: only the supervisor restarts workers)
        self._sup_thread: Optional[threading.Thread] = None
        self._retired: List[threading.Thread] = []  # fenced-out old workers
        # the layer ids as DEVICE data: `_lid[l:l+1]` is a one-element int32
        # view the Super Kernel reads -- no per-launch host-to-device copy
        self._lid = torch.arange(self.L, dtype=torch.int32,
                                 device=self.device)
        self._attn_stage = {"attn": self.stage["attn"],
                            "ln_attn": self.stage["ln_attn"],
                            "ln_ffn": self.stage["ln_ffn"],
                            "router": self.stage["ffn"]["router"]}
        if "shared" in self.stage["ffn"] and shared_on_attention:
            self._attn_stage["shared"] = self.stage["ffn"]["shared"]
        cuda = self.device.type == "cuda"
        self._group_streams = [torch.cuda.Stream(self.device) if cuda
                               else None for _ in range(D)]
        self._moe_streams = [torch.cuda.Stream(self.device) if cuda
                             else None for _ in range(E)]
        # the supervisor's own stream: orphan re-serves and a failover's new
        # stacks (never a fenced worker's stream -- a stalled worker may
        # still enqueue there)
        self._sup_stream = torch.cuda.Stream(self.device) if cuda else None
        self.stop = threading.Event()
        self.errors: List[BaseException] = []
        # event log for protocol assertions in tests
        self.log: List[tuple] = []  # guarded_by: _log_lock
        self._log_lock = threading.Lock()
        # --- long-lived engine state --------------------------------------
        # `clock` is assignable: the ExecutorEngine points it at a replayable
        # TraceClock.now so every timestamp below is in trace seconds.
        self.clock = time.monotonic
        # duck-typed measured-router-stats sink: anything with
        # .record(layer, expert_ids) -- see core.engine.RouterStatsCollector.
        self.router_stats: Optional[Any] = None
        self.on_complete: Optional[Any] = None  # callable(BatchJob)
        self._jobq: List[BatchJob] = []  # shared admission queue  guarded_by: _jobq_cv
        self._jobq_cv = threading.Condition()
        self._done_cv = threading.Condition()
        self._started = False
        self._hung: List[threading.Thread] = []  # left over by a timed-out run
        self._g_threads: List[threading.Thread] = []
        self._moe_threads: List[threading.Thread] = []
        self._t_serving_start: Optional[float] = None
        # measured busy time per device (clock units) for EngineStats
        # guarded_by: protocol
        # (single-writer: only worker e / group g accumulates its own cell;
        # EngineStats reads after join() or tolerates a slightly stale sum)
        self.moe_busy = np.zeros(E)
        self.group_busy = np.zeros(D)  # guarded_by: protocol
        # --- super-kernel launch telemetry --------------------------------
        # All per-device cells below follow the moe_busy ownership rule:
        # only worker e (or the supervisor, after fencing e out) writes
        # device e's cell; readers tolerate a stale sum.
        self.moe_launches = np.zeros(E)  # guarded_by: protocol
        self.moe_launch_regions = np.zeros(E)  # guarded_by: protocol
        self.moe_launch_rows = np.zeros(E)  # guarded_by: protocol
        # (real token rows launched)
        self.moe_launch_slots = np.zeros(E)  # guarded_by: protocol
        # (n_e*C capacity slots launched; rows/slots is the occupancy)
        self.bucket_hits = np.zeros(E)  # guarded_by: protocol
        # (launches whose capacity bucket C was already seen on this device)
        self.bucket_misses = np.zeros(E)  # guarded_by: protocol
        # (first sighting of a bucket: a new buffer shape for the allocator)
        self._seen_buckets: List[set] = [set() for _ in range(E)]
        # guarded_by: protocol
        # (single-writer per element: same owner as bucket_hits/misses)
        # for the spans: the bid of the job in each (group, dual-batch
        # slot), the ids of the batch-layer group g combines, and the
        # (bid, layer, g) of the regions device e launches
        self._span_ids: List[Optional[Dict[str, Any]]] = [None] * D
        # guarded_by: protocol
        # (single-writer per element: group worker g)
        self._span_regions: List[Optional[list]] = [None] * E
        # guarded_by: protocol
        # (single-writer per element: same owner as moe_busy)
        self._slot_bids = [[None, None] for _ in range(D)]
        # guarded_by: protocol
        # (single-writer per element: group worker g fills its slots; a MoE
        # worker reads a slot's cell only while it holds one of the slot's
        # regions, before its combine, so the job cannot have left the slot)

    def _logev(self, *ev):
        with self._log_lock:
            self.log.append(ev)

    # ------------------------------------------------- placement derivation
    def _dispatch_lookups(self, table, dev_experts):
        """(primary, replicated, g2l) routing lookups for a placement
        table."""
        primary = np.array([h[0] for h in table], np.int64)
        replicated = [e for e, h in enumerate(table) if len(h) > 1]
        g2l = np.full((self.E, self.cfg.num_experts), -1, np.int64)
        for e, held in enumerate(dev_experts):
            g2l[e, list(held)] = np.arange(len(held))
        return primary, replicated, g2l

    def _resident_stack(self, held) -> Dict[str, torch.Tensor]:
        """One device's resident [L, n_e, ...] weight stack.  The Super Kernel
        takes the stack's layer and expert strides, so when the held experts
        form an arithmetic progression (round-robin placement) the stack is a
        strided VIEW of the model's full expert stacks -- no second copy of
        the weights.  Any other placement gathers a copy."""
        ids = np.asarray(held, np.int64)
        step = int(ids[1] - ids[0]) if len(ids) > 1 else 1
        if step > 0 and np.array_equal(ids,
                                       ids[0] + step * np.arange(len(ids))):
            first, stop = int(ids[0]), int(ids[-1]) + 1
            return {k: v[:, first:stop:step]
                    for k, v in self._experts.items()}
        sel = torch.as_tensor(ids, device=self.device)
        return {k: v.index_select(1, sel) for k, v in self._experts.items()}

    @property
    def expert_copy_bytes(self) -> float:
        """Bytes of ONE expert's weights for ONE layer, at the model's
        element size -- the unit a migration record prices its copies in."""
        return float(sum(v[0, 0].numel() * v.element_size()
                         for v in self._experts.values()))

    # ------------------------------------------------------ device plumbing
    @contextlib.contextmanager
    def _worker_context(self, stream):
        """What every worker thread runs under: no autograd state, and on a
        card the thread's own stream."""
        with torch.inference_mode():
            if stream is None:
                yield
            else:
                with torch.cuda.device(self.device), \
                        torch.cuda.stream(stream):
                    yield

    def _index(self, ids: np.ndarray) -> torch.Tensor:
        """Small host id array -> int64 index tensor on the device."""
        return torch.as_tensor(np.ascontiguousarray(ids, dtype=np.int64),
                               device=self.device)

    def _record_ready(self):
        """Event marking 'everything enqueued so far on this thread's stream
        is done' -- travels with a payload (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _await(self, ready, tensor):
        """Consumer side of the cross-stream rule: wait for the producer's
        event (None when the producer synchronised its stream instead), and
        tell the caching allocator that this thread's stream uses the
        tensor, so its memory is not handed out again while kernels queued
        here still read it."""
        if tensor is None or not tensor.is_cuda:
            return
        cur = torch.cuda.current_stream(self.device)
        if ready is not None:
            cur.wait_event(ready)
        tensor.record_stream(cur)

    def _sync_stream(self):
        """Host waits for this thread's stream (counted as a host sync)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
            _launch.note_host_sync()

    def _to_cpu(self, t: torch.Tensor) -> torch.Tensor:
        """Device-to-host read (counted as a host sync on a card)."""
        if t.is_cuda:
            _launch.note_host_sync()
        return t.cpu()

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        return self._to_cpu(t).numpy()

    # ------------------------------------------------------------ attention
    def _attn_step(self, layer: int, h: torch.Tensor):
        """Attention + norms + router (+ shared expert) of one layer: the
        layer id indexes the stacked params (views).  Attention takes the
        flash-attention branch: the kernel on a card, its plain version on
        the CPU.  The layer's post-RoPE (k, v) come back as well (views of
        the projection, no copy); only `emit_kv` keeps them."""
        cfg = self.cfg
        lp = layer_slice(self._attn_stage, layer)
        a, cache = attention_prefill(lp["attn"],
                                     apply_norm(h, lp["ln_attn"], cfg), cfg,
                                     window=self._window, use_dense=False)
        h = h + a
        x = apply_norm(h, lp["ln_ffn"], cfg)
        B, S, d = x.shape
        xf = x.reshape(B * S, d)
        weights, idx, _ = router_topk(lp["router"], xf, cfg)
        shared = None
        if "shared" in lp:
            s = lp["shared"]
            shared = gated_ffn(xf, s["w_gate"], s["w_up"], s["w_down"],
                               act_fn(cfg.act))
        return h, xf, weights, idx, shared, (cache.k, cache.v)

    def _attn_part(self, layer: int, h: torch.Tensor):
        """Eager (pre-fusion) attention step, the `moe_path="eager"`
        baseline as the reference keeps it: the layer's params sliced by a
        Python int, the dense attention oracle (not the flash kernel), then
        norm, router and shared expert op by op.  Exports no KV."""
        cfg = self.cfg
        lp = layer_slice(self.stage, layer)
        h = h + attention_forward(lp["attn"],
                                  apply_norm(h, lp["ln_attn"], cfg), cfg,
                                  window=self._window, use_dense=True)
        x = apply_norm(h, lp["ln_ffn"], cfg)
        B, S, d = x.shape
        xf = x.reshape(B * S, d)
        weights, idx, _ = router_topk(lp["ffn"]["router"], xf, cfg)
        shared = None
        if "shared" in lp["ffn"] and self.shared_on_attention:
            sp = lp["ffn"]["shared"]
            shared = gated_ffn(xf, sp["w_gate"], sp["w_up"], sp["w_down"],
                               act_fn(cfg.act))
        return h, xf, weights, idx, shared, None

    # ------------------------------------------------------------- dispatch
    def _gate_enter(self):
        """Block while a live re-placement holds the dispatch gate.  Entered
        for the whole of one batch-layer's dispatch (routing, the gather and
        the E sends), so a placement swap never observes (or splits) a
        half-dispatched layer.  A stop request falls through -- shutdown must
        not deadlock on a frozen gate."""
        with self._gate_cv:
            while self._gate_frozen and not self.stop.is_set():
                self._gate_cv.wait(0.1)
            self._dispatchers += 1

    def _gate_exit(self):
        with self._gate_cv:
            self._dispatchers -= 1
            self._gate_cv.notify_all()

    def _route(self, flat_e: np.ndarray) -> np.ndarray:
        """Device id per (token, k) assignment under the placement table.

        Single-host experts go to their host; a replicated expert's rows are
        spread round-robin over its hosts ordered by the CURRENT dispatched
        load, so hot-expert traffic lands on the least-loaded replica first
        (MegaScale-style load-splitting, executed at dispatch time)."""
        dev = self._primary[flat_e]
        with self._load_lock:
            for e in self._replicated:
                rows = np.nonzero(flat_e == e)[0]
                if not rows.size:
                    continue
                hosts = np.asarray(self.table[e], np.int64)
                by_load = hosts[np.argsort(self._dev_load[hosts],
                                           kind="stable")]
                dev[rows] = by_load[np.arange(rows.size) % hosts.size]
            self._dev_load += np.bincount(dev, minlength=self.E)
        return dev

    def _flat_routing(self, idx: np.ndarray, layer: int = 0,
                      valid: Optional[np.ndarray] = None):
        Tn, K = idx.shape
        flat_e = idx.reshape(-1).astype(np.int64)
        flat_t = np.repeat(np.arange(Tn), K)
        flat_k = np.tile(np.arange(K), Tn)
        if self.router_stats is not None:
            # MEASURED per-expert routing stats: every real router
            # assignment is counted before placement routing, so the
            # collector sees expert popularity, not device load.  `valid`
            # masks out padding rows -- pad tokens still flow through
            # dispatch/compute (the dense-reference contract covers them)
            # but must not contaminate the measured fractions.
            rec = flat_e if valid is None else flat_e[np.repeat(valid, K)]
            self.router_stats.record(layer, rec)
        return flat_e, flat_t, flat_k, self._route(flat_e)

    def _send_device(self, g: int, slot: int, layer: int, e: int, rows,
                     t_rows, k_rows, local_ids, ready):
        """Write one device's T payload rows (empty payloads included so the
        T·D bitmap regions always complete).  `rows` are this device's token
        rows, already gathered on the executor's device."""
        inj = self.fault_injector
        if inj is not None and inj.should_drop_dispatch(e):
            # injected network fault: drop the WHOLE region (all T rows) --
            # never a partial region.  The region stays incomplete, the
            # group's combine_recv times out, and the batch replays through
            # the retry path (exactly-once: the injector fires per event).
            self._logev("drop-dispatch", g, slot, layer, e)
            return
        token_ids = np.stack([t_rows, k_rows], 1)  # (token, k)
        counts = np.bincount(local_ids,
                             minlength=max(len(self.dev_experts[e]), 1))
        for j in range(self.T):
            sl = slice(j, None, self.T)  # row-split across TP members
            p = DispatchPayload(layer=layer, slot=slot,
                                counts=counts if j == 0 else None,
                                tokens=rows[sl],
                                token_ids=token_ids[sl],
                                expert_ids=local_ids[sl], ready=ready)
            self.moe_bufs[e].dispatch_send(g, j, p, stop=self.stop)
        self._logev("dispatch", g, slot, layer, e, int(len(t_rows)))

    def _dispatch(self, g: int, slot: int, layer: int, xf: torch.Tensor,
                  idx: np.ndarray, valid: Optional[np.ndarray] = None):
        """async-dispatch-send: ONE stable argsort over (device, expert)
        keys and ONE device gather build all E payloads -- no per-device
        boolean scans, no token row crosses to the host.  Inside the
        dispatch gate: routing, the gather and every `_g2l` read see one
        placement."""
        self._gate_enter()
        try:
            flat_e, flat_t, flat_k, dev = self._flat_routing(idx, layer,
                                                             valid)
            order = np.argsort(dev * max(self.cfg.num_experts, 1) + flat_e,
                               kind="stable")
            dev_s, e_s = dev[order], flat_e[order]
            t_s, k_s = flat_t[order], flat_k[order]
            bounds = np.concatenate(
                ([0], np.cumsum(np.bincount(dev_s, minlength=self.E))))
            rows = xf.index_select(0, self._index(t_s))
            ready = self._record_ready()
            for e in range(self.E):
                sl = slice(bounds[e], bounds[e + 1])
                self._send_device(g, slot, layer, e, rows[sl], t_s[sl],
                                  k_s[sl], self._g2l[e, e_s[sl]], ready)
        finally:
            self._gate_exit()

    def _dispatch_eager(self, g: int, slot: int, layer: int,
                        xf: torch.Tensor, idx: np.ndarray,
                        valid: Optional[np.ndarray] = None):
        """Pre-fusion dispatch (the baseline): the token rows are read back
        to the host, then E boolean scans over the flat assignment arrays
        pick each device's rows there (still placement-routed, so the
        numerical contract holds on every policy).  Inside the dispatch
        gate, as `_dispatch` is."""
        self._gate_enter()
        try:
            xf_h = self._to_cpu(xf)
            flat_e, flat_t, flat_k, dev = self._flat_routing(idx, layer,
                                                             valid)
            for e in range(self.E):
                m = dev == e
                self._send_device(g, slot, layer, e,
                                  xf_h.index_select(0, torch.from_numpy(
                                      flat_t[m])),
                                  flat_t[m], flat_k[m],
                                  self._g2l[e, flat_e[m]], None)
        finally:
            self._gate_exit()

    def _combine(self, g: int, slot: int, h, xf, weights, shared):
        """async-combine-recv + weighted accumulation (token-order restore).

        Every (token, k) pair is served by exactly one device, so the expert
        outputs are WRITTEN (not added) into a [Tn, top_k, d] fp32 buffer by
        their token ids and then reduced over k in order 0..K-1: the same sum
        whatever order the devices answered in, and no atomics.  Against the
        reference, which adds in payload order, this reassociates an fp32
        sum of top_k terms (differences of a few ulp).
        `combine_path="host"` copies the outputs, weights and shared expert
        to the host and does the same write and the same multiply-then-add
        in numpy fp32: bit for bit the device combine.

        The wait is bounded by `region_timeout` (wall seconds): a region
        lost to a fault (a dropped dispatch or combine, a failover longer
        than the bound) surfaces as TimeoutError, and the group worker
        replays the batch through the retry path.  With spans on, the wait
        ("moe_wait") and the accumulation ("combine") carry the ids the
        group worker left in `_span_ids[g]`."""
        t_wait = time.monotonic_ns() if SPANS.on else 0
        payloads = self.attn_bufs[g][slot].combine_recv(
            timeout=self.region_timeout, stop=self.stop)
        ids = None
        if t_wait:
            # taken once: ids left by a batch-layer begun while spans were
            # off never label a later one
            t_acc = time.monotonic_ns()
            ids, self._span_ids[g] = self._span_ids[g], None  # race-ok: single-writer per group (group worker g)
            if ids:
                SPANS.add("moe_wait", t_wait, t_acc, **ids)
        Tn, d = xf.shape
        K = self.cfg.top_k
        host = self.combine_path == "host"
        layer = None
        buf = np.zeros((Tn * K, d), np.float32) if host else \
            torch.zeros((Tn * K, d), dtype=torch.float32, device=self.device)
        for p in payloads:
            if p.outputs is None or len(p.token_ids) == 0:
                continue
            layer = p.layer
            self._await(p.ready, p.outputs)
            pair = p.token_ids[:, 0] * K + p.token_ids[:, 1]
            if host:
                buf[pair] = self._to_host(p.outputs.float())
            else:
                buf.index_copy_(0, self._index(pair),
                                p.outputs.to(self.device).float())
        buf = buf.reshape(Tn, K, d)
        w = self._to_host(weights.float()) if host else weights
        if shared is not None:
            shared = self._to_host(shared.float()) if host else shared.float()
        # one expression for numpy and torch: the same products and sums in
        # the same order, each rounded on its own
        acc = buf[:, 0] * w[:, 0:1]
        for k in range(1, K):
            acc = acc + buf[:, k] * w[:, k:k + 1]
        if shared is not None:
            acc = acc + shared
        if host:
            acc = torch.from_numpy(acc).to(self.device)
        B, S, _ = h.shape
        self._logev("combine", g, slot, layer)
        out = h + acc.to(h.dtype).reshape(B, S, d)
        if ids:
            SPANS.add("combine", t_acc, time.monotonic_ns(), **ids)
        return out

    # ----------------------------------------------------------- moe worker
    def prewarm_buckets(self, max_rows: int):
        """Run the fused super-kernel FFN once for EVERY capacity bucket up
        to `round_capacity(max_rows)` on every device.  Call before serving
        (single-threaded: the caller owns all cells until workers start).
        The first launch builds and loads the kernel library, and each new
        bucket is a new buffer shape for the caching allocator; after this,
        every launch whose rows per expert stay under `max_rows` lands in an
        already-seen bucket -- visible as bucket_hits == launches in
        EngineStats.  A continuous batcher's merged drains reach larger
        buckets than one region: prewarm to the merged bound."""
        if self.moe_path != "fused":
            raise ValueError("prewarm_buckets runs the fused super-kernel "
                             "FFN; the eager path has none")
        top = round_capacity(max(int(max_rows), 1))
        for e in range(self.E):
            if self.resident[e] is None:
                continue
            n_e = len(self.dev_experts[e])
            # on worker e's own stream: the caching allocator keeps a pool
            # per stream, so only there do the touched buffers stay at hand
            with self._worker_context(self._moe_streams[e]):
                C = round_capacity(1)
                while C <= top:
                    xb = torch.zeros((n_e, C, self.cfg.d_model),
                                     dtype=self.cfg.dtype, device=self.device)
                    super_moe_ffn(self._lid[0:1], self.resident[e], xb,
                                  self.cfg)
                    self._seen_buckets[e].add(C)
                    C *= 2
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            _launch.note_host_sync()

    def _record_launch(self, e: int, C: int, n_regions: int, n_rows: int,
                       counts: np.ndarray):
        """Super-kernel launch telemetry.  Same ownership rule as moe_busy:
        the caller is worker e or the post-fence supervisor -- the cell's
        single writer at that moment."""
        n_e = len(self.dev_experts[e])
        self.moe_launches[e] += 1  # race-ok: single-writer (see _record_launch contract)
        self.moe_launch_regions[e] += n_regions  # race-ok: single-writer
        self.moe_launch_rows[e] += n_rows  # race-ok: single-writer
        self.moe_launch_slots[e] += n_e * C  # race-ok: single-writer
        seen = self._seen_buckets[e]
        if C in seen:
            self.bucket_hits[e] += 1  # race-ok: single-writer
        else:
            seen.add(C)
            self.bucket_misses[e] += 1  # race-ok: single-writer
        self._logev("launch", e, n_e, C, tuple(int(c) for c in counts),
                    n_regions)

    @staticmethod
    def _region_tokens(rows) -> torch.Tensor:
        """One region's token rows (its T payload rows, concatenated)."""
        return rows[0].tokens if len(rows) == 1 \
            else torch.cat([r.tokens for r in rows], 0)

    def _expert_ffn_fused_multi(self, e: int, layer: int, row_lists,
                                eid_list) -> List[torch.Tensor]:
        """ONE super-kernel FFN over one or more regions' rows of the same
        layer, merged into a shared capacity buffer: capacity-buffer pack ->
        `super_moe_ffn` -> unpack, all on the device.  The expert ids are
        host arrays, so the capacity bucket comes from host counts and the
        pack costs no host sync.  The per-expert row counts the kernel gets
        as device data are the SUM of the merged regions' dispatch counts:
        every expert's buffer is as long as the hottest expert's, and the
        kernel skips the padding beyond each count.  Returns one [n_r, d]
        output block per region, in input order.  The spans name the
        regions as `_compute` left them in `_span_regions[e]`."""
        t_pack = time.monotonic_ns() if SPANS.on else 0
        if t_pack:
            # taken once, as `_combine` takes its ids
            regions, self._span_regions[e] = self._span_regions[e], None  # race-ok: single-writer per device, as moe_busy
            t_pack = t_pack if regions is not None else 0
        n_e = len(self.dev_experts[e])
        for rows in row_lists:
            for r in rows:
                self._await(r.ready, r.tokens)
        xb, order, slots, C, bounds = pack_capacity_multi(
            [self._region_tokens(rows) for rows in row_lists], eid_list, n_e)
        counts = np.sum([rows[0].counts for rows in row_lists], 0)
        self._record_launch(e, C, len(row_lists), int(bounds[-1]), counts)
        if t_pack:
            ids = {"e": e, "regions": regions, "rows": int(bounds[-1]),
                   "C": C}
            t_launch = time.monotonic_ns()
            SPANS.add("pack", t_pack, t_launch, **ids)
        # layer-oblivious: `layer` selects a one-element DEVICE tensor; the
        # kernel reads it and indexes the resident all-layer stack itself
        yb = super_moe_ffn(
            self._lid[layer:layer + 1], self.resident[e], xb, self.cfg,
            torch.as_tensor(counts.astype(np.int32), device=self.device))
        if t_pack:
            t_unpack = time.monotonic_ns()
            SPANS.add("launch", t_launch, t_unpack, **ids)
        out = unpack_capacity_multi(yb, order, slots, bounds)
        if t_pack:
            SPANS.add("unpack", t_unpack, time.monotonic_ns(), **ids)
        return out

    def _expert_ffn_eager(self, e: int, layer: int, tokens: torch.Tensor,
                          eids: np.ndarray) -> torch.Tensor:
        """Pre-fusion per-expert loop (the baseline): the region's rows go
        to the device once, then for each local expert with rows three
        matmuls against that layer's weights and one device-to-host copy of
        its outputs.  tokens: [n, d] on the host -> [n, d] fp32 on the
        host."""
        res = self.resident[e]
        wg, wu, wd = (res[k][layer] for k in ("w_gate", "w_up", "w_down"))
        act = act_fn(self.cfg.act)
        xd = tokens.to(self.device)
        out = torch.zeros((len(tokens), tokens.shape[1]), dtype=torch.float32)
        for le in np.unique(eids):
            rows = np.nonzero(eids == le)[0]
            y = gated_ffn(xd.index_select(0, self._index(rows)), wg[le],
                          wu[le], wd[le], act)
            out[torch.from_numpy(rows)] = self._to_cpu(y.float())
        return out

    @staticmethod
    def _rows(entries) -> int:
        return sum(sum(len(r.tokens) for r in rows) for _, rows in entries)

    def _injected_sleep(self, e: int, gen: int, ev):
        """Interpret a stall_moe / delay_wake fault event: dead to the world
        for `duration` clock seconds.  A stall does NOT heartbeat (that is
        what the supervisor's stall detector keys on); a delayed wake DOES
        (benign latency -- no failover)."""
        self._logev("fault", ev.kind, e, ev.duration)
        t_end = self.clock() + ev.duration
        while self.clock() < t_end and not self.stop.is_set():
            # race-ok: fence read -- a failover mid-stall retired this
            # worker; exactness doesn't matter, the next take re-validates
            if self._moe_gen[e] != gen:
                return
            if ev.kind == "delay_wake":
                self._heartbeat[e] = self.clock()  # race-ok: single-writer (worker e stamps its own cell)
            time.sleep(0.001)

    def _drain_window(self, buf: MoEDeviceBuffer, admit, on_take):
        """Continuous-batching drain: block until the first complete
        region(s) arrive -- ONE atomic multi-take -- then keep accumulating
        arrivals until the window closes, all D regions are on board, or
        the merged row count reaches `moe_batch_max_tokens`.  The window is
        WALL seconds (`time.monotonic`, never `clock`, which may be a
        TraceClock): it bounds the queueing it adds.

        Accumulation is gap-based inside the window: each extra wait is at
        most a quarter of the window, and the first empty gap closes the
        batch.  A device's pending combines are what release the lagging
        groups' next regions, so waiting out the whole window for
        stragglers can stall the very arrivals it waits for.

        Returns the ordered (region, rows) list, or None on timeout
        (nothing pending), stop or fence -- on a fence, every taken entry is
        still published in `_moe_current`, so the supervisor's orphan
        re-serve covers the partial drain exactly once."""
        got = buf.recv_many(timeout=self.idle_backoff, stop=self.stop,
                            admit=admit, on_take=on_take)
        if got is None:
            return None
        entries = list(got)
        cap = self.moe_batch_max_tokens
        total = self._rows(entries)
        gap = self.moe_batch_window / 4.0
        deadline = time.monotonic() + self.moe_batch_window
        while len(entries) < self.D and (cap is None or total < cap):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            more = buf.recv_many(max_regions=self.D - len(entries),
                                 timeout=min(remaining, gap), stop=self.stop,
                                 admit=admit, on_take=on_take)
            if more is None:
                if self.stop.is_set() or not admit():
                    return None  # the fence handed the taken entries over
                break  # an empty gap: no region is imminent -- launch now
            entries.extend(more)
            total += self._rows(more)
        return entries

    def _chunk_by_row_cap(self, entries):
        """Split a drain into chunks of <= `moe_batch_max_tokens` merged rows
        (>= 1 region per chunk, so an oversized region still serves).  The
        first atomic multi-take can exceed the cap when several regions were
        already pending; taken regions must be served, so the bound is
        enforced here rather than by refusing the take."""
        cap = self.moe_batch_max_tokens
        if cap is None:
            return [entries]
        chunks, chunk, rows = [], [], 0
        for ent in entries:
            n = self._rows([ent])
            if chunk and rows + n > cap:
                chunks.append(chunk)
                chunk, rows = [], 0
            chunk.append(ent)
            rows += n
        if chunk:
            chunks.append(chunk)
        return chunks

    def _compute(self, e: int, entries):
        """The expert FFN of one chunk of regions on this thread's stream:
        group them by layer id and launch the super kernel ONCE per distinct
        layer over their merged capacity buffer (layer-major), then
        synchronise the stream ONCE.  A device with no experts only ever
        sees empty regions: nothing is launched.  Returns, per region in
        input order, (region, layer, slot, token_ids, eids, outputs), the
        outputs None for an empty region (an empty combine marker)."""
        prep = []  # (region, layer, slot, rows, token_ids, eids)
        for i, rows in entries:
            prep.append((i, rows[0].layer, rows[0].slot, rows,
                         np.concatenate([r.token_ids for r in rows], 0),
                         np.concatenate([r.expert_ids for r in rows], 0)))
        outs: Dict[int, Optional[torch.Tensor]] = {}
        by_layer: Dict[int, List[int]] = {}
        for j, p in enumerate(prep):
            if len(p[4]):
                by_layer.setdefault(p[1], []).append(j)
            else:
                outs[j] = None
        if by_layer:
            t0 = self.clock()
            for layer in sorted(by_layer):
                js = by_layer[layer]
                if self.moe_path == "fused":
                    if SPANS.on:
                        self._span_regions[e] = [  # race-ok: single-writer per device, as moe_busy
                            self._region(prep[j][0], prep[j][2], layer)
                            for j in js]
                    blocks = self._expert_ffn_fused_multi(
                        e, layer, [prep[j][3] for j in js],
                        [prep[j][5] for j in js])
                else:  # never batched: one region per drain
                    blocks = [self._expert_ffn_eager(
                        e, layer, self._region_tokens(prep[j][3]),
                        prep[j][5]) for j in js]
                outs.update(zip(js, blocks))
            # producer-side sync, one per chunk: the outputs are complete
            # when the combine flags go up, and the host-clocked busy time
            # below is device time
            t_sync = time.monotonic_ns() if SPANS.on else 0
            self._sync_stream()
            if t_sync:
                js = [j for js in by_layer.values() for j in js]
                SPANS.add("sync", t_sync, time.monotonic_ns(), e=e,
                          regions=[self._region(prep[j][0], prep[j][2],
                                                prep[j][1]) for j in js],
                          rows=sum(len(prep[j][4]) for j in js))
            self.moe_busy[e] += self.clock() - t0  # race-ok: single-writer (worker e, or the supervisor once e is fenced out)
        return [(i, layer, slot, tids, eids, outs[j])
                for j, (i, layer, slot, _, tids, eids) in enumerate(prep)]

    def _region(self, g: int, slot: int, layer: int) -> tuple:
        """A region's (bid, layer, g), as the MoE side's spans name it."""
        return (self._slot_bids[g][slot], layer, g)  # race-ok: read while this region is held, before its combine (see _slot_bids)

    def _release_region(self, e: int, gen: int, i: int) -> bool:
        """Remove region i from `_moe_current[e]` before its combine, under
        device e's buffer cv and only while generation `gen` still owns the
        device.  False: the worker was fenced out and the supervisor owns
        the cell (it re-serves every entry still present).  Checking and
        clearing under the cv the fence is bumped under makes the two
        atomic: either the entry goes and this worker's combine is the only
        one, or it stays and the supervisor's is."""
        def clear():
            if self._moe_gen[e] != gen:  # race-ok: runs under the buffer cv (fenced), atomic w.r.t. the fence bump
                return False
            rest = tuple(c for c in self._moe_current[e] or () if c[0] != i)  # race-ok: under the buffer cv, owner generation checked above
            self._moe_current[e] = rest or None  # race-ok: under the buffer cv, owner generation checked above
            return True
        return self.moe_bufs[e].fenced(clear)

    def _serve_batch(self, e: int, gen: int, entries):
        """Serve one chunk of a drain (`_compute`), then route every region's
        output block through the per-region exactly-once combine protocol:
        release ITS `_moe_current` entry BEFORE its combine_send with the
        fence re-checked, so a mid-batch failover re-serves exactly the
        regions whose combine never happened."""
        for i, layer, slot, token_ids, eids, out in self._compute(e,
                                                                  entries):
            t_send = time.monotonic_ns() if SPANS.on else 0
            self._logev("moe", e, i, slot, layer, len(token_ids))
            if not self._release_region(e, gen, i):
                continue  # fenced out: the failover re-serves this region
            inj = self.fault_injector
            if inj is not None and inj.should_drop_combine(e):
                # injected drop: the group's combine times out and the batch
                # replays -- the region is consumed exactly once
                self._logev("drop-combine", e, i, slot, layer)
                continue
            region = self._region(i, slot, layer) if t_send else None
            self.attn_bufs[i][slot].combine_send(
                e, CombinePayload(layer=layer, token_ids=token_ids,
                                  expert_ids=eids, outputs=out),
                stop=self.stop)
            if t_send:
                SPANS.add("combine_send", t_send, time.monotonic_ns(), e=e,
                          regions=[region], rows=len(token_ids))

    def _moe_worker(self, e: int, gen: int = 0):
        buf = self.moe_bufs[e]

        def admit():
            # evaluated by recv_any/recv_many under the buffer cv --
            # atomic w.r.t. the fence bump
            return self._moe_gen[e] == gen  # race-ok: read under the buffer cv

        def on_take(i, rows):
            # runs UNDER the buffer cv, after the rows migrated and before
            # the flags clear: in-flight state is published with no gap the
            # quiesce poll or the supervisor could observe.  APPENDS an
            # entry: the continuous batcher holds several taken-but-not-
            # combined regions at once (per-region mode never more than one)
            self._moe_active[e] = True  # race-ok: single-writer (worker e); set before the flags clear
            cur = self._moe_current[e]  # race-ok: single-writer until fenced (worker e)
            self._moe_current[e] = (cur or ()) + ((i, rows),)  # race-ok: published under the buffer cv; the supervisor reads it only after fencing this worker out

        try:
            with self._worker_context(self._moe_streams[e]):
                while True:
                    # race-ok: fence read -- cheap exit for a retired worker;
                    # the authoritative check is the take's admit under the cv
                    if self._moe_gen[e] != gen:
                        return
                    self._heartbeat[e] = self.clock()  # race-ok: single-writer (worker e stamps its own cell)
                    inj = self.fault_injector
                    if inj is not None:
                        ev = inj.poll_worker(e)
                        if ev is not None:
                            if ev.kind == "crash_moe":
                                raise InjectedFault(
                                    f"injected crash: moe device {e} "
                                    f"(scheduled t={ev.t})")
                            self._injected_sleep(e, gen, ev)
                            continue
                    t_recv = time.monotonic_ns() if SPANS.on else 0
                    if self.moe_batch_window > 0:
                        entries = self._drain_window(buf, admit, on_take)
                    else:
                        # block on "any region complete" + take it in ONE
                        # atomic step (a split wait/take would race the
                        # supervisor's failover evacuation)
                        got = buf.recv_any(timeout=self.idle_backoff,
                                           stop=self.stop, admit=admit,
                                           on_take=on_take)
                        entries = None if got is None else [got]
                    if entries is None:
                        if self.stop.is_set():
                            return
                        continue  # timeout or fence: the loop top decides
                    if t_recv:
                        SPANS.add("recv", t_recv, time.monotonic_ns(), e=e)
                    for chunk in self._chunk_by_row_cap(entries):
                        self._serve_batch(e, gen, chunk)
                    # after the WHOLE drain, not per chunk: a later chunk's
                    # regions are taken (their flags clear) but not served,
                    # and the quiesce must not read the device as idle
                    if self._moe_gen[e] == gen:  # race-ok: fence read; after a fence the supervisor owns the flag
                        self._moe_active[e] = False  # race-ok: single-writer (worker e); the drain's combines happened-before
        except AbortedError:
            return  # stop observed inside a buffer wait (shutdown/panic)
        except BaseException as ex:  # surface thread failures to the caller
            self._worker_failed(e, ex)

    # --------------------------------------------------------- group worker
    def _panic(self, ex: BaseException):
        """Surface a worker-thread failure to every waiter -- the last
        resort: under supervision a MoE worker that dies of a host-side
        cause goes through `_worker_failed` -> failover instead."""
        self.errors.append(ex)
        self.stop.set()
        with self._jobq_cv:
            self._jobq_cv.notify_all()
        with self._done_cv:
            self._done_cv.notify_all()
        for buf in self.moe_bufs:
            buf.wake()
        # release group workers parked in combine_recv and MoE workers
        # parked in combine_send backpressure: their stop-aware waits raise
        # AbortedError on the next wakeup instead of masking the original
        # failure with a protocol timeout
        for bufs in self.attn_bufs:
            for buf in bufs:
                buf.wake()

    def _worker_failed(self, e: int, exc: BaseException):
        """A MoE worker thread is dying.  Supervised, of a host-side cause
        (an injected crash, a Python error): record the cause and let the
        thread exit -- the supervisor detects the death and fails the
        device over.  A CUDA error is not a device failure: the E devices
        are threads sharing ONE CUDA context, and a sticky error (illegal
        address, launch failure) breaks every one of them, so failing over
        onto the same context would hang or compute garbage -- it panics,
        as does any failure when unsupervised."""
        if not self.supervise or _is_cuda_error(exc):
            self._panic(exc)
            return
        self._moe_fail_exc[e] = exc  # race-ok: written once by dying worker e; the supervisor reads it only after observing the thread dead
        self._logev("worker-died", e, type(exc).__name__)

    def _take_job(self, g: int, timeout: float = 0.0) -> Optional[BatchJob]:
        """Pop the oldest admitted job this group may serve (un-pinned or
        pinned to g).  `timeout` > 0 blocks until one arrives -- the pull
        model IS the least-loaded assignment: whichever group frees a slot
        first takes the head of the shared queue."""
        deadline = time.monotonic() + timeout if timeout > 0 else None
        with self._jobq_cv:
            while True:
                for i, job in enumerate(self._jobq):
                    if job.group is None or job.group == g:
                        job = self._jobq.pop(i)
                        job.group = g  # record the measured assignment
                        return job
                if deadline is None or self.stop.is_set():
                    return None
                wait = deadline - time.monotonic()
                if wait <= 0:
                    return None
                self._jobq_cv.wait(wait)

    def _group_worker(self, g: int):
        """Persistent serving loop of one attention DP group: pull jobs from
        the shared admission queue into free dual-batch slots, run the
        attention+dispatch/combine state machine, report completions out of
        order via `on_complete`, repeat until the engine closes."""
        try:
            with self._worker_context(self._group_streams[g]):
                self._group_loop(g)
        except AbortedError:
            return  # stop observed inside a buffer wait (shutdown/panic)
        except BaseException as ex:
            self._panic(ex)

    def _group_loop(self, g: int):
        fused = self.moe_path == "fused"
        step = self._attn_step if fused else self._attn_part
        dispatch = self._dispatch if fused else self._dispatch_eager
        active: List[Dict[str, Any]] = []
        free_slots = [0, 1] if self.interleave else [0]
        seq = 0
        while not self.stop.is_set():
            # admit into free slots; block (bounded) only when idle
            while free_slots:
                job = self._take_job(
                    g, timeout=0.0 if active else (self.idle_backoff or 0.05))
                if job is None:
                    break
                if job.t_started is None:
                    job.t_started = self.clock()
                slot = free_slots.pop(0)
                self._slot_bids[g][slot] = job.bid  # race-ok: single-writer (group worker g), see _slot_bids
                tok = np.asarray(job.tokens)
                # valid-position mask: pad rows compute but don't count
                # toward measured router stats
                valid = None
                if job.lengths is not None:
                    valid = (np.arange(tok.shape[1])[None, :]
                             < np.asarray(job.lengths)[:, None]).reshape(-1)
                active.append({"job": job, "h": self._embed(job), "layer": 0,
                               "phase": "attn", "slot": slot,
                               "ctx": None, "seq": 0, "valid": valid,
                               "kv": []})
            if not active:
                continue  # idle: loop back into the blocking take
            # run attention+dispatch for every slot that is ready
            for st in active:
                if st["phase"] != "attn":
                    continue
                t0 = self.clock()
                t_attn = time.monotonic_ns() if SPANS.on else 0
                h, xf, w, idx, shared, kv = step(st["layer"], st["h"])
                if t_attn:
                    ids = {"bid": st["job"].bid, "layer": st["layer"],
                           "slot": st["slot"], "g": g}
                    t_read = time.monotonic_ns()
                    SPANS.add("attn", t_attn, t_read, **ids)
                if self.emit_kv:
                    st["kv"].append(kv)
                # the one device-to-host read of the batch-layer: the router's
                # expert ids, which placement routing needs on the host (the
                # wait also makes the clocked time below device time)
                idx_np = self._to_host(idx)
                if t_attn:
                    SPANS.add("router_read", t_read, time.monotonic_ns(),
                              **ids)
                dt = self.clock() - t0
                st["job"].kernel_time += dt
                self.group_busy[g] += dt  # race-ok: single-writer (group worker g accumulates its own cell)
                st["h"] = h
                st["ctx"] = (xf, w, shared)
                self._logev("attn", g, st["slot"], st["layer"],
                            tuple(h.shape[:2]))
                t_disp = time.monotonic_ns() if t_attn else 0
                dispatch(g, st["slot"], st["layer"], xf, idx_np, st["valid"])
                if t_disp:
                    SPANS.add("dispatch", t_disp, time.monotonic_ns(), **ids)
                st["phase"] = "wait"
                st["seq"] = seq = seq + 1
            # block on the oldest outstanding combine
            waiting = [s for s in active if s["phase"] == "wait"]
            if not waiting:
                continue
            st = min(waiting, key=lambda s: s["seq"])
            xf, w, shared = st["ctx"]
            t0 = self.clock()
            if SPANS.on:
                self._span_ids[g] = {"bid": st["job"].bid,  # race-ok: single-writer per group (group worker g)
                                     "layer": st["layer"],
                                     "slot": st["slot"], "g": g}
            try:
                st["h"] = self._combine(g, st["slot"], st["h"], xf, w,
                                        shared)
            except TimeoutError:
                st["job"].comm_time += self.clock() - t0
                self._retry_or_fail(g, st, active, free_slots)
                continue
            st["job"].comm_time += self.clock() - t0
            st["layer"] += 1
            if st["layer"] >= self.L:
                job = st["job"]
                t0 = self.clock()
                t_final = time.monotonic_ns() if SPANS.on else 0
                result = apply_norm(st["h"], self.params["final_norm"],
                                    self.cfg)
                if st["kv"]:
                    job.kv = self._gather_kv(job, st["kv"])
                # the result leaves this thread's stream (the caller reads
                # it): one host sync per JOB, not per batch-layer
                self._sync_stream()
                job.result = result
                dt = self.clock() - t0
                job.kernel_time += dt
                self.group_busy[g] += dt  # race-ok: single-writer (group worker g accumulates its own cell)
                if t_final:
                    SPANS.add("final", t_final, time.monotonic_ns(),
                              bid=job.bid, g=g)
                job.t_finished = self.clock()
                if t_final:
                    self._executor_span(job)
                free_slots.append(st["slot"])
                active.remove(st)
                if self.on_complete is not None:
                    self.on_complete(job)  # streaming completion hook
                with self._done_cv:
                    self._done_cv.notify_all()
            else:
                st["phase"] = "attn"

    def _executor_span(self, job: BatchJob):
        """The job's "executor" span, from its start on a group to its
        finish, on the spans' clock."""
        SPANS.add("executor", clock_ns(self.clock, job.t_started),
                  clock_ns(self.clock, job.t_finished), bid=job.bid,
                  g=job.group)

    def _embed(self, job: BatchJob) -> torch.Tensor:
        return embed_tokens(self.params,
                            torch.as_tensor(np.asarray(job.tokens),
                                            device=self.device),
                            None, self.cfg)

    # ------------------------------------------------------------ fault retry
    def _scrub_group_slot(self, g: int, slot: int):
        """Quiesce-then-scrub one (group, slot) protocol lane after a region
        timeout.  Wait until no MoE buffer holds rows for region g AND no
        device is mid-serve on region g (a take publishes `_moe_current`
        under the buffer cv before the flags clear, so the two checks in
        THIS order cannot miss an in-flight take); every combine_send for
        the lane has then happened-before, and whatever partial combine
        state is parked in the slot's buffer can be dropped without a late
        stale segment corrupting the replay."""
        deadline = time.monotonic() + 4 * (self.region_timeout or 60.0)
        while True:
            if self.stop.is_set():
                raise AbortedError("scrub aborted: executor stopping")
            busy = False
            for e in range(self.E):
                if self.moe_bufs[e].flags[g].any_set():
                    busy = True
                    break
                # race-ok: checked AFTER the flags -- a take publishes
                # _moe_current under the cv BEFORE clearing the flags, so a
                # region-g take invisible here would still have shown set
                # flags above; a stale non-None read just polls again
                cur = self._moe_current[e]
                if cur is not None and any(c[0] == g for c in cur):
                    busy = True
                    break
            if not busy:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"scrub: region {g} did not quiesce -- MoE device wedged "
                    f"with supervision unable to evacuate it")
            time.sleep(0.002)
        self.attn_bufs[g][slot].scrub()
        self._logev("scrub", g, slot)

    def _retry_or_fail(self, g: int, st: Dict[str, Any], active, free_slots):
        """A region timed out (a dropped dispatch/combine or a failover
        longer than region_timeout): scrub the lane and replay the batch
        from layer 0 with capped backoff -- re-embedded on this group's
        stream, its KV list emptied.  Replays are idempotent: the scrub
        guarantees no stale segment survives, and re-served regions resolve
        first-combine-wins.  Past `max_job_retries` the job fails
        TERMINALLY (job.failed set, result None), which the engine maps to
        status "failed"."""
        job = st["job"]
        job.retries += 1
        self._logev("region-timeout", g, st["slot"], st["layer"], job.retries)
        self._scrub_group_slot(g, st["slot"])
        if job.retries > self.max_job_retries:
            job.failed = (f"region timeout at layer {st['layer']} after "
                          f"{job.retries - 1} replays")
            job.result = None
            job.t_finished = self.clock()
            if SPANS.on:
                self._executor_span(job)
            free_slots.append(st["slot"])
            active.remove(st)
            if self.on_complete is not None:
                self.on_complete(job)
            with self._done_cv:
                self._done_cv.notify_all()
            return
        # capped exponential backoff (wall seconds): give an in-progress
        # failover time to land before redispatching into the same hole
        time.sleep(min(0.05 * (2 ** (job.retries - 1)), 0.5))
        st["h"] = self._embed(job)
        st["layer"] = 0
        st["phase"] = "attn"
        st["ctx"] = None
        st["kv"] = []  # the replay re-emits every layer's KV from scratch

    def _gather_kv(self, job: BatchJob, layers: List[tuple]) -> List[tuple]:
        """Per batch row, its [L, len, kvh, hd] K and V as contiguous tensors
        on this thread's stream, plus the event marking them written (the
        decode runtime reads them on another stream)."""
        S = layers[0][0].shape[1]
        lengths = job.lengths or [S] * layers[0][0].shape[0]
        rows = [(torch.stack([k[i, :n] for k, _ in layers]),
                 torch.stack([v[i, :n] for _, v in layers]))
                for i, n in enumerate(lengths)]
        ready = self._record_ready()
        return [(k, v, ready) for k, v in rows]

    def reset_stats(self):
        """Zero the busy-time and launch telemetry and drop the event log
        (between serving waves of one long-lived executor; workers stopped).
        What was learned stays: the seen capacity buckets, the dispatched
        load the replica routing balances on."""
        if self._started:
            raise RuntimeError("reset_stats() while the workers run")
        # race-ok: no worker threads are running (checked above)
        for cell in (self.moe_busy, self.group_busy, self.moe_launches,
                     self.moe_launch_regions, self.moe_launch_rows,
                     self.moe_launch_slots, self.bucket_hits,
                     self.bucket_misses):
            cell[:] = 0
        with self._log_lock:
            self.log.clear()
        self._t_serving_start = None

    # ------------------------------------------------- live re-placement
    def apply_placement(self, placement: Placement,
                        expert_fractions: Optional[Sequence[float]] = None,
                        timeout: float = 60.0) -> Dict[str, Any]:
        """Re-place experts LIVE, between polls, without restarting workers:

          1. freeze the dispatch gate and wait for in-flight dispatches to
             finish (a swap must never split a batch-layer's E sends across
             two routing tables);
          2. quiesce the AFFECTED MoE devices: with no new dispatches, each
             drains its buffered regions -- their payloads carry local
             expert ids of the old tables and must be served by the old
             resident stacks.  Unaffected devices keep serving, and the
             attention groups keep computing and combining: this is not a
             global barrier;
          3. build the affected devices' new resident stacks on this
             thread's stream (views where the held experts form an
             arithmetic progression, gathered copies otherwise) and
             synchronise that stream: the survivors' workers read the new
             stacks on their own streams;
          4. swap `placement`/`table`/`dev_experts`/`resident` and the
             dispatch lookups atomically, and release the gate.

        Returns the migration record also appended to `self.migrations`:
        its `bytes` count the gained expert copies, at the model's element
        size.  Serialized by `_swap_lock` with the supervisor's failover.
        A device the supervisor declared dead stays dead: a placement made
        before its failover (a rebalance tick that raced it) is installed
        with that device failed."""
        with self._swap_lock:
            for d in self.placement.dead:
                placement = placement.fail(d)
            return self._apply_placement_locked(placement, expert_fractions,
                                                timeout)

    def _apply_placement_locked(self, placement: Placement,
                                expert_fractions: Optional[Sequence[float]]
                                = None,
                                timeout: float = 60.0,
                                drain_hook=None,
                                kind: str = "rebalance") -> Dict[str, Any]:
        """apply_placement's body; the caller holds `_swap_lock`.
        `drain_hook` (the failover path) runs between drain polls OUTSIDE
        the gate cv: it serves the dead device's buffered regions with the
        OLD resident stack, which both empties them before the swap
        invalidates their local expert ids AND un-wedges any dispatcher
        blocked on the dead device's backpressure (that dispatcher holds
        the gate open)."""
        fr = tuple(float(x) for x in expert_fractions) \
            if expert_fractions is not None else self.expert_fractions
        if len(fr) != self.cfg.num_experts:
            raise ValueError(f"expert_fractions has {len(fr)} entries for "
                             f"{self.cfg.num_experts} experts")
        new_table = placement.table(fr, self.E)
        new_dev = placement.device_experts(fr, self.E)
        moved = [(x, d) for x, hosts in enumerate(new_table)
                 for d in hosts if d not in self.table[x]]
        affected = [e for e in range(self.E)
                    if new_dev[e] != self.dev_experts[e]]
        t0 = self.clock()
        if new_table == self.table:
            # same layout (maybe refreshed popularity): nothing to quiesce,
            # but the no-op still lands in the log
            self.placement, self.expert_fractions = placement, fr
            rec = {"t": t0, "seconds": 0.0, "moved_copies": 0, "bytes": 0.0,
                   "devices": (), "policy": placement.policy, "kind": kind}
            self.migrations.append(rec)
            return rec

        def _check_alive(deadline: float, phase: str):
            if self.errors:
                raise RuntimeError(
                    f"apply_placement during {phase}: executor thread "
                    f"failed") from self.errors[0]
            if drain_hook is None and self._started \
                    and not self.stop.is_set():
                # a rebalance: a worker that died since (and is not yet
                # failed over) never drains, and its supervisor waits for
                # the lock this swap holds -- give way to the failover
                # (_moe_threads[e] is replaced only after a failover marked
                # e dead, so a dead thread of a live device is a new death)
                down = [e for e in range(self.E)
                        if e not in self.placement.dead
                        and not self._moe_threads[e].is_alive()]
                if down:
                    raise SwapAborted(
                        f"apply_placement during {phase}: moe device(s) "
                        f"{down} died; their failover goes first")
            if self.stop.is_set():
                raise RuntimeError(f"apply_placement during {phase}: "
                                   f"executor is stopping")
            if time.monotonic() > deadline:
                raise TimeoutError(f"apply_placement: {phase} did not "
                                   f"quiesce within {timeout}s")

        deadline = time.monotonic() + timeout
        _check_alive(deadline, "the start")
        with self._gate_cv:
            self._gate_frozen = True
        try:
            while True:
                with self._gate_cv:
                    if self._dispatchers == 0:
                        break
                    if drain_hook is None:
                        self._gate_cv.wait(0.05)
                _check_alive(deadline, "dispatch drain")
                if drain_hook is not None:
                    # failover: a dispatcher may be wedged on the DEAD
                    # device's backpressure -- serving its regions (outside
                    # the gate cv) is what lets that dispatcher finish
                    drain_hook()
                    time.sleep(0.001)
            for e in affected:
                # race-ok: quiesce poll -- a stale read just polls again; the
                # gate freeze guarantees no NEW dispatch can re-set either
                while self.moe_bufs[e].any_pending() or self._moe_active[e]:
                    _check_alive(deadline, f"moe device {e} drain")
                    if drain_hook is not None:
                        drain_hook()
                    time.sleep(0.001)
            nbytes = 0.0
            resident = {}
            t_copy = self.clock()
            for e in affected:
                gained = [x for x in new_dev[e]
                          if x not in self.dev_experts[e]]
                nbytes += self.expert_copy_bytes * self.L * len(gained)
                resident[e] = self._resident_stack(new_dev[e]) \
                    if len(new_dev[e]) else None
            # the new stacks were written on this thread's stream; the
            # survivors' workers read them on their own
            self._sync_stream()
            copy_seconds = self.clock() - t_copy
            # atomic swap: the gate is frozen and the affected devices are
            # idle, so no reader observes a mix of old and new tables
            self.placement, self.expert_fractions = placement, fr
            self.table, self.dev_experts = new_table, new_dev
            self._primary, self._replicated, self._g2l = \
                self._dispatch_lookups(new_table, new_dev)
            for e in affected:
                self.resident[e] = resident[e]
                # n_e changed: every capacity buffer is a new shape, and its
                # first launch counts as a bucket miss (workers for
                # `affected` are quiesced behind the frozen gate)
                self._seen_buckets[e] = set()
        finally:
            with self._gate_cv:
                self._gate_frozen = False
                self._gate_cv.notify_all()
        dt = self.clock() - t0
        # what the device really copied: a gathered stack is a new tensor (a
        # view of the model's stacks copies nothing); each of its bytes was
        # read once and written once, in `copy_seconds`
        model = {self._experts[k].untyped_storage().data_ptr()
                 for k in self._experts}
        copied = sum(v.numel() * v.element_size()
                     for st in resident.values() if st is not None
                     for v in st.values()
                     if v.untyped_storage().data_ptr() not in model)
        rec = {"t": self.clock(), "seconds": dt, "moved_copies": len(moved),
               "bytes": nbytes, "devices": tuple(affected),
               "policy": placement.policy, "kind": kind,
               "copy_bytes": float(copied), "copy_seconds": copy_seconds}
        self.migrations.append(rec)
        self.migrated_bytes += nbytes
        # the re-placement occupies the receiving devices (the weight
        # copies); split the measured stall across them for the stats
        self.moe_busy[affected] += dt / len(affected)  # race-ok: workers for `affected` are parked behind the frozen gate here
        self._logev("migrate", tuple(affected), len(moved))
        return rec

    # ---------------------------------------------- supervision & failover
    def arm_faults(self, plan: FaultPlan, t0: Optional[float] = None):
        """Install and arm a deterministic fault plan against this
        executor's clock.  The engine passes `t0=0.0` (its TraceClock is
        already zero-based); a bare executor anchors the plan at the current
        clock reading."""
        inj = FaultInjector(plan, self.E)
        inj.arm(self.clock, t0=t0)
        self.fault_injector = inj
        return inj

    def _fence_worker(self, e: int) -> int:
        """Bump device e's generation under its buffer cv and return the NEW
        generation.  After the bump the old worker can neither take another
        region (the take re-validates the fence under the same cv) nor
        release one for its combine (`_release_region` checks under it
        too); ownership of `_moe_current[e]` passes to the supervisor."""
        def bump():
            self._moe_gen[e] += 1  # race-ok: runs under the buffer cv (fenced) -- atomic w.r.t. the take's admission
            return self._moe_gen[e]  # race-ok: same fenced scope as the bump above

        return self.moe_bufs[e].fenced(bump)

    def _serve_region(self, e: int, i: int, rows) -> None:
        """Failover path: compute one orphaned region with device e's OLD
        resident stack on the supervisor's stream (Super Kernel launches,
        like a worker's; the stream is synchronised before the combine) and
        combine it to its group -- unless the group already holds device
        e's segment (first combine wins: the worker may have sent before
        dying)."""
        (_, layer, slot, token_ids, eids, out), = self._compute(e,
                                                                [(i, rows)])
        self._logev("moe-failover", e, i, slot, layer, len(token_ids))
        abuf = self.attn_bufs[i][slot]
        if abuf.has_segment(e):
            return  # the dead worker's combine landed first -- keep it
        try:
            abuf.combine_send(
                e, CombinePayload(layer=layer, token_ids=token_ids,
                                  expert_ids=eids, outputs=out),
                timeout=1.0, stop=self.stop)
        except TimeoutError:
            # segment held by a batch-layer the group has already timed out
            # and moved past -- drop it; the group's replay re-covers it
            self._logev("combine-skipped", e, i, slot, layer)

    def _serve_orphans(self, e: int) -> int:
        """Serve device e's in-flight regions (taken, never combined) plus
        every complete region still buffered for it, each exactly once, on
        the supervisor's thread.  The caller holds `_swap_lock` and has
        fenced worker e out.  Publishes `_moe_current[e]` while serving, so
        `_scrub_group_slot` sees the supervisor's in-flight work exactly
        like a worker's."""
        served = 0
        # race-ok: worker e is fenced out -- the supervisor owns the cell.
        # An entry still present proves the worker's combine for that region
        # never happened (each entry is released BEFORE its combine_send),
        # so re-serving every remaining entry is exactly-once; a fenced
        # continuous batcher may leave several (its partial drain).
        cur = self._moe_current[e]
        if cur is not None:
            for i, rows in cur:
                self._serve_region(e, i, rows)
                served += 1
            self._moe_current[e] = None  # race-ok: supervisor-owned after the fence

        def on_take(i, rows):
            # race-ok: published under the buffer cv; supervisor-owned after
            # the fence (scrub protocol: set before the flags clear)
            self._moe_current[e] = ((i, rows),)

        while True:
            got = self.moe_bufs[e].recv_any(timeout=0, on_take=on_take)
            if got is None:
                return served
            self._serve_region(e, *got)
            self._moe_current[e] = None  # race-ok: supervisor-owned after the fence
            served += 1

    def _failover(self, e: int, reason: str):
        """Supervised recovery of MoE device e: fence the old worker out,
        serve its orphaned regions exactly once, evacuate its experts onto
        the survivors through the live re-placement swap (`Placement.fail`,
        replica-first), then restart the worker at the new generation.
        Holds `_swap_lock` end to end so no other swap interleaves with the
        evacuation."""
        self._logev("failover-begin", e, reason, self.clock())
        with self._swap_lock:
            gen = self._fence_worker(e)
            self._serve_orphans(e)
            # the fenced worker can no longer flip this; in-flight ownership
            # passed to the supervisor and its serving is done, so the
            # quiesce poll below must not wait on it
            self._moe_active[e] = False  # race-ok: worker e fenced out; the supervisor is the only writer until the restart below
            self._apply_placement_locked(
                self.placement.fail(e),
                expert_fractions=self.expert_fractions, timeout=60.0,
                drain_hook=lambda: self._serve_orphans(e), kind="failover")
            old = self._moe_threads[e]
            if old.is_alive():
                # a stalled (not dead) worker: fenced out, it exits at its
                # next fence check; joined at close()
                self._retired.append(old)
            self._moe_restarts[e] += 1  # race-ok: supervisor single-writer
            self.failovers += 1  # race-ok: supervisor single-writer
            self._logev("failover", e, reason, self._moe_restarts[e],  # race-ok: supervisor single-writer
                        self.clock())
        # restart OUTSIDE _swap_lock: Thread.start() blocks on the thread's
        # internal started event (a condition wait the lockdep sanitizer
        # rightly flags under a held lock).  Only the supervisor writes
        # _moe_threads[e] after startup, so the gap is single-threaded.
        nt = threading.Thread(
            target=self._moe_worker, args=(e, gen),
            name=f"moe-{e}-r{self._moe_restarts[e]}", daemon=True)  # race-ok: supervisor single-writer
        self._moe_threads[e] = nt
        nt.start()
        cb = self.on_failover
        if cb is not None:
            cb(e)  # outside _swap_lock: a callback that re-places experts
            # takes it again

    def _supervisor_loop(self):
        """Detect dead or stalled MoE workers and fail them over, on the
        supervisor's own stream.  Panics only as a last resort: restart
        budget exhausted, or the failover machinery itself failing."""
        try:
            with self._worker_context(self._sup_stream):
                while not self.stop.is_set():
                    for e in range(self.E):
                        dead = not self._moe_threads[e].is_alive()
                        # race-ok: heartbeat/_moe_active/any_pending reads
                        # are a detection heuristic -- a stale read only
                        # delays or re-confirms detection by one 20 ms tick
                        stalled = (
                            self.stall_timeout is not None
                            and self.clock() - self._heartbeat[e]
                            > self.stall_timeout
                            and (self._moe_active[e]
                                 or self.moe_bufs[e].any_pending()))
                        if not (dead or stalled):
                            continue
                        if self.stop.is_set():
                            return  # shutdown, not a fault
                        if self._moe_restarts[e] >= self.max_worker_restarts:  # race-ok: supervisor single-writer
                            # race-ok: supervisor single-writer (_moe_restarts);
                            # _moe_fail_exc read after the worker was seen dead
                            raise RuntimeError(
                                f"moe device {e} "
                                f"{'died' if dead else 'stalled'} with "
                                f"restart budget exhausted "
                                f"({self._moe_restarts[e]}/"
                                f"{self.max_worker_restarts})"
                            ) from self._moe_fail_exc[e]
                        self._failover(e, "died" if dead else "stalled")
                    self.stop.wait(0.02)
        except BaseException as ex:
            if self.stop.is_set():
                return  # racing a shutdown: close() owns the teardown
            self._panic(ex)

    # ------------------------------------------------- engine lifecycle/run
    def ensure_started(self):
        """Spawn the persistent worker set once; raise instead of racing a
        wedged engine (thread failure or a timed-out wave still in flight)."""
        if self.errors:
            raise RuntimeError("executor reused after a thread failure") \
                from self.errors[0]
        self._hung = [t for t in self._hung if t.is_alive()]
        if self._hung:
            # a timed-out wave left live threads sharing our buffers --
            # submitting more work would race them mid-protocol
            raise RuntimeError(
                "executor reused while thread(s) from a timed-out run are "
                f"still alive: {[t.name for t in self._hung]}")
        if self._started:
            return
        self.stop.clear()
        if self.device.type == "cuda":
            # params and resident stacks were written on the caller's
            # stream; the workers read them on their own
            torch.cuda.synchronize(self.device)
            _launch.note_host_sync()
        if self._t_serving_start is None:
            self._t_serving_start = self.clock()
        now = self.clock()
        for e in range(self.E):
            self._heartbeat[e] = now  # race-ok: no worker threads are running yet
        # race-ok: no worker threads are running yet -- each worker starts at
        # the generation a prior run's failovers last left its device at
        self._moe_threads = [
            threading.Thread(target=self._moe_worker,
                             args=(e, self._moe_gen[e]),
                             name=f"moe-{e}", daemon=True)
            for e in range(self.E)]
        self._g_threads = [
            threading.Thread(target=self._group_worker, args=(g,),
                             name=f"group-{g}", daemon=True)
            for g in range(self.D)]
        for t in self._moe_threads + self._g_threads:
            t.start()
        if self.supervise:
            # spawned LAST: every thread it monitors is already alive
            self._sup_thread = threading.Thread(
                target=self._supervisor_loop, name="moe-supervisor",
                daemon=True)
            self._sup_thread.start()
        self._started = True

    def submit_job(self, job: BatchJob) -> BatchJob:
        """Admit one batch job (engine path).  Un-pinned jobs go to the
        least-loaded group (pull model); `job.group` pins (run() shim)."""
        self.ensure_started()
        if job.t_submitted is None:
            job.t_submitted = self.clock()
        with self._jobq_cv:
            self._jobq.append(job)
            self._jobq_cv.notify_all()
        return job

    def wait_jobs(self, jobs: Sequence[BatchJob],
                  timeout: Optional[float] = None) -> bool:
        """Block until every job in `jobs` completed (or a worker died).
        Returns False on timeout."""
        with self._done_cv:
            ok = self._done_cv.wait_for(
                lambda: bool(self.errors)
                or all(j.result is not None or j.failed is not None
                       for j in jobs), timeout)
        if self.errors:
            raise RuntimeError("executor thread failed") from self.errors[0]
        return bool(ok)

    def _stop_and_join(self, timeout: float) -> List[threading.Thread]:
        """Set stop, wake every waiter, join the workers; returns the
        threads still alive after `timeout` seconds in all."""
        self.stop.set()
        with self._jobq_cv:
            self._jobq_cv.notify_all()
        with self._done_cv:
            self._done_cv.notify_all()
        for buf in self.moe_bufs:
            buf.wake()  # prompt exit for workers idling in recv_any
        for bufs in self.attn_bufs:
            for buf in bufs:
                buf.wake()  # release combine_recv/combine_send blockers
        grace = time.monotonic() + timeout
        sup = [self._sup_thread] if self._sup_thread is not None else []
        # the supervisor first: a failover in progress writes _moe_threads
        # and _retired, so the lists below are final only once it exited
        for t in sup:
            t.join(timeout=max(grace - time.monotonic(), 1e-3))
        threads = self._g_threads + self._moe_threads + self._retired + sup
        for t in threads:
            t.join(timeout=max(grace - time.monotonic(), 1e-3))
        alive = [t for t in threads if t.is_alive()]
        self._hung += alive
        self._g_threads, self._moe_threads = [], []
        self._retired, self._sup_thread = [], None
        self._started = False
        if not alive:
            self.stop.clear()  # a clean stop is restartable; with
            # survivors, `stop` must STAY set so a zombie that later escapes
            # a blocked combine exits instead of serving again
        return alive

    def close(self, timeout: float = 30.0):
        """Stop the persistent workers and join them.  Drain first (the
        engine does) -- a close with work in flight abandons it."""
        if not self._started:
            return
        alive = self._stop_and_join(timeout)
        if alive:
            raise TimeoutError(f"executor close: thread(s) "
                               f"{[t.name for t in alive]} did not exit "
                               f"within {timeout}s")

    def run(self, jobs_per_group: List[List[BatchJob]],
            timeout: float = 300.0) -> List[BatchJob]:
        """One-shot shim over the engine: pin each job to its hand-chosen
        group, submit the wave, block until it completes, then release the
        worker set."""
        if len(jobs_per_group) != self.D:
            raise ValueError(f"run() takes one job list per group "
                             f"({self.D}), got {len(jobs_per_group)}")
        self.ensure_started()
        jobs: List[BatchJob] = []
        for g, js in enumerate(jobs_per_group):
            for j in js:
                j.group = g
                j.result = None
                j.t_started = j.t_finished = None
                j.kernel_time = j.comm_time = 0.0
                jobs.append(j)
        for j in jobs:
            self.submit_job(j)
        if self.wait_jobs(jobs, timeout):
            self.close()  # idle workers join promptly; one-shot semantics
            return jobs
        # a hung wave must NOT silently return jobs with result=None -- stop
        # the engine, reap what exits, and refuse reuse while survivors
        # still share our buffers; report thread state + the protocol tail
        alive = self._stop_and_join(2.0)
        with self._log_lock:
            tail = self.log[-6:]
        raise TimeoutError(
            f"executor run exceeded {timeout}s: thread(s) "
            f"{[t.name for t in alive] or 'none'} still alive; last "
            f"protocol events: {tail}")
