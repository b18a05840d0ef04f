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
also makes their host-clocked busy time real device time.
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
from repro_torch.kernels import _launch
from repro_torch.kernels.super_gmm.ops import (pack_capacity_multi,
                                               round_capacity, super_moe_ffn,
                                               unpack_capacity_multi)
from repro_torch.models.attention import attention_forward, attention_prefill
from repro_torch.models.common import ModelConfig, act_fn, apply_norm
from repro_torch.models.lm import embed_tokens, layer_slice, lm_stages
from repro_torch.models.moe import gated_ffn, router_topk


@dataclasses.dataclass
class BatchJob:
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
    failed: Optional[str] = None  # terminal failure reason (result stays None)
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
                 region_timeout: float = 240.0,
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
        self.region_timeout = region_timeout  # wall s: combine_recv bound
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
        # only worker e writes device e's cell; readers tolerate a stale sum.
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
        boolean scans, no token row crosses to the host."""
        flat_e, flat_t, flat_k, dev = self._flat_routing(idx, layer, valid)
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
            self._send_device(g, slot, layer, e, rows[sl], t_s[sl], k_s[sl],
                              self._g2l[e, e_s[sl]], ready)

    def _dispatch_eager(self, g: int, slot: int, layer: int,
                        xf: torch.Tensor, idx: np.ndarray,
                        valid: Optional[np.ndarray] = None):
        """Pre-fusion dispatch (the baseline): the token rows are read back
        to the host, then E boolean scans over the flat assignment arrays
        pick each device's rows there (still placement-routed, so the
        numerical contract holds on every policy)."""
        xf_h = self._to_cpu(xf)
        flat_e, flat_t, flat_k, dev = self._flat_routing(idx, layer, valid)
        for e in range(self.E):
            m = dev == e
            self._send_device(g, slot, layer, e,
                              xf_h.index_select(0, torch.from_numpy(
                                  flat_t[m])),
                              flat_t[m], flat_k[m], self._g2l[e, flat_e[m]],
                              None)

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

        The wait is bounded by `region_timeout` (wall seconds); a lost region
        surfaces as TimeoutError and stops the executor."""
        payloads = self.attn_bufs[g][slot].combine_recv(
            timeout=self.region_timeout, stop=self.stop)
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
        return h + acc.to(h.dtype).reshape(B, S, d)

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

    def _record_launch(self, e: int, C: int, n_regions: int, n_rows: int,
                       counts: np.ndarray):
        """Super-kernel launch telemetry.  Same ownership rule as moe_busy:
        the caller is worker e -- the cell's single writer."""
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
        output block per region, in input order."""
        n_e = len(self.dev_experts[e])
        for rows in row_lists:
            for r in rows:
                self._await(r.ready, r.tokens)
        xb, order, slots, C, bounds = pack_capacity_multi(
            [self._region_tokens(rows) for rows in row_lists], eid_list, n_e)
        counts = np.sum([rows[0].counts for rows in row_lists], 0)
        self._record_launch(e, C, len(row_lists), int(bounds[-1]), counts)
        # layer-oblivious: `layer` selects a one-element DEVICE tensor; the
        # kernel reads it and indexes the resident all-layer stack itself
        yb = super_moe_ffn(
            self._lid[layer:layer + 1], self.resident[e], xb, self.cfg,
            torch.as_tensor(counts.astype(np.int32), device=self.device))
        return unpack_capacity_multi(yb, order, slots, bounds)

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

    def _drain_window(self, buf: MoEDeviceBuffer):
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
        (nothing pending) or stop."""
        got = buf.recv_many(timeout=self.idle_backoff, stop=self.stop)
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
                                 timeout=min(remaining, gap), stop=self.stop)
            if more is None:
                if self.stop.is_set():
                    return None
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

    def _serve_batch(self, e: int, entries):
        """Serve one chunk of a drain: group its regions by layer id and
        launch the super kernel ONCE per distinct layer over their merged
        capacity buffer (layer-major), synchronise this worker's stream
        ONCE, then send every region's output block through its own
        combine.  A device with no experts only ever sees empty regions:
        nothing is launched, an empty marker is combined."""
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
                outs[j] = None  # empty region: combine an empty marker
        if by_layer:
            t0 = self.clock()
            for layer in sorted(by_layer):
                js = by_layer[layer]
                if self.moe_path == "fused":
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
            self._sync_stream()
            self.moe_busy[e] += self.clock() - t0  # race-ok: single-writer (worker e accumulates its own cell)
        for j, (i, layer, slot, _, token_ids, eids) in enumerate(prep):
            self._logev("moe", e, i, slot, layer, len(token_ids))
            self.attn_bufs[i][slot].combine_send(
                e, CombinePayload(layer=layer, token_ids=token_ids,
                                  expert_ids=eids, outputs=outs[j]),
                stop=self.stop)

    def _moe_worker(self, e: int):
        buf = self.moe_bufs[e]
        try:
            with self._worker_context(self._moe_streams[e]):
                while True:
                    if self.moe_batch_window > 0:
                        entries = self._drain_window(buf)
                    else:
                        # block on "any region complete" + take it in ONE
                        # atomic step
                        got = buf.recv_any(timeout=self.idle_backoff,
                                           stop=self.stop)
                        entries = None if got is None else [got]
                    if entries is None:
                        if self.stop.is_set():
                            return
                        continue
                    for chunk in self._chunk_by_row_cap(entries):
                        self._serve_batch(e, chunk)
        except AbortedError:
            return  # stop observed inside a buffer wait (shutdown/panic)
        except BaseException as ex:  # surface thread failures to the caller
            self._panic(ex)

    # --------------------------------------------------------- group worker
    def _panic(self, ex: BaseException):
        """Surface a worker-thread failure to every waiter."""
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
                tok = np.asarray(job.tokens)
                # valid-position mask: pad rows compute but don't count
                # toward measured router stats
                valid = None
                if job.lengths is not None:
                    valid = (np.arange(tok.shape[1])[None, :]
                             < np.asarray(job.lengths)[:, None]).reshape(-1)
                h = embed_tokens(self.params,
                                 torch.as_tensor(tok, device=self.device),
                                 None, self.cfg)
                active.append({"job": job, "h": h, "layer": 0,
                               "phase": "attn", "slot": free_slots.pop(0),
                               "ctx": None, "seq": 0, "valid": valid,
                               "kv": []})
            if not active:
                continue  # idle: loop back into the blocking take
            # run attention+dispatch for every slot that is ready
            for st in active:
                if st["phase"] != "attn":
                    continue
                t0 = self.clock()
                h, xf, w, idx, shared, kv = step(st["layer"], st["h"])
                if self.emit_kv:
                    st["kv"].append(kv)
                # the one device-to-host read of the batch-layer: the router's
                # expert ids, which placement routing needs on the host (the
                # wait also makes the clocked time below device time)
                idx_np = self._to_host(idx)
                dt = self.clock() - t0
                st["job"].kernel_time += dt
                self.group_busy[g] += dt  # race-ok: single-writer (group worker g accumulates its own cell)
                st["h"] = h
                st["ctx"] = (xf, w, shared)
                self._logev("attn", g, st["slot"], st["layer"],
                            tuple(h.shape[:2]))
                dispatch(g, st["slot"], st["layer"], xf, idx_np, st["valid"])
                st["phase"] = "wait"
                st["seq"] = seq = seq + 1
            # block on the oldest outstanding combine
            waiting = [s for s in active if s["phase"] == "wait"]
            if not waiting:
                continue
            st = min(waiting, key=lambda s: s["seq"])
            xf, w, shared = st["ctx"]
            t0 = self.clock()
            st["h"] = self._combine(g, st["slot"], st["h"], xf, w, shared)
            st["job"].comm_time += self.clock() - t0
            st["layer"] += 1
            if st["layer"] >= self.L:
                job = st["job"]
                t0 = self.clock()
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
                job.t_finished = self.clock()
                free_slots.append(st["slot"])
                active.remove(st)
                if self.on_complete is not None:
                    self.on_complete(job)  # streaming completion hook
                with self._done_cv:
                    self._done_cv.notify_all()
            else:
                st["phase"] = "attn"

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
        for cell in (self.moe_busy, self.group_busy, self.moe_launches,
                     self.moe_launch_regions, self.moe_launch_rows,
                     self.moe_launch_slots, self.bucket_hits,
                     self.bucket_misses):
            cell[:] = 0  # race-ok: no worker threads are running
        with self._log_lock:
            self.log.clear()
        self._t_serving_start = None

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
        if self._t_serving_start is None:
            self._t_serving_start = self.clock()
        self._moe_threads = [
            threading.Thread(target=self._moe_worker, args=(e,),
                             name=f"moe-{e}", daemon=True)
            for e in range(self.E)]
        self._g_threads = [
            threading.Thread(target=self._group_worker, args=(g,),
                             name=f"group-{g}", daemon=True)
            for g in range(self.D)]
        for t in self._moe_threads + self._g_threads:
            t.start()
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
        threads = self._g_threads + self._moe_threads
        grace = time.monotonic() + timeout
        for t in threads:
            t.join(timeout=max(grace - time.monotonic(), 1e-3))
        alive = [t for t in threads if t.is_alive()]
        self._hung += alive
        self._g_threads, self._moe_threads = [], []
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
