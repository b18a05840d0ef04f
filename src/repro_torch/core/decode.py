"""Decode subsystem: the token-generation stage behind prefill/decode
disaggregation.

Two runtimes behind ONE poll-driven interface (mirroring the prefill side's
SimEngine/ExecutorEngine split):

  SimDecodeEngine  -- `DecodeSim` (simulator.py): analytic continuous
                      batching in VIRTUAL time; per-step cost is KV-bytes-
                      read dominated and batch-width amortized
                      (`CostModel.decode_step_latency`), expert routing per
                      step through the same `ExpertLoadModel` as prefill.
  ExecDecodeEngine -- `DecodeExecutor` (this module): REAL single-token
                      decode steps over preallocated ragged KV slots.

Both share the flow the `PDOrchestrator` (core/orchestrator.py) drives:
`enroll(KVHandle, steps, t_ready)` registers a request whose prefill KV
landed at `t_ready` (admission order + width cap via
`DecodeAdmissionQueue`); `pump()` runs decode steps and returns
`DecodeCompletion`s; `drain()` finishes everything enrolled.

Every class here is single-threaded by design -- one orchestrator drives one
decode engine from its own poll loop, on that thread's current CUDA stream.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cost_model import CostModel, ExpertLoadModel
from repro_torch.core.kv import KVHandle
from repro_torch.core.scheduler import DecodeAdmissionQueue
from repro_torch.core.simulator import DecodeSim
from repro_torch.kernels import _launch
from repro_torch.models.blocks import decoder_block_decode_ragged
from repro_torch.models.common import ModelConfig, apply_norm
from repro_torch.models.lm import (embed_tokens, layer_slice, lm_head,
                                   lm_stages)
from repro_torch.models.moe import expert_capacity


@dataclasses.dataclass
class DecodeCompletion:
    """One request's finished decode tail (tokens 2..out_len)."""
    rid: int
    t_admitted: float
    token_times: List[float]  # engine-time stamps, one per decode token
    tokens: Optional[List[int]] = None  # sampled ids


# ---------------------------------------------------------------------------
# Simulator decode runtime
# ---------------------------------------------------------------------------


class SimDecodeEngine:
    """`DecodeSim` behind the decode-engine interface (virtual time)."""

    virtual = True  # pump() takes a causality frontier in virtual seconds

    def __init__(self, cfg: ModelConfig, cm: CostModel,
                 load_model: Optional[ExpertLoadModel] = None,
                 width: int = 32):
        self.cfg, self.cm = cfg, cm
        self.sim = DecodeSim(cfg, cm, load_model, width=width)

    @property
    def load(self) -> int:
        return self.sim.load

    def enroll(self, handle: KVHandle, steps: int, t_ready: float,
               first_token: Optional[int] = None):
        self.sim.enroll(handle.rid, handle.prompt_len, steps, t_ready)

    def _collect(self) -> List[DecodeCompletion]:
        out = [DecodeCompletion(rid=e.rid, t_admitted=e.t_admitted,
                                token_times=list(e.token_times))
               for e in self.sim.completed]
        self.sim.completed = []
        return out

    def pump(self, t_limit: float) -> List[DecodeCompletion]:
        """Advance virtual time to `t_limit` — the orchestrator passes its
        prefill frontier so decode never outruns known prefill progress."""
        self.sim.advance(t_limit)
        return self._collect()

    def drain(self) -> Tuple[List[DecodeCompletion], List[int]]:
        """Finish everything enrolled (all enrollments are known by drain
        time — the orchestrator drains prefill first).  The internal bound
        only catches a wedged cost model; normal runs never hit it."""
        s = self.sim
        remaining, kv_max = s.remaining_work()
        if remaining:
            horizon = s.now + 4.0 * remaining \
                * self.cm.decode_step_latency([kv_max]) + 60.0
            leftovers = s.drain(horizon)
        else:
            leftovers = s.drain(s.now)
        return self._collect(), [e.rid for e in leftovers]

    def close(self):
        pass


# ---------------------------------------------------------------------------
# Real decode runtime
# ---------------------------------------------------------------------------


class DecodeExecutor:
    """Continuous-batching decode runtime over preallocated ragged KV slots.

    State: `slots` cache rows of `max_len` tokens ([L, slots, max_len, kvh,
    hd] K and V), per-row lengths, last-token ids and occupancy -- all
    device tensors, plus a host mirror of the occupancy.  ONE step function
    advances every row a token: embed the last sampled ids, run the decoder
    layers through `decoder_block_decode_ragged` (per-row cache append, in
    place, + ragged mask; the MoE in capacity mode on the dispatch/combine
    kernels), final norm + lm_head argmax, then freeze inactive rows with
    `torch.where`.  Shapes never depend on which rows are occupied, so
    joins and leaves between steps change no shape and no capacity `C` --
    the `trace_counts["decode_step"]` probe counts the distinct step
    signatures seen (the reference counts jit traces there) and stays at 1.

    The one host sync of a step is the read of the sampled tokens.
    Enrollment is a device copy into the slot's rows, after the payload's
    `ready` event.
    """

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 8,
                 max_len: int = 256, clock=None):
        stages = lm_stages(cfg)
        if len(stages) != 1 or stages[0][0] != "decoder":
            raise ValueError("DecodeExecutor supports the uniform decoder "
                             "family only")
        if slots < 1 or max_len < 2:
            raise ValueError("DecodeExecutor needs slots >= 1, max_len >= 2")
        self.params, self.cfg = params, cfg
        self.slots, self.max_len = slots, max_len
        self.clock = clock if clock is not None else time.monotonic
        self.device = params["embed"].device
        dev = self.device
        L = cfg.num_layers
        shape = (L, slots, max_len, cfg.num_kv_heads, cfg.head_dim)
        # the state is only ever touched under inference mode (no autograd
        # bookkeeping; the step's outputs are inference tensors too)
        with torch.inference_mode():
            self._k = torch.zeros(shape, dtype=cfg.dtype, device=dev)
            self._v = torch.zeros(shape, dtype=cfg.dtype, device=dev)
            self._tokens = torch.zeros(slots, dtype=torch.int32, device=dev)
            self._lengths = torch.zeros(slots, dtype=torch.int32, device=dev)
            self._active_dev = torch.zeros(slots, dtype=torch.bool,
                                           device=dev)
        self._active = np.zeros(slots, bool)  # host mirror of occupancy
        self._logits: Optional[torch.Tensor] = None  # last step's [slots, V]
        self.trace_counts: Dict[str, int] = {"decode_step": 0}
        self._signatures: set = set()
        self.steps = 0
        self.host_syncs = 0  # device-to-host reads the steps waited on
        # device time of the enrollment copies: (start, end) CUDA events
        # still pending, folded into the running total once they completed
        self._enroll_events: List[tuple] = []
        self._enroll_ms = 0.0
        self._enrollments = 0
        self._layers = [layer_slice(params["stages"][0], l) for l in range(L)]
        self._moe = cfg.family == "moe"

    # ------------------------------------------------------------ slots --
    def occupy(self, slot: int, handle: KVHandle, first_token: int):
        """Enroll one request into `slot`: device copy of its prefill KV
        plus the first sampled token (its decode input).  The copy runs on
        this thread's stream after the producer's `ready` event; the payload
        is `record_stream`-ed here, so its memory is not handed out again
        before the copy has read it."""
        if handle.payload is None:
            raise ValueError("DecodeExecutor needs a real KV payload "
                             "(keep_kv prefill)")
        k, v = handle.payload
        Lp = handle.prompt_len
        if k.shape[1] != Lp or Lp >= self.max_len:
            raise ValueError(f"rid {handle.rid}: payload of {k.shape[1]} "
                             f"tokens, prompt {Lp}, cache {self.max_len}")
        with torch.inference_mode():
            self._occupy(slot, k, v, Lp, handle.ready, int(first_token))
        self._active[slot] = True

    def _occupy(self, slot, k, v, Lp, ready, first_token):
        cuda = self.device.type == "cuda"
        if cuda:
            cur = torch.cuda.current_stream(self.device)
            if ready is not None:
                cur.wait_event(ready)
            for t in (k, v):
                if t.is_cuda:
                    t.record_stream(cur)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record(cur)
        self._k[:, slot, :Lp].copy_(k)
        self._v[:, slot, :Lp].copy_(v)
        if cuda:
            ev[1].record(cur)
            self._enroll_events.append(ev)
            self._fold_enroll_events(wait=False)
        # fills on the device: no host read, no host-to-device copy
        self._tokens[slot] = first_token
        self._lengths[slot] = Lp
        self._active_dev[slot] = True

    def release(self, slot: int):
        self._active[slot] = False
        with torch.inference_mode():
            self._active_dev[slot] = False

    def _fold_enroll_events(self, wait: bool):
        pending = []
        for start, end in self._enroll_events:
            if wait:
                end.synchronize()
            elif not end.query():
                pending.append((start, end))
                continue
            self._enroll_ms += start.elapsed_time(end)
            self._enrollments += 1
        self._enroll_events = pending

    def enroll_copy_ms(self) -> Tuple[float, int]:
        """(device ms summed over the enrollment copies so far, how many);
        waits for the pending ones.  Zero on the CPU."""
        self._fold_enroll_events(wait=True)
        return self._enroll_ms, self._enrollments

    # ------------------------------------------------------------- step --
    def _step(self):
        cfg = self.cfg
        h = embed_tokens(self.params, self._tokens[:, None], None, cfg)
        for l, lp in enumerate(self._layers):
            h, _, _ = decoder_block_decode_ragged(
                lp, h, self._k[l], self._v[l], self._lengths, cfg,
                moe=self._moe)
        hN = apply_norm(h[:, 0], self.params["final_norm"], cfg)
        logits = lm_head(self.params, hN, cfg)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        active = self._active_dev
        self._tokens = torch.where(active, nxt, self._tokens)
        self._lengths = torch.where(active, self._lengths + 1, self._lengths)
        self._logits = logits
        # what a retrace would key on: every shape of the step, and the
        # capacity the MoE layer cut its buffers at
        sig = (tuple(h.shape), tuple(self._k.shape), tuple(logits.shape),
               expert_capacity(self.slots, cfg) if self._moe else 0)
        if sig not in self._signatures:
            self._signatures.add(sig)
            self.trace_counts["decode_step"] = len(self._signatures)

    def step_once(self) -> Tuple[float, np.ndarray]:
        """One batched decode step; returns (t_done, per-slot token ids)."""
        with torch.inference_mode():
            self._step()
        if self._tokens.is_cuda:
            _launch.note_host_sync()  # the step's one device-to-host read
            self.host_syncs += 1
        toks = self._tokens.cpu().numpy()
        self.steps += 1
        return self.clock(), toks


class ExecDecodeEngine:
    """Poll-driven decode engine over `DecodeExecutor` (wall/trace time).

    No background threads: the orchestrator's poll loop calls `pump()`,
    which admits every ready request into a free slot (real KV device copy)
    and runs batched steps while any slot is occupied.  Requests leave the
    instant their step budget is spent -- continuous batching, slots turn
    over between steps.
    """

    virtual = False  # pump() runs against the runtime's own clock

    def __init__(self, runtime: DecodeExecutor):
        self.rt = runtime
        self.q = DecodeAdmissionQueue(runtime.slots)
        self._free = list(range(runtime.slots))
        self._by_slot: Dict[int, Dict[str, Any]] = {}

    @property
    def load(self) -> int:
        return self.q.active + len(self.q)

    def enroll(self, handle: KVHandle, steps: int, t_ready: float,
               first_token: Optional[int] = None):
        if steps < 1:
            raise ValueError("steps must be >= 1")
        if handle.prompt_len + steps > self.rt.max_len:
            raise ValueError(
                f"rid {handle.rid}: {handle.prompt_len}+{steps} tokens "
                f"exceed the decode cache ({self.rt.max_len})")
        self.q.push(t_ready, {
            "handle": handle, "remaining": steps,
            "first_token": int(first_token) if first_token is not None else 0,
            "t_admitted": None, "token_times": [], "tokens": [],
            "slot": None})

    def _admit(self, now: float):
        for e in self.q.admit(now):
            slot = self._free.pop()
            e["slot"], e["t_admitted"] = slot, now
            self.rt.occupy(slot, e["handle"], e["first_token"])
            e["handle"] = dataclasses.replace(e["handle"], payload=None,
                                              ready=None)  # copied: let go
            self._by_slot[slot] = e

    def pump(self, max_steps: Optional[int] = None) -> List[DecodeCompletion]:
        """Admit + step until no slot is occupied (or `max_steps`).  Pending
        entries whose `t_ready` is still in the future stay queued -- the
        caller re-pumps on its next poll."""
        done: List[DecodeCompletion] = []
        steps = 0
        while True:
            self._admit(self.rt.clock())
            if not self._by_slot:
                return done
            t, toks = self.rt.step_once()
            for slot in list(self._by_slot):
                e = self._by_slot[slot]
                e["token_times"].append(t)
                e["tokens"].append(int(toks[slot]))
                e["remaining"] -= 1
                if e["remaining"] <= 0:
                    del self._by_slot[slot]
                    self.rt.release(slot)
                    self._free.append(slot)
                    self.q.release()
                    done.append(DecodeCompletion(
                        rid=e["handle"].rid, t_admitted=e["t_admitted"],
                        token_times=e["token_times"], tokens=e["tokens"]))
            steps += 1
            if max_steps is not None and steps >= max_steps:
                return done

    def drain(self, timeout: Optional[float] = None) \
            -> Tuple[List[DecodeCompletion], List[int]]:
        """Pump until everything enrolled finished (waiting out future
        `t_ready` stamps) or the WALL `timeout` passed; unfinished rids are
        returned for the orchestrator to mark `timeout`."""
        deadline = None if timeout is None else time.monotonic() + timeout
        done: List[DecodeCompletion] = []
        while self._by_slot or len(self.q):
            done += self.pump()
            if not self._by_slot and len(self.q):
                if deadline is not None and time.monotonic() > deadline:
                    break
                time.sleep(0.001)  # next t_ready is still in the future
        leftovers = [e["handle"].rid for e in self._by_slot.values()]
        leftovers += [e["handle"].rid for e in self.q.drain_all()]
        for slot in list(self._by_slot):
            self.rt.release(slot)
            self._free.append(slot)
            del self._by_slot[slot]
        self.q.release(self.q.active)
        return done, leftovers

    def close(self):
        pass
