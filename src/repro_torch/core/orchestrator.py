"""`PDOrchestrator` -- prefill/decode disaggregation behind the
ServingEngine API.

Federates dedicated PREFILL engines (any `ServingEngine` exposing
`take_kv`) with dedicated DECODE engines (core/decode.py):

    submit  -> round-robin to a prefill engine
    prefill completion -> `take_kv` exports the request's KV handle; the
        transfer is priced on the link of `hw` (`transfer_seconds`) and the
        request enrolls into the least-loaded decode engine at
        t_ready = first_token_time + transfer_seconds, where the decode
        engine's enrollment performs the real device copy
    decode completion  -> the terminal `RequestResult` streams out of
        order, extended with tokens_out / completion_time / token_times and
        the decomposition keys "kv_transfer" / "decode_queue" / "decode"

Colocated mode is the baseline: prefill and decode share the device, the
transfer costs nothing and no handoff is logged.

Causality with virtual-time decode engines (`virtual = True`; the port has
none yet): during poll() they only advance to the latest prefill completion
time seen (the frontier); drain() drains prefill FIRST (all enrollments
known), then lets decode run to completion unbounded.

Single caller thread by design: submit/poll/drain/stats all run on the
orchestrator's caller thread, and the decode engines run on its CUDA
stream.  The engines underneath keep their own locking; `KVTransferLog` is
the one shared-state object added here and is internally locked.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.decode import DecodeCompletion
from repro_torch.core.engine import (EngineStats, RequestHandle,
                                     RequestResult, ServingEngine)
from repro_torch.core.kv import KVTransferLog, transfer_seconds
from repro_torch.core.trace import Request


class PDOrchestrator(ServingEngine):
    """Front-end federating prefill + decode engines (see module docstring).

    `hw` prices the KV transfer (`core.cost_model.Hardware`: link rate +
    hop); `colocated=True` zeroes it and logs no handoffs.  Prefill engines
    must expose `take_kv(rid) -> KVHandle` (ExecutorEngine with keep_kv=True
    over an emit_kv executor).
    """

    def __init__(self, prefills: Sequence[ServingEngine],
                 decodes: Sequence[Any], *, hw, colocated: bool = False):
        assert prefills and decodes
        self.prefills = list(prefills)
        self.decodes = list(decodes)
        self.hw = hw
        self.colocated = colocated
        self.kv_log = KVTransferLog()
        self._rr = itertools.count()
        self._requests: Dict[int, Request] = {}
        self._handles: Dict[int, RequestHandle] = {}
        self._prefill_of: Dict[int, ServingEngine] = {}
        # rid -> {"pr": prefill RequestResult, "t_ready": float, "out_len"}
        self._pending_decode: Dict[int, Dict[str, Any]] = {}
        self._outbox: List[RequestResult] = []
        self._status_counts: Dict[str, int] = {}
        self._frontier = 0.0  # latest prefill completion time seen
        self._closed = False

    # ------------------------------------------------------------ intake --
    def submit(self, request: Request,
               tokens: Optional[np.ndarray] = None) -> RequestHandle:
        assert not self._closed, "submit() after close()"
        assert request.rid not in self._handles, f"duplicate rid {request.rid}"
        h = RequestHandle(self, request)
        eng = self.prefills[next(self._rr) % len(self.prefills)]
        self._requests[request.rid] = request
        self._handles[request.rid] = h
        self._prefill_of[request.rid] = eng
        eng.submit(request, tokens)
        return h

    # ------------------------------------------------------------ routing --
    def _finalize(self, res: RequestResult):
        self._outbox.append(res)
        self._status_counts[res.status] = \
            self._status_counts.get(res.status, 0) + 1
        h = self._handles.get(res.rid)
        if h is not None:
            h._fulfill(res)

    def _route_prefill(self, eng: ServingEngine, pr: RequestResult):
        """One prefill completion: terminal for out_len<=1 / non-ok, KV
        handoff + decode enrollment otherwise."""
        self._frontier = max(self._frontier, pr.first_token_time)
        req = self._requests[pr.rid]
        out_len = max(getattr(req, "out_len", 1), 1)
        if pr.status != "ok" or out_len <= 1:
            if pr.status == "ok":
                if getattr(eng, "keep_kv", False):
                    eng.take_kv(pr.rid)  # nothing to decode: let it go
                pr = dataclasses.replace(
                    pr, tokens_out=1, completion_time=pr.first_token_time,
                    token_times=[pr.first_token_time],
                    output_tokens=[pr.first_token])
            self._finalize(pr)
            return
        handle = eng.take_kv(pr.rid)
        dt = 0.0 if self.colocated else transfer_seconds(handle, self.hw)
        t_ready = pr.first_token_time + dt
        if not self.colocated:
            self.kv_log.record(handle, dt)
        dec = min(self.decodes, key=lambda d: d.load)
        dec.enroll(handle, steps=out_len - 1, t_ready=t_ready,
                   first_token=pr.first_token)
        self._pending_decode[pr.rid] = {"pr": pr, "t_ready": t_ready,
                                        "out_len": out_len}

    def _finish_decode(self, c: DecodeCompletion):
        info = self._pending_decode.pop(c.rid)
        pr: RequestResult = info["pr"]
        token_times = [pr.first_token_time] + list(c.token_times)
        completion = token_times[-1]
        decomp = dict(pr.decomposition)
        decomp["kv_transfer"] = max(info["t_ready"] - pr.first_token_time, 0.0)
        decomp["decode_queue"] = max(c.t_admitted - info["t_ready"], 0.0)
        decomp["decode"] = max(completion - c.t_admitted, 0.0)
        self._finalize(dataclasses.replace(
            pr, decomposition=decomp, tokens_out=info["out_len"],
            completion_time=completion, token_times=token_times,
            output_tokens=[pr.first_token] + list(c.tokens or [])))

    def _pump_decodes(self, unbounded: bool = False) -> bool:
        progressed = False
        for d in self.decodes:
            if d.virtual:
                comps = d.pump(float("inf") if unbounded else self._frontier)
            else:
                comps = d.pump()
            for c in comps:
                progressed = True
                self._finish_decode(c)
        return progressed

    # ---------------------------------------------------------------- API --
    def poll(self) -> List[RequestResult]:
        for eng in self.prefills:
            for pr in eng.poll():
                self._route_prefill(eng, pr)
        self._pump_decodes()
        out, self._outbox = self._outbox, []
        return out

    def drain(self, timeout: Optional[float] = None) -> List[RequestResult]:
        for eng in self.prefills:
            for pr in eng.drain(timeout):
                self._route_prefill(eng, pr)
        for d in self.decodes:
            if d.virtual:
                self._pump_decodes(unbounded=True)
                comps, leftovers = d.drain()
            else:
                comps, leftovers = d.drain(timeout)
            for c in comps:
                self._finish_decode(c)
            for rid in leftovers:
                info = self._pending_decode.pop(rid)
                self._finalize(dataclasses.replace(
                    info["pr"], status="timeout"))
        assert not self._pending_decode, \
            f"decode engines stranded rids {sorted(self._pending_decode)}"
        out, self._outbox = self._outbox, []
        return out

    def _wait_handle(self, handle: RequestHandle, timeout: Optional[float]):
        deadline = None if timeout is None else time.monotonic() + timeout
        while handle._result is None:
            got = False
            for eng in self.prefills:
                for pr in eng.poll():
                    got = True
                    self._route_prefill(eng, pr)
            # an empty prefill poll means its event source is (currently)
            # exhausted — safe to let virtual decode run ahead of the
            # frontier, since no new enrollment can now land behind it
            if self._pump_decodes(unbounded=not got):
                got = True
            if handle._result is not None:
                return
            if not got:
                if all(e.virtual for e in self.prefills) \
                        and all(d.virtual for d in self.decodes):
                    # pure virtual time: an idle round means no event can
                    # ever complete this request (horizon exhausted)
                    raise TimeoutError(
                        f"request {handle.rid} did not complete within the "
                        f"simulation horizon")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"request {handle.rid} still in flight")
                time.sleep(0.002)  # wall-clock backend: work is in flight

    def stats(self) -> EngineStats:
        base = self.prefills[0].stats()
        return dataclasses.replace(
            base, engine=f"pd:{base.engine}", submitted=len(self._requests),
            completed=sum(self._status_counts.values()),
            statuses=dict(self._status_counts))

    def close(self):
        self._closed = True
        for eng in self.prefills:
            eng.close()
        for d in self.decodes:
            d.close()
