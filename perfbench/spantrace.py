"""The program's spans (`repro_torch.core.spans`) on the device trace's clock,
and the per-layer numbers they give.

`SpanTracer` is `tracing.Tracer` that also records the program's spans from
start to stop and anchors the two clocks at each end: an anchor reads
`time.monotonic_ns()` just before and just after a `torch.cuda.synchronize()`
on the tracer's thread, and is paired with that thread's
`cudaDeviceSynchronize` in the Chrome trace.  The event's midpoint minus
the anchor's is the offset from the spans' clock to the trace's.  The
profiler names a thread in the trace by its native id or by the low 32
bits of its Python ident (CUPTI's runtime events; `trace_tids`), so both
are kept.  A
host that waits for the GIL after the sync widens an anchor; each end takes
`N_ANCHORS` and keeps the offsets all of them allow.  Where the two ends'
offsets differ by more than `MAX_DRIFT_NS`, the clocks do not line up and
every number here reads None.  `reduce_trace` keeps
`tracing.reduce_trace`'s keys and adds the union of busy intervals, the
runtime events, the anchors, the threads' idents and the offset.

A record for the readers below needs `spans`, `clock_offset_ns` and
`trace` (from `reduce_trace`), and `log` (the executor's events of the
same window).  Batch-layers are counted as `readers.batch_layers` counts
them, by the log's "combine" events.  Each reader returns None where the
run left it nothing to read: no trace, no spans (a program without the
recorder), or drift.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from perfbench import readers, tracing

MAX_DRIFT_NS = 200_000
N_ANCHORS = 3
# work on the host; the waits ("router_read", "moe_wait", "sync", "recv")
# are left out
WORK = ("attn", "dispatch", "combine", "pack", "launch", "unpack",
        "combine_send")
ALL_BLOCKED = "all blocked"
SYNC_NAME = "cudaDeviceSynchronize"

Interval = Tuple[int, int]


def _recorder():
    """The program's span recorder, or None where the program has none."""
    try:
        from repro_torch.core.spans import SPANS
    except ImportError:
        return None
    return SPANS


def take_anchor(side: str) -> dict:
    import torch
    before = time.monotonic_ns()
    torch.cuda.synchronize()
    after = time.monotonic_ns()
    return {"side": side, "tid": threading.get_native_id(),
            "ident": threading.get_ident(), "before_ns": before,
            "after_ns": after}


class SpanTracer(tracing.Tracer):
    """Profiles, records spans and anchors the two clocks from `start()` to
    `stop()`; does nothing when disabled."""

    def __init__(self, enabled: bool, out_dir):
        super().__init__(enabled, out_dir)
        self.spans: Optional[list] = None
        self.idents: Dict[int, int] = {}
        self.anchors: List[dict] = []

    def start(self):
        if not self.enabled:
            return
        super().start()
        self.anchors = [take_anchor("start") for _ in range(N_ANCHORS)]
        rec = _recorder()
        if rec is not None:
            rec.start()

    def stop(self) -> Optional[dict]:
        if self._prof is None:
            return None
        rec = _recorder()
        if rec is not None:
            rec.stop()
            self.spans = rec.take()
            self.idents = rec.idents()
        self.anchors += [take_anchor("stop") for _ in range(N_ANCHORS)]
        self._prof.__exit__(None, None, None)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.path))
        self._prof = None
        try:
            return reduce_trace(json.loads(self.path.read_text()),
                                self.anchors, self.idents)
        finally:
            os.remove(self.path)


# ------------------------------------------------------------------ trace
def _union(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _length(intervals: Iterable[Interval]) -> int:
    return sum(e - s for s, e in intervals)


def _intersect(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """Intersection of two sorted, disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """a minus b, both sorted and disjoint."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def _ns(ev) -> Interval:
    s = float(ev["ts"]) * 1e3
    return int(round(s)), int(round(s + float(ev["dur"]) * 1e3))


def _tid(ev):
    try:
        return int(ev.get("tid"))
    except (TypeError, ValueError):
        return ev.get("tid")


def trace_tids(tid, ident=None) -> set:
    """The names a thread may have in the trace: its native id, or its
    Python ident (`pthread_self()`) cut to 32 bits as CUPTI's runtime
    events carry it, and read as a signed number, whose magnitude the
    trace shows."""
    out = {tid}
    if ident is not None:
        low = ident & 0xFFFFFFFF
        out |= {ident, low, 2 ** 32 - low if low >= 2 ** 31 else low}
    return out


def anchor_offsets(runtime: List[tuple], anchors: List[dict]
                   ) -> Optional[Tuple[int, int]]:
    """The offsets (trace ns minus spans' ns) at the start and at the stop.
    The anchors' syncs are their thread's first device syncs in the trace,
    in order: nothing else on that thread syncs the device inside the
    window.  An
    anchor bounds the offset: its event [s, e] lies inside the host's
    [before, after], so the offset lies in [e - after, s - before].  An
    end's offset is the middle of what all its anchors allow (of its
    narrowest anchor's bound where they do not meet).  None where the trace
    lacks the syncs."""
    if not anchors:
        return None
    by_tid: Dict[object, List[Interval]] = collections.defaultdict(list)
    for tid, name, s, e in runtime:
        if name == SYNC_NAME:
            by_tid[tid].append((s, e))
    if not by_tid:
        return None
    own = trace_tids(anchors[0]["tid"], anchors[0].get("ident")) & set(by_tid)
    if not own:
        return None
    syncs = sorted(by_tid[own.pop()])
    if len(syncs) < len(anchors):
        return None
    out = []
    for side in ("start", "stop"):
        bounds = [(e - a["after_ns"], s - a["before_ns"])
                  for a, (s, e) in zip(anchors, syncs) if a["side"] == side]
        if not bounds:
            return None
        lo, hi = max(b[0] for b in bounds), min(b[1] for b in bounds)
        if lo > hi:
            lo, hi = min(bounds, key=lambda b: b[1] - b[0])
        out.append((lo + hi) // 2)
    return out[0], out[1]


def reduce_trace(doc: dict, anchors: List[dict],
                 idents: Optional[Dict[int, int]] = None) -> dict:
    """`tracing.reduce_trace`'s keys, and: the union of device-busy
    intervals and the CUDA runtime events as (tid, name, start, end), in
    trace ns; the anchors; the recording threads' idents by native tid;
    the offset from the spans' clock (the start's) and the difference of
    the two ends' offsets, None without anchors."""
    red = tracing.reduce_trace(doc)
    busy, runtime = [], []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        if cat in tracing.DEVICE_CATS:
            busy.append(_ns(ev))
        elif cat in tracing.HOST_CATS:
            runtime.append((_tid(ev), ev.get("name", "?")) + _ns(ev))
    runtime.sort(key=lambda r: r[2])
    offsets = anchor_offsets(runtime, anchors)
    red.update({
        "busy_intervals": _union(busy),
        "runtime_events": runtime,
        "anchors": list(anchors),
        "thread_idents": dict(idents or {}),
        "clock_offset_ns": offsets[0] if offsets else None,
        "anchor_drift_ns": abs(offsets[1] - offsets[0]) if offsets
        else None,
    })
    return red


# ------------------------------------------------------------------ spans
def aligned(rec) -> Optional[List[tuple]]:
    """The record's spans on the trace's clock, or None where there is no
    trace, no span or no sound anchor."""
    trace = getattr(rec, "trace", None)
    spans = getattr(rec, "spans", None)
    off = getattr(rec, "clock_offset_ns", None)
    if not trace or not spans or off is None:
        return None
    drift = trace.get("anchor_drift_ns")
    if drift is None or drift > MAX_DRIFT_NS:
        return None
    return [(n, s + off, e + off, tid, a) for n, s, e, tid, a in spans]


def _window(rec) -> Optional[Interval]:
    """The traced window on the trace's clock: from the start's last anchor
    to the stop's first."""
    off = rec.clock_offset_ns
    anchors = rec.trace["anchors"]
    a0 = [a for a in anchors if a["side"] == "start"][-1]
    a1 = [a for a in anchors if a["side"] == "stop"][0]
    return a0["after_ns"] + off, a1["before_ns"] + off


def in_flight(rec, spans) -> List[Interval]:
    """The union of the window's "executor" spans, cut to the window."""
    w = _window(rec)
    return _intersect(_union((s, e) for n, s, e, _, _ in spans
                             if n == "executor" and e > s), [w])


def idle_in_flight(rec, spans) -> List[Interval]:
    return _subtract(in_flight(rec, spans), rec.trace["busy_intervals"])


def device_idle_in_flight_pct(rec) -> Optional[float]:
    spans = aligned(rec)
    if spans is None:
        return None
    flight = in_flight(rec, spans)
    if not _length(flight):
        return None
    return 100.0 * _length(idle_in_flight(rec, spans)) / _length(flight)


def host_work_ms_per_batch_layer(rec) -> Optional[float]:
    spans = aligned(rec)
    n = readers.batch_layers(rec)
    if spans is None or not n:
        return None
    return 1e-6 * sum(e - s for name, s, e, _, _ in spans
                      if name in WORK) / n


def moe_wait_ms_per_batch_layer(rec) -> Optional[float]:
    spans = aligned(rec)
    if spans is None:
        return None
    waits = [e - s for name, s, e, _, _ in spans if name == "moe_wait"]
    return 1e-6 * sum(waits) / len(waits) if waits else None


def idle_in_flight_host_work_pct(rec) -> Optional[float]:
    spans = aligned(rec)
    if spans is None:
        return None
    idle = idle_in_flight(rec, spans)
    if not _length(idle):
        return None
    work = _union((s, e) for name, s, e, _, _ in spans if name in WORK)
    return 100.0 * _length(_intersect(idle, work)) / _length(idle)


def idle_by_phase(rec, top: int = 8) -> Optional[List[Tuple[str, float]]]:
    """The in-flight idle seconds split by what the host was doing: on
    each thread the innermost work span (the latest begun of those open);
    where several threads work, the time is split evenly among them; where
    none does, it counts as "all blocked".  The `top` largest phases."""
    spans = aligned(rec)
    if spans is None:
        return None
    idle = idle_in_flight(rec, spans)
    edges = []  # (time, +1 open / -1 close, tid, start, name)
    for name, s, e, tid, _ in spans:
        if name in WORK and e > s:
            edges.append((s, 1, tid, s, name))
            edges.append((e, -1, tid, s, name))
    edges.sort(key=lambda x: x[0])
    points = sorted({x[0] for x in edges} | {x for iv in idle for x in iv})
    open_: Dict[object, Dict[Tuple[int, str], int]] = \
        collections.defaultdict(dict)
    out: Dict[str, float] = collections.defaultdict(float)
    k = j = 0
    for a, b in zip(points, points[1:]):
        while k < len(edges) and edges[k][0] <= a:
            _apply(open_, edges[k])
            k += 1
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        if j < len(idle) and idle[j][0] <= a and b <= idle[j][1]:
            _credit(out, open_, b - a)
    ranked = sorted(out.items(), key=lambda kv: -kv[1])[:top]
    return [(n, v * 1e-9) for n, v in ranked]


def _apply(open_, edge):
    _, kind, tid, start, name = edge
    cur = open_[tid]
    if kind > 0:
        cur[(start, name)] = cur.get((start, name), 0) + 1
    else:
        left = cur.get((start, name), 0) - 1
        if left > 0:
            cur[(start, name)] = left
        else:
            cur.pop((start, name), None)


def _credit(out, open_, dt):
    working = [max(cur)[1] for cur in open_.values() if cur]
    if not working:
        out[ALL_BLOCKED] += dt
        return
    for name in working:
        out[name] += dt / len(working)


# ----------------------------------------------------------- the checks
def _contains(span, ev, tol: int) -> bool:
    return span[1] - tol <= ev[2] and ev[3] <= span[2] + tol


def _has_call(span, evs, starts, names, tol) -> bool:
    i = bisect.bisect_left(starts, span[1] - tol)
    for ev in evs[i:]:
        if ev[2] > span[2] + tol:
            return False
        if ev[1] in names and _contains(span, ev, tol):
            return True
    return False


def alignment_checks(rec, tol_ns: int = 20_000) -> Optional[dict]:
    """What shows the spans lie on the trace's clock, each beside the
    acceptance bar: the anchors' drift; the share of "router_read" spans
    holding a device-to-host copy or stream sync on their own thread; the
    share of "sync" spans holding a stream sync; the share of jobs whose
    group spans cover at least 90 % of their "executor" span."""
    spans = aligned(rec)
    if spans is None:
        return None
    by_tid = collections.defaultdict(list)
    for ev in rec.trace["runtime_events"]:
        by_tid[ev[0]].append(ev)
    idents = rec.trace.get("thread_idents") or {}
    of_thread = {}  # a span's tid -> its runtime events and their starts
    for tid in {s[3] for s in spans}:
        evs = sorted((ev for t in trace_tids(tid, idents.get(tid))
                      for ev in by_tid.get(t, [])), key=lambda ev: ev[2])
        of_thread[tid] = (evs, [ev[2] for ev in evs])

    def share(name, names):
        ss = [s for s in spans if s[0] == name]
        if not ss:
            return None
        return sum(_has_call(s, *of_thread[s[3]], names, tol_ns)
                   for s in ss) / len(ss)

    group = collections.defaultdict(list)
    for s in spans:
        if s[0] in ("attn", "router_read", "dispatch", "moe_wait",
                    "combine", "final"):
            group[s[3]].append((s[1], s[2]))
    unions = {tid: _union(iv) for tid, iv in group.items()}
    covered = []
    w = _window(rec)
    for n, s, e, tid, _ in spans:
        if n != "executor" or s < w[0] or e > w[1] or e <= s:
            continue
        got = _length(_intersect(unions.get(tid, []), [(s, e)]))
        covered.append(got / (e - s))
    return {
        "anchor_drift_us": rec.trace["anchor_drift_ns"] / 1e3,
        "router_read_with_copy_or_sync": share(
            "router_read", {"cudaMemcpyAsync", "cudaStreamSynchronize"}),
        "sync_with_stream_sync": share("sync", {"cudaStreamSynchronize"}),
        "jobs_90pct_covered": sum(c >= 0.9 for c in covered) / len(covered)
        if covered else None,
    }
