"""Timed spans of the serving path: the port's one timed record.

Off by default.  An instrumented boundary tests `SPANS.on` once and, while
it is off, does nothing else: it reads no clock, allocates nothing, takes
no lock and adds no host sync.  While it is on, each boundary appends one
span

    (name, start_ns, end_ns, native_tid, attrs)

with times from `time.monotonic_ns()`, the native id of the thread it ran
on (the id a profiler's trace gives the same thread) and the ids of the
work in `attrs` (`rid`, `bid`, `layer`, `slot`, `g`, `e`, `regions`, ...).
A boundary that the engine keeps in trace seconds (a request's due time,
a job's start) is converted through its `TraceClock`'s anchor and speed
(`clock_ns`), so every span lies on one clock.

Each thread appends to a list of its own, registered once under the lock;
`take()` collects every list.  The executor's `log` stays the untimed
record of protocol events; a span reuses the log's event name wherever it
marks the same step ("attn", "dispatch", "combine", "launch").

`chrome_trace` writes spans as Chrome-trace JSON ("ph": "X", microseconds,
the native tid), to be opened beside a `torch.profiler` trace.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.trace import TraceClock

Span = Tuple[str, int, int, int, Dict[str, Any]]


class Recorder:
    """Per-thread span lists behind one switch, `on`."""

    def __init__(self):
        self.on = False
        self._lock = threading.Lock()
        # (thread, its span list): one entry per thread that recorded
        self._bufs: List[Tuple[threading.Thread, list]] = []  # guarded_by: _lock
        # native tid -> `threading.get_ident()` of each thread that recorded
        # (a profiler's trace may name a thread by either)
        self._idents: Dict[int, int] = {}  # guarded_by: _lock
        self._local = threading.local()

    def start(self):
        """Drop whatever was recorded and turn recording on."""
        self.take()
        self.on = True

    def stop(self):
        self.on = False

    def add(self, name: str, start_ns: int, end_ns: int,
            tid: Optional[int] = None, **attrs):
        """Record one span on this thread's list.  `tid` names another
        thread as the span's own (a span of the admission thread recorded
        where its end became known)."""
        local = self._local
        buf = getattr(local, "buf", None)
        if buf is None:
            buf = local.buf = []
            local.tid = threading.get_native_id()
            with self._lock:
                self._bufs.append((threading.current_thread(), buf))
                self._idents[local.tid] = threading.get_ident()
        buf.append((name, start_ns, end_ns,
                    local.tid if tid is None else tid, attrs))

    def take(self) -> List[Span]:
        """Every span recorded since the last take, by start time.  A
        thread may append meanwhile: its list is cut at the length read,
        and what it appends later stays for the next take."""
        out: List[Span] = []
        with self._lock:
            keep = []
            for thread, buf in self._bufs:
                n = len(buf)
                out.extend(buf[:n])
                del buf[:n]
                if thread.is_alive() or buf:
                    keep.append((thread, buf))
            self._bufs = keep
        out.sort(key=lambda s: (s[1], s[2]))
        return out

    def idents(self) -> Dict[int, int]:
        """Native tid -> Python thread ident of every thread that has
        recorded."""
        with self._lock:
            return dict(self._idents)


SPANS = Recorder()


def clock_ns(clock, t: float) -> int:
    """`t`, a reading of `clock` (a `TraceClock`'s bound `now`, or
    `time.monotonic`), as `time.monotonic_ns()` read it."""
    owner = getattr(clock, "__self__", None)
    if isinstance(owner, TraceClock):
        return owner.monotonic_ns(t)
    return int(round(t * 1e9))


def _jsonable(v):
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


def chrome_trace(spans: List[Span]) -> dict:
    """Spans as a Chrome-trace document: one complete ("X") event each,
    in microseconds of `time.monotonic_ns()`, on its native tid."""
    pid = os.getpid()
    return {"displayTimeUnit": "ms", "traceEvents": [
        {"name": name, "ph": "X", "cat": "span", "pid": pid, "tid": tid,
         "ts": start / 1e3, "dur": (end - start) / 1e3,
         "args": {k: _jsonable(v) for k, v in attrs.items()}}
        for name, start, end, tid, attrs in spans]}
