"""The device trace of a window: torch.profiler around it, reduced to what the
per-layer metrics read.

The profiler's Chrome trace is written under the checkout's `build/` and
read back: device operations (kernels, copies, sets) and the host's CUDA
runtime calls.  From them: the seconds in which some operation ran on the
device (the union of their intervals over every stream), device time and
the number of events seen by operation name, and the idle gaps, each named
by the runtime call the host was in for most of it.
"""
from __future__ import annotations

import collections
import json
import os
import pathlib
from typing import Dict, List, Optional, Tuple

from perfbench import yardstick

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cuda_runtime", "cuda_driver"}


class Tracer:
    """Profiles from `start()` to `stop()`; does nothing when disabled."""

    def __init__(self, enabled: bool, out_dir: pathlib.Path):
        self.enabled = enabled
        self.path = pathlib.Path(out_dir or ".") / "trace.json"
        self._prof = None

    def start(self):
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()

    def stop(self) -> Optional[dict]:
        if self._prof is None:
            return None
        import torch
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.path))
        self._prof = None
        try:
            return reduce_trace(json.loads(self.path.read_text()))
        finally:
            os.remove(self.path)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _gap_name(gs: float, ge: float, host: List[Tuple[float, float, str]],
              starts: List[float]) -> str:
    """The runtime call that overlaps the gap [gs, ge] the most."""
    import bisect
    best, name = 0.0, "host"
    i = bisect.bisect_left(starts, gs)
    # calls that began before the gap may reach into it: look back a little
    for s, e, n in host[max(i - 64, 0):]:
        if s > ge:
            break
        ov = min(e, ge) - max(s, gs)
        if ov > best:
            best, name = ov, n
    return name


def reduce_trace(doc: dict, top: int = 10) -> dict:
    """Device busy time, time by operation, by kernel class, and the
    longest idle gaps, all in seconds."""
    dev: List[Tuple[float, float, str]] = []
    host: List[Tuple[float, float, str]] = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s, e = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((s, e, ev.get("name", "?")))
        elif cat in HOST_CATS:
            host.append((s, e, ev.get("name", "?")))
    if not dev:
        return {"busy_s": 0.0, "span_s": 0.0, "ops": {}, "classes": {},
                "gaps": [], "device_events": 0}
    busy = _union([(s, e) for s, e, _ in dev])
    t0 = min([busy[0][0]] + [s for s, _, _ in host])
    t1 = max([busy[-1][1]] + [e for _, e, _ in host])
    ops: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    classes: Dict[str, List[float]] = collections.defaultdict(
        lambda: [0.0, 0])
    for s, e, n in dev:
        for table, key in ((ops, n), (classes, yardstick.kernel_class(n))):
            table[key][0] += (e - s) * 1e-6
            table[key][1] += 1
    host.sort()
    starts = [s for s, _, _ in host]
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "span_s": (t1 - t0) * 1e-6,
        "ops": {n: tuple(v) for n, v in ops.items()},
        "classes": {n: tuple(v) for n, v in classes.items()},
        "gaps": [(_gap_name(s, e, host, starts), (e - s) * 1e-6)
                 for s, e in gaps[:top]],
        "device_events": len(dev),
    }


def breakdown(red: dict, top: int = 10) -> dict:
    ops = sorted(red["ops"].items(), key=lambda kv: -kv[1][0])[:top]
    return {"device_ops": [[n, v[0]] for n, v in ops],
            "idle_gaps": [[n, s] for n, s in red["gaps"][:top]]}
