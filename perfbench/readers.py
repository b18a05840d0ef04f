"""Arithmetic the per-layer metric readers share (frozen with the yardstick).

Each reader takes the window's `cell.Record` and returns a number, or None
where the run left it nothing to read (no trace, no such kernel, no job).
Kernel device time from the trace is the mean time of the events the
profiler saw times the launches the executor logged: the profiler can lose
events, and a lost event must not read as a faster kernel.
"""
from __future__ import annotations

import collections
import math
from typing import List, Optional

from perfbench import yardstick


def events(rec, kind: str) -> List[tuple]:
    return [ev for ev in rec.log if ev[0] == kind]


def batch_layers(rec) -> int:
    return len(events(rec, "combine"))


def batch_tokens_mean(rec) -> Optional[float]:
    if not rec.jobs:
        return None
    return sum(sum(j["lengths"]) for j in rec.jobs) / len(rec.jobs)


def class_time_s(rec, cls: str, launches: int) -> Optional[float]:
    """Device time of `launches` launches of a kernel class."""
    if rec.trace is None or launches == 0:
        return None
    t, seen = rec.trace["classes"].get(cls, (0.0, 0))
    if not seen:
        return None
    return t / seen * launches


def super_gmm_roofline(rec) -> Optional[float]:
    launches = [ev[4] for ev in events(rec, "launch")]
    t = class_time_s(rec, "super_gmm", 3 * len(launches))
    if t is None:
        return None
    m = rec.model
    bound = yardstick.super_gmm_min_time_s(launches, m["d_model"],
                                           m["moe_d_ff"], rec.peak)
    return 100.0 * bound / t


def flash_roofline(rec) -> Optional[float]:
    attn = events(rec, "attn")
    t = class_time_s(rec, "flash", len(attn))
    if t is None or not rec.jobs:
        return None
    m = rec.model
    # valid lengths of each (B, S) shape, from the jobs of that shape
    by_shape = collections.defaultdict(list)
    for j in rec.jobs:
        by_shape[tuple(j["shape"])].append(j["lengths"])
    bound = 0.0
    for ev in attn:
        shape = tuple(ev[4])
        seen = by_shape.get(shape) or [[shape[1]] * shape[0]]
        bound += sum(yardstick.flash_min_time_s(
            [ls], m["num_heads"], m["num_kv_heads"], m["head_dim"],
            rec.peak) for ls in seen) / len(seen)
    return 100.0 * bound / t


def glue_ms_per_batch_layer(rec) -> Optional[float]:
    n = batch_layers(rec)
    if rec.trace is None or not n:
        return None
    return 1e3 * rec.trace["classes"].get("glue", (0.0, 0))[0] / n


def host_syncs_per_batch_layer(rec) -> Optional[float]:
    n = batch_layers(rec)
    return rec.host_syncs / n if n else None


def device_idle_pct(rec) -> Optional[float]:
    if rec.trace is None or not rec.trace["span_s"]:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["span_s"])


def mfu_pct(rec) -> Optional[float]:
    if rec.trace is None or not rec.jobs:
        return None
    lengths = [n for j in rec.jobs for n in j["lengths"]]
    return yardstick.mfu_pct(rec.model, lengths, rec.trace["span_s"],
                             rec.peak)


def device_ms_per_prompt(rec) -> Optional[float]:
    prompts = sum(len(j["lengths"]) for j in rec.jobs)
    if rec.trace is None or not prompts:
        return None
    return 1e3 * rec.trace["busy_s"] / prompts


def queue_wait_p90_ms(rec) -> Optional[float]:
    qs = [r["queue"] for r in rec.results if r["status"] == "ok"]
    return 1e3 * percentile(qs, 90.0) if qs else None


def percentile(xs, q: float) -> float:
    """The q-th percentile of xs by nearest rank."""
    s = sorted(xs)
    return s[max(int(math.ceil(q / 100.0 * len(s))) - 1, 0)]
