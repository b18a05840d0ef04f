"""Production-like request trace generation (paper Fig 5).

The paper's Huawei Cloud trace: mean prompt ≈ 5k tokens, range 31 .. 100k,
heavy right tail; requests > 32k are excluded from the serving experiments
(routed to dedicated SP instances, §4.2). We model it as a clipped lognormal
calibrated to those moments, with Poisson arrivals (§5.1).
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float
    length: int
    # decode: tokens to generate AFTER the first (prefill) token.  1 == the
    # prefill-only seed behavior — the request terminates at TTFT.
    out_len: int = 1
    # runtime bookkeeping
    batch_id: Optional[int] = None
    first_token_time: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    mean_len: float = 5000.0
    sigma: float = 1.5  # lognormal shape — heavy tail
    min_len: int = 31
    max_len: int = 32_768  # paper excludes > 32k (§4.2)
    seed: int = 0
    # Workload-level expert-routing skew (consumed by ExpertLoadModel via the
    # simulator; SimConfig.ep_skew/ep_skew_mode override when set):
    #   ep_skew      — Zipf exponent over expert popularity; 0.0 == uniform.
    #   ep_skew_mode — "uniform" | "zipf" (hot experts redrawn per layer) |
    #                  "layer" (layer-correlated: same hot experts every layer).
    # The COUNTER-measures to the skew this trace induces — expert placement
    # policy, hot-expert replication, online rebalancing — are system-side
    # knobs and therefore live on SimConfig (placement / replicate_hot /
    # rebalance_interval), not here.
    ep_skew: float = 0.0
    ep_skew_mode: str = "zipf"
    # Sampled decode lengths: tokens generated per request.  The
    # defaults (mean 1, cv 0) keep every existing prefill-only path
    # bit-identical — out_len == 1 means "terminate at TTFT".  out_len_cv is
    # the coefficient of variation of a lognormal over the mean.
    out_len_mean: float = 1.0
    out_len_cv: float = 0.0


def sample_lengths(n: int, tc: TraceConfig = TraceConfig()) -> np.ndarray:
    rng = np.random.default_rng(tc.seed)
    mu = math.log(tc.mean_len) - tc.sigma ** 2 / 2.0
    x = rng.lognormal(mu, tc.sigma, size=n)
    return np.clip(x, tc.min_len, tc.max_len).astype(np.int64)


def sample_out_len(rid: int, tc: TraceConfig = TraceConfig()) -> int:
    """Decode length for ONE request, deterministic per (seed, rid): the
    same rid resamples the same out_len no matter how many requests exist
    or in what order they are generated (sim/executor traces agree)."""
    if tc.out_len_mean <= 1.0 or tc.out_len_cv <= 0.0:
        return max(int(round(tc.out_len_mean)), 1)
    rng = np.random.default_rng((tc.seed, 3371, rid))
    sigma = math.sqrt(math.log(1.0 + tc.out_len_cv ** 2))
    mu = math.log(tc.out_len_mean) - sigma ** 2 / 2.0
    return max(int(round(rng.lognormal(mu, sigma))), 1)


def generate_requests(rps: float, duration: float,
                      tc: TraceConfig = TraceConfig()) -> List[Request]:
    """Poisson arrivals at `rps` for `duration` seconds."""
    rng = np.random.default_rng(tc.seed + 1)
    t, rid, out = 0.0, 0, []
    lengths = sample_lengths(max(int(rps * duration * 2) + 16, 16), tc)
    while True:
        t += rng.exponential(1.0 / rps)
        if t >= duration:
            break
        out.append(Request(rid=rid, arrival=t,
                           length=int(lengths[rid % len(lengths)]),
                           out_len=sample_out_len(rid, tc)))
        rid += 1
    return out


class TraceClock:
    """Replayable wall clock in TRACE seconds.

    The real executor engine honors `Request.arrival` by replaying the trace
    timeline against this clock: `now()` returns seconds of trace time since
    `start()`, advancing `speed` trace-seconds per wall-second, so a 60 s
    production trace can be replayed through the smoke-scale executor in
    60/speed wall seconds without changing any arrival arithmetic.  All
    engine-side timestamps (queue/kernel/comm decompositions, TTFT) are in
    trace seconds, directly comparable with the discrete-event simulator's
    virtual time.

    `sleep_until(t)` blocks (in wall time) until trace time `t`, waking early
    when `event` is set — the admission loop uses it to replay arrivals.
    """

    def __init__(self, speed: float = 1.0):
        assert speed > 0, "speed must be positive"
        self.speed = float(speed)
        self._t0: Optional[float] = None

    def start(self) -> "TraceClock":
        """(Re)anchor trace t=0 at the current wall time.  Idempotent-safe:
        calling start() again replays the trace from the beginning."""
        self._t0 = time.monotonic()
        return self

    def now(self) -> float:
        if self._t0 is None:
            self.start()
        return (time.monotonic() - self._t0) * self.speed

    def monotonic_ns(self, t: float) -> int:
        """Trace time `t` as `time.monotonic_ns()` read it (or will)."""
        if self._t0 is None:
            self.start()
        return int(round((self._t0 + t / self.speed) * 1e9))

    def wall_delay(self, trace_dt: float) -> float:
        """Wall seconds corresponding to `trace_dt` trace seconds."""
        return max(trace_dt, 0.0) / self.speed

    def sleep_until(self, t: float,
                    event: Optional[threading.Event] = None,
                    max_wall: float = 0.05) -> float:
        """Block until trace time >= t (or `event` fires); returns now().
        Sleeps in <= `max_wall`-second wall slices so a close() is prompt."""
        while True:
            now = self.now()
            if now >= t or (event is not None and event.is_set()):
                return now
            delay = min(self.wall_delay(t - now), max_wall)
            if event is not None:
                event.wait(delay)
            else:
                time.sleep(delay)
