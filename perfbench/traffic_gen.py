"""The one traffic generator: every mix is a data file in `perfbench/traffic/`
that this module reads.

Work is fixed by the mix and ordered by the seed, so two seeds run the same
amount of work: prompt lengths come from a fixed multiset, Poisson
inter-arrival gaps from a fixed set of exponential quantiles, each shuffled
by the seed; token ids are drawn from the seed and the request's number.

A mix file holds:
  loop            "closed" (`clients` each send the next prompt when the
                  last one's first token returns) or "open" (Poisson
                  arrivals at `rate_rps`; `lead_s` seconds of arrivals come
                  before the window and are not counted)
  lengths         {"kind": "fixed", "tokens": n}, or {"kind": "lognormal",
                  "median": m, "sigma": s, "min": lo, "max": hi, "set": k}:
                  k lengths at the distribution's quantiles, clipped
  batch_cap       the length-aware batcher's `max_tokens`; its inflection
                  is half of it, as the serve CLI sets it
  batcher_max_wait_s, D, E, moe_batch_window   the serve CLI's settings
  warmup_jobs     jobs completed before the window opens
  check_requests  requests of the window held against the reference
  late_after_s    a request not back this long after the window is late
"""
from __future__ import annotations

from typing import List

import numpy as np

KINDS = ("closed", "open")


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), *keys])


def length_set(spec: dict) -> List[int]:
    """The multiset of prompt lengths a mix draws from."""
    if spec["kind"] == "fixed":
        return [int(spec["tokens"])]
    if spec["kind"] == "lognormal":
        k = int(spec["set"])
        q = (np.arange(k) + 0.5) / k
        from statistics import NormalDist
        z = np.array([NormalDist().inv_cdf(float(x)) for x in q])
        x = spec["median"] * np.exp(spec["sigma"] * z)
        return [int(v) for v in np.clip(np.round(x), spec["min"],
                                         spec["max"])]
    raise ValueError(f"lengths kind {spec['kind']!r}")


def lengths(spec: dict, n: int, seed: int) -> List[int]:
    """n prompt lengths: the multiset repeated, in an order from the seed."""
    base = length_set(spec)
    reps = -(-n // len(base))
    out = np.array(base * reps, np.int64)
    _rng(seed, 1).shuffle(out)
    return [int(v) for v in out[:n]]


def tokens(seed: int, rid: int, length: int, vocab: int) -> np.ndarray:
    """Token ids of request `rid`: the same for the same seed and rid."""
    return _rng(seed, 2, rid).integers(0, vocab, size=length,
                                       dtype=np.int32)


def open_arrivals(mix: dict, seed: int, window_s: float) -> np.ndarray:
    """Arrival times (seconds from the first) of an open loop covering
    `lead_s + window_s`: gaps at the exponential distribution's quantiles
    for `rate_rps`, shuffled by the seed."""
    rate = float(mix["rate_rps"])
    n = max(int(round(rate * (float(mix["lead_s"]) + window_s))), 1)
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    _rng(seed, 3).shuffle(gaps)
    return np.cumsum(gaps) - gaps[0]
