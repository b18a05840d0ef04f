"""Expert -> device placement (the routing layer of the cost model), and
the link figures that price a KV handoff.

The port carries `Placement` -- the executor derives its dispatch tables
and resident weight stacks from it; pure Python/numpy, the tables equal the
reference's (`repro.core.cost_model.Placement`) for the same inputs -- and a
`Hardware` record with only the fields `core.kv.transfer_seconds` reads.
The analytic cost model, `ExpertLoadModel` and the rest of `Hardware` are not
ported yet.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Hardware:
    """What a KV handoff costs on the link between two cards."""
    name: str
    ici_bw: float  # bytes/s over one link, one direction
    hop_latency: float  # seconds of a minimal transfer


# One H100 SXM.  ici_bw: NVLink 4, 900 GB/s both ways = 450 GB/s each way
# (NVIDIA H100 SXM data sheet; a datasheet figure, not measured here).
# hop_latency: the mean time of a small (4 KiB) device-to-device copy issued
# back to back (CUDA events around 200 copies), 5.69 us in one run of
# `chip_smoke.py`'s pd phase on an NVIDIA H100 80GB HBM3 at a 700 W power
# limit; the phase prints it on every run, beside the copy's device time.
H100 = Hardware(name="h100-sxm", ici_bw=450e9, hop_latency=5.69e-06)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Expert → device placement policy.

    Owns the expert -> hosts table, so a control plane can swap placements
    at runtime.  Policies:

      round_robin     — expert i lives on device i % ep.
      greedy_balanced — LPT on expert popularity: experts sorted hottest
                        first, each placed on the currently least-loaded
                        device (a full reshuffle — expensive to migrate to).
      replicated      — round_robin base, then each of the `replicate_hot`
                        hottest experts is replicated across enough
                        least-loaded devices to bring its per-host share down
                        to the uniform fair share (MegaScale-Infer-style
                        popularity-proportional replication, arXiv
                        2504.02263); a replicated expert's load and dispatch
                        bytes split uniformly across its hosts.  Keeping the
                        base layout makes an ONLINE switch cheap: only the
                        replica copies migrate, which is what lets the
                        simulator's rebalancer fix a hot expert without
                        reshuffling the whole model (arXiv 2505.08944).
      explicit        — a literal per-expert host table (`table_override`),
                        used by the placement control plane: the
                        `partial` and `drift` policies emit INTERMEDIATE
                        layouts that no closed-form policy describes, so the
                        plan pins the table verbatim.  Popularity input is
                        ignored; `dead` failover still applies.

    Placement tables are derived from a layer's expert-popularity vector, so
    under per-layer routing skew ("zipf" mode) every MoE layer — which owns
    its own expert weights — gets its own table.  Devices listed in `dead`
    host nothing: their replicated experts fail over to the surviving hosts,
    and their orphaned experts are re-placed greedily on the least-loaded
    survivors (the simulator charges the weight migration and repair window).
    """
    policy: str = "round_robin"  # round_robin|greedy_balanced|replicated|explicit
    replicate_hot: int = 0  # how many of the hottest experts get replicas
    dead: Tuple[int, ...] = ()
    # policy == "explicit": the literal per-expert host tuples
    table_override: Optional[Tuple[Tuple[int, ...], ...]] = None

    def __post_init__(self):
        if self.policy not in ("round_robin", "greedy_balanced", "replicated",
                               "explicit"):
            raise ValueError(f"unknown placement policy {self.policy!r}")
        if self.replicate_hot < 0:
            raise ValueError("replicate_hot must be >= 0")
        if (self.policy == "explicit") != (self.table_override is not None):
            raise ValueError("table_override is required by (and exclusive "
                             "to) the 'explicit' policy")

    @staticmethod
    def explicit(table: Sequence[Sequence[int]]) -> "Placement":
        """A placement pinned to a literal expert→hosts table (the layout an
        in-progress migration plan has installed so far)."""
        return Placement("explicit", table_override=tuple(
            tuple(int(d) for d in hosts) for hosts in table))

    @staticmethod
    def parse(spec: str, replicate_hot: int = 0) -> "Placement":
        """CLI-friendly constructor: 'round_robin', 'greedy_balanced',
        'replicated' or 'replicated(k)'."""
        spec = spec.strip()
        m = re.fullmatch(r"replicated\s*\(\s*(\d+)\s*\)", spec)
        if m:
            return Placement("replicated", replicate_hot=int(m.group(1)))
        if spec == "replicated":
            return Placement("replicated",
                             replicate_hot=replicate_hot or 2)
        return Placement(spec, replicate_hot=replicate_hot)

    def fail(self, device: int) -> "Placement":
        """The same policy with `device` marked dead (idempotent)."""
        if device in self.dead:
            return self
        return dataclasses.replace(self, dead=self.dead + (int(device),))

    @staticmethod
    def uniform_fractions(num_experts: int) -> Tuple[float, ...]:
        """Popularity vector when nothing is known about routing skew — the
        real executor's default input to `table` (the simulator feeds
        ExpertLoadModel.expert_fractions instead)."""
        n = max(num_experts, 1)
        return (1.0 / n,) * n

    def device_experts(self, fractions: Tuple[float, ...],
                       ep: int) -> Tuple[Tuple[int, ...], ...]:
        """Inverse view of `table`: for each of the ep devices, the sorted
        tuple of (global) expert ids it hosts.  This is the layout the REAL
        executor uses to build each MoE device's resident [L, n_e, ...]
        weight stack, so executor and simulator agree on expert→device
        assignment by construction (ROADMAP item d)."""
        table = self.table(fractions, ep)
        held: List[List[int]] = [[] for _ in range(ep)]
        for e, hosts in enumerate(table):
            for d in hosts:
                held[d].append(e)
        return tuple(tuple(sorted(h)) for h in held)

    def device_fractions(self, fractions: Tuple[float, ...],
                         ep: int) -> np.ndarray:
        """Traffic share per device under this placement: a replicated
        expert's popularity splits uniformly across its hosts.  The
        load-model-free view the placement controller and the placement-aware
        `optimal_deployment` use (ExpertLoadModel.device_fractions is the
        layer-keyed equivalent on the simulator side)."""
        p = np.asarray(fractions, dtype=np.float64)
        dev = np.zeros(ep)
        for e, hosts in enumerate(self.table(tuple(fractions), ep)):
            for d in hosts:
                dev[d] += p[e] / len(hosts)
        return dev

    def table(self, fractions: Tuple[float, ...],
              ep: int) -> Tuple[Tuple[int, ...], ...]:
        """Hosts of each expert given its popularity vector: a tuple of
        per-expert device-id tuples.  A replicated expert's load splits
        uniformly (1/len(hosts)) across its hosts.

        Policy-derived tables are memoized with a BOUNDED lru (the control
        plane feeds ever-changing measured/EWMA fraction tuples, so an
        unbounded class-level cache would grow one entry per rebalance
        window of a long-lived serving engine); explicit placements bypass
        it entirely — the drift/partial controllers mint a fresh one per
        migration."""
        if self.policy == "explicit":
            return self._table_impl(fractions, ep)
        return self._table_cached(fractions, ep)

    @functools.lru_cache(maxsize=512)
    def _table_cached(self, fractions: Tuple[float, ...],
                      ep: int) -> Tuple[Tuple[int, ...], ...]:
        return self._table_impl(fractions, ep)

    def _table_impl(self, fractions: Tuple[float, ...],
                    ep: int) -> Tuple[Tuple[int, ...], ...]:
        n = len(fractions)
        p = np.asarray(fractions, dtype=np.float64)
        if self.policy == "explicit":
            if len(self.table_override) != n:
                raise ValueError(
                    f"explicit table covers {len(self.table_override)} "
                    f"experts, popularity vector has {n}")
            top = max((d for h in self.table_override for d in h),
                      default=-1)
            if top >= ep:
                raise ValueError(
                    f"explicit table references device {top} but the pool "
                    f"has only {ep} devices")
            hosts = [list(h) for h in self.table_override]
        elif self.policy == "greedy_balanced":
            hosts: List[List[int]] = [[] for _ in range(n)]
            load = np.zeros(ep)
            for e in (int(e) for e in np.argsort(-p, kind="stable")):
                d = int(np.argmin(load))  # LPT: hottest to least-loaded
                hosts[e] = [d]
                load[d] += p[e]
        else:  # round_robin base (replicated keeps it so migrations are
            # incremental: only replica copies move, never the whole model)
            hosts = [[e % ep] for e in range(n)]
            load = np.zeros(ep)
            np.add.at(load, np.arange(n) % ep, p)
            if self.policy == "replicated":
                order = [int(e) for e in np.argsort(-p, kind="stable")]
                for e in order[:min(self.replicate_hot, n)]:
                    # enough replicas to bring the per-host share under the
                    # uniform fair share (popularity-proportional replication)
                    r = int(min(max(math.ceil(p[e] * ep), 2), ep))
                    while len(hosts[e]) < r:
                        h = hosts[e]
                        s_old, s_new = p[e] / len(h), p[e] / (len(h) + 1)
                        cand = min((d for d in range(ep) if d not in h),
                                   key=lambda d: (load[d], d))
                        for d in h:
                            load[d] -= s_old - s_new
                        load[cand] += s_new
                        h.append(cand)
        if self.dead:  # shared failover: applies to explicit tables too
            deadset = set(self.dead)
            alive = [d for d in range(ep) if d not in deadset]
            if not alive:
                raise ValueError("every MoE device is dead")
            load = np.zeros(ep)
            orphans: List[int] = []
            for e in range(n):
                live = [d for d in hosts[e] if d not in deadset]
                if live:  # surviving replicas absorb the dead host's share
                    hosts[e] = live
                    for d in live:
                        load[d] += p[e] / len(live)
                else:
                    orphans.append(e)
            for e in sorted(orphans, key=lambda e: -p[e]):
                d = min(alive, key=lambda d: (load[d], d))
                hosts[e] = [d]
                load[d] += p[e]
        return tuple(tuple(h) for h in hosts)
