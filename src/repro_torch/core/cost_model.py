"""The analytic cost model shared by the discrete-event simulator and the
placement control plane, and expert -> device placement (its routing layer).

Pure Python and numpy, copied from the reference (`repro.core.cost_model`)
with nothing changed in the arithmetic, so every output equals the
reference's bit for bit for the same inputs:

  * attention prefill latency ~ O(sum s_i^2);
  * the MoE stage's dual regime: a memory-bound plateau, then linear, with
    the inflection point derived from the hardware's ridge;
  * async dispatch vs synchronous P2P latency;
  * per-MoE-device expert load under routing skew (`ExpertLoadModel` +
    `moe_device_latency`), the straggler effect of expert parallelism.

`Placement` owns the expert -> hosts table the executor derives its dispatch
tables and resident weight stacks from.  `Hardware` prices a chip and its
link: `V5E` is the reference's preset and the default wherever the reference
uses one (the simulator, `CostModel`), so the simulator's outputs are those
of the reference's model; `H100` describes one H100 SXM and prices the KV
handoff of prefill/decode serving.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One chip and its interconnect, as the cost model prices them.  The
    defaults are the reference's preset (`V5E`), not a measurement of any
    card the port runs on."""
    peak_flops: float = 197e12  # bf16 FLOP/s
    hbm_bw: float = 819e9  # bytes/s
    ici_bw: float = 50e9  # bytes/s per link direction
    ici_links: int = 2  # usable links per collective phase on a 2D mesh axis
    hop_latency: float = 1e-6  # per-hop link latency
    base_latency: float = 2e-6  # DMA setup
    host_dispatch: float = 220e-6  # host->device kernel dispatch
    p2p_handshake: float = 20e-6  # synchronous P2P rendezvous cost
    flop_efficiency: float = 0.6  # achievable fraction of peak on real kernels
    # Blocking collectives achieve a fraction of link bandwidth (no overlap,
    # stragglers inside the collective); calibrated in the reference so its
    # sync-P2P / async-dispatch ratio sits in the paper's measured band.
    sync_bw_derate: float = 0.25
    name: str = "v5e-reference-preset"

    @property
    def collective_bw(self) -> float:
        return self.ici_bw * self.ici_links


# The reference's preset, kept as the default of `CostModel`, `AsapSim`,
# `SyncSim`, `run_sim` and `slo_throughput` so their outputs equal the
# reference's.  It is not a measurement of the H100 the port runs on.
V5E = Hardware()

# One H100 SXM, for a caller that passes it where the reference's
# constructors take `hw` (`CostModel(cfg, hw, dep)`, `AsapSim(cfg, sim, dep,
# hw)`, `SyncSim`) and for `PDOrchestrator`'s KV handoff.
#   From the NVIDIA H100 SXM data sheet: peak_flops (dense bf16), hbm_bw,
#   ici_bw (NVLink 4: 900 GB/s both ways = 450 GB/s each way, one link).
#   Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit by
#   `chip_smoke.py` (the rebalance phase prints each beside this preset on
#   every run; hop_latency also in the pd phase, whose reading this is; the
#   others are one run's of the rebalance phase):
#     hop_latency     a small (4 KiB) device-to-device copy issued back to
#                     back, CUDA events around 200 copies;
#     base_latency    the same copy's device time (profiler);
#     host_dispatch   the host's time to issue one `super_gmm` call (the
#                     Super Kernel's wrapper) at a decode-size shape, 8
#                     experts of 8 rows;
#     p2p_handshake   a cross-stream rendezvous: an event recorded on one
#                     stream, waited on by another, then a host sync;
#     flop_efficiency dense `super_gmm` TFLOP/s over the 989 TFLOP/s peak.
#   sync_bw_derate is a dimensionless calibration of a blocking collective
#   that one card cannot measure: it keeps the reference's value.
H100 = Hardware(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                ici_bw=450e9, ici_links=1, hop_latency=5.69e-06,
                base_latency=9.881e-07, host_dispatch=3.197e-05,
                p2p_handshake=1.289e-05, flop_efficiency=0.7212,
                sync_bw_derate=0.25)


@dataclasses.dataclass(frozen=True)
class Deployment:
    """ASAP Table 1 geometry: D attention DP groups × T TP each + E MoE devices."""
    D: int = 4
    T: int = 4
    E: int = 16
    max_batch_tokens: int = 32_768  # S in Table 1

    @property
    def attention_chips(self) -> int:
        return self.D * self.T

    @property
    def total_chips(self) -> int:
        return self.attention_chips + self.E



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


@functools.lru_cache(maxsize=None)
def resample_fractions(fractions: Tuple[float, ...], n: int) -> np.ndarray:
    """Resample a measured expert-popularity vector onto `n` experts.

    Interpolates the SORTED (descending) popularity curve at n quantile
    positions and renormalizes — the skew SHAPE (how concentrated traffic is
    on the hottest experts) survives the change of expert count, which is
    what lets an 8-expert smoke-run measurement calibrate a production-scale
    simulator (`ExpertLoadModel(mode="measured")`, fig_ep_skew --skew
    measured).  Returned descending; callers scatter identities."""
    p = np.sort(np.asarray(fractions, dtype=np.float64))[::-1]
    p = p / max(p.sum(), 1e-12)
    m = len(p)
    if m == n:
        return p
    xs = (np.arange(m) + 0.5) / m
    xt = (np.arange(n) + 0.5) / n
    q = np.interp(xt, xs, p)
    return q / max(q.sum(), 1e-12)


@dataclasses.dataclass(frozen=True)
class ExpertLoadModel:
    """Routing-skew model: how `tokens · top_k` expert assignments spread over
    the E MoE devices of an EP deployment.

    Four modes:
      uniform  — every expert equally popular (the seed aggregate model's
                 implicit assumption); skew `alpha` is ignored.
      zipf     — Zipf(alpha) expert popularity with the hot-expert *identity*
                 redrawn per layer (decorrelated layers: a different device is
                 the straggler on each layer).
      layer    — layer-correlated Zipf skew: the SAME hot experts on every
                 layer, i.e. one persistently overloaded device — the
                 worst-case straggler scenario.
      measured — expert popularity taken from a MEASURED per-expert token-
                 fraction vector (`measured`, e.g. RouterStatsCollector
                 .fractions() from a live executor run).  Layer-correlated
                 like "layer".  When the
                 measured vector's length differs from `num_experts` (e.g. an
                 8-expert smoke run calibrating a 256-expert sim) the sorted
                 popularity curve is resampled onto `num_experts` experts and
                 the identities are scattered with `seed`; an exact-length
                 vector is used verbatim (identities preserved).

    Expert→device assignment is delegated to `placement`: the default
    round-robin Placement places expert i on device i % ep; greedy/replicated
    placements spread or split hot experts.
    All outputs are expectations (deterministic), not samples, so the
    simulator stays reproducible and the per-device latency math vectorizes.
    """
    num_experts: int
    top_k: int
    ep: int  # number of MoE devices (Deployment.E)
    mode: str = "uniform"  # uniform | zipf | layer | measured
    alpha: float = 0.0  # Zipf exponent; 0 == uniform
    seed: int = 0
    placement: Placement = Placement()
    # "measured" mode: per-expert token fractions observed on a live run
    # (RouterStatsCollector.fractions_tuple()); any length, resampled to
    # num_experts when they differ.
    measured: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.mode not in ("uniform", "zipf", "layer", "measured"):
            raise ValueError(f"unknown skew mode {self.mode!r}")
        if self.mode == "measured" and not self.measured:
            raise ValueError("mode='measured' requires a measured fractions "
                             "vector (RouterStatsCollector.fractions_tuple())")

    @functools.lru_cache(maxsize=None)
    def expert_fractions(self, layer: int = 0) -> np.ndarray:
        """P(assignment -> expert i) for each of num_experts experts."""
        n = max(self.num_experts, 1)
        if self.mode == "measured":
            p = np.asarray(self.measured, dtype=np.float64)
            if len(p) == n:
                return p / max(p.sum(), 1e-12)
            p = resample_fractions(tuple(float(x) for x in p), n)
            perm = np.random.default_rng(self.seed).permutation(n)
            return p[perm]
        if self.mode == "uniform" or self.alpha <= 0.0:
            return np.full(n, 1.0 / n)
        ranks = np.arange(1, n + 1, dtype=np.float64) ** (-self.alpha)
        p = ranks / ranks.sum()
        # scatter popularity ranks over expert ids; `layer` redraws the
        # permutation only in the decorrelated "zipf" mode.
        perm_seed = self.seed if self.mode == "layer" else self.seed + layer
        perm = np.random.default_rng(perm_seed).permutation(n)
        return p[perm]

    def placement_table(self, layer: int = 0) -> Tuple[Tuple[int, ...], ...]:
        """Per-expert host tuple for `layer` (layer-keyed only in zipf mode)."""
        lkey = layer if self.mode == "zipf" else 0
        p = self.expert_fractions(lkey)
        return self.placement.table(tuple(float(x) for x in p), self.ep)

    @functools.lru_cache(maxsize=None)
    def _assignment(self, lkey: int) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray]:
        """Flattened (expert_idx, device_idx, weight) replica arrays for the
        layer's placement table; weight = 1/len(hosts) splits a replicated
        expert's load uniformly across its hosts."""
        table = self.placement_table(lkey)
        rep = np.array([e for e, hosts in enumerate(table) for _ in hosts],
                       dtype=np.int64)
        idx = np.array([d for hosts in table for d in hosts], dtype=np.int64)
        w = np.array([1.0 / len(hosts) for hosts in table for _ in hosts])
        return rep, idx, w

    @functools.lru_cache(maxsize=None)
    def device_fractions(self, layer: int = 0) -> np.ndarray:
        """Fraction of all assignments landing on each of the ep devices."""
        lkey = layer if self.mode == "zipf" else 0
        p = self.expert_fractions(lkey)
        rep, idx, w = self._assignment(lkey)
        dev = np.zeros(self.ep)
        np.add.at(dev, idx, p[rep] * w)
        return dev

    def device_loads(self, tokens: float, layer: int = 0) -> np.ndarray:
        """Expected token-assignments per device for a `tokens`-token batch."""
        return float(tokens) * self.top_k * self.device_fractions(layer)

    def device_experts_hit(self, tokens: float, layer: int = 0) -> np.ndarray:
        """Expected number of RESIDENT experts activated per device — drives
        the weight-streaming (memory-bound) term of moe_device_latency.
        A replica counts as resident on every host (replication trades HBM
        streaming for load split)."""
        lkey = layer if self.mode == "zipf" else 0
        p = self.expert_fractions(lkey)
        rep, idx, w = self._assignment(lkey)
        a = max(float(tokens) * self.top_k, 0.0)
        hit = 1.0 - np.power(np.clip(1.0 - p[rep] * w, 0.0, 1.0), a)
        dev = np.zeros(self.ep)
        np.add.at(dev, idx, hit)
        return dev

    def hot_fraction(self, layers: int = 4) -> float:
        """Max device fraction (over a few layers) — the straggler share used
        to re-derive the batcher inflection point under skew."""
        return float(max(self.device_fractions(l).max()
                         for l in range(max(layers, 1))))

    def expected_copies(self, layers: int = 4) -> float:
        """Expected number of DISTINCT target devices per token under the
        current placement — the dispatch-payload fan-out dispatch_bytes needs
        once placement deviates from uniform round-robin (replicas add
        targets, a dead device removes one)."""
        vals = []
        for l in range(max(layers, 1)):
            q = self.device_fractions(l)
            vals.append(float(np.sum(1.0 - np.power(1.0 - q, self.top_k))))
        return float(np.mean(vals))

    def with_failed(self, device: int) -> "ExpertLoadModel":
        """This load model with `device` dead: replicated experts fail over
        to their surviving hosts, orphans re-place onto the survivors."""
        return dataclasses.replace(self, placement=self.placement.fail(device))

    # ------- whole-iteration (L layers) matrices for the sync engine -------
    def layer_device_loads(self, tokens: float, layers: int) -> np.ndarray:
        """layers×ep expected token-assignments (one row per MoE layer)."""
        if self.mode == "zipf":  # hot experts redrawn per layer
            return np.stack([self.device_loads(tokens, l)
                             for l in range(layers)])
        return np.broadcast_to(self.device_loads(tokens, 0),
                               (layers, self.ep)).copy()

    def layer_device_hits(self, tokens: float, layers: int) -> np.ndarray:
        if self.mode == "zipf":
            return np.stack([self.device_experts_hit(tokens, l)
                             for l in range(layers)])
        return np.broadcast_to(self.device_experts_hit(tokens, 0),
                               (layers, self.ep)).copy()

    def layer_hot_factors(self, layers: int) -> np.ndarray:
        """Hottest rank's traffic share relative to uniform (>= 1), per layer
        — scales the blocking all-to-all's transfer term in the sync engine."""
        if self.mode == "zipf":
            return np.array([self.device_fractions(l).max() * self.ep
                             for l in range(layers)])
        return np.full(layers, self.device_fractions(0).max() * self.ep)


@dataclasses.dataclass(frozen=True)
class CostModel:
    cfg: ModelConfig
    hw: Hardware = V5E
    dep: Deployment = Deployment()
    # Per-token dispatch fan-out override (ExpertLoadModel.expected_copies).
    # None keeps the uniform round-robin closed form; the simulator sets it
    # only for non-default placements.
    copies_override: Optional[float] = None

    # ------------------------------------------------------------- attention
    def attention_layer_flops(self, seq_lens: Sequence[int]) -> float:
        """One layer of the attention stage for a batch of requests (prefill).

        qkvo projections are linear in Σs; the attention core is quadratic per
        request (causal halves it): Σ 2·s²·q_dim (scores) + Σ 2·s²·q_dim (AV).
        """
        c = self.cfg
        s1 = float(sum(seq_lens))
        s2 = float(sum(s * s for s in seq_lens))
        proj = 2.0 * s1 * c.d_model * (2 * c.q_dim + 2 * c.kv_dim)
        core = 2.0 * s2 * c.q_dim  # scores (already causal-halved: 2·s²/2·2)
        router = 2.0 * s1 * c.d_model * max(c.num_experts, 1)
        return proj + core + router

    def attention_layer_bytes(self, seq_lens: Sequence[int]) -> float:
        c = self.cfg
        s1 = float(sum(seq_lens))
        w = 2.0 * c.d_model * (2 * c.q_dim + 2 * c.kv_dim)  # bf16 weights
        act = 2.0 * s1 * (c.d_model * 4 + 2 * (c.q_dim + c.kv_dim))
        return w + act

    def attention_layer_latency(self, seq_lens: Sequence[int]) -> float:
        """Latency of one attention layer on one DP group (T chips)."""
        f = self.attention_layer_flops(seq_lens)
        b = self.attention_layer_bytes(seq_lens)
        T = self.dep.T
        return max(f / (T * self.hw.peak_flops * self.hw.flop_efficiency),
                   b / (T * self.hw.hbm_bw))

    def prefill_attention_latency(self, seq_lens: Sequence[int]) -> float:
        return self.cfg.num_layers * self.attention_layer_latency(seq_lens)

    # ---------------------------------------------------------------- decode
    def kv_token_bytes(self) -> float:
        """KV-cache bytes ONE token contributes across all layers (K and V,
        bf16) — the unit both the per-step decode read cost and the
        prefill->decode transfer cost are priced in."""
        c = self.cfg
        return 2.0 * c.num_layers * c.kv_dim * 2

    def decode_attention_step_latency(self, kv_lens: Sequence[int]) -> float:
        """One attention layer of ONE decode step over a batch of requests
        with per-row KV lengths.  Memory-bound by construction: the whole KV
        cache of every active row streams from HBM per step, the projections
        touch one token per row, and the weights stream once (batch-width
        amortized — the MegaScale-Infer decode regime)."""
        c = self.cfg
        B = len(kv_lens)
        if B == 0:
            return 0.0
        kv_total = float(sum(kv_lens))
        w = 2.0 * c.d_model * (2 * c.q_dim + 2 * c.kv_dim)  # bf16 weights
        kv_bytes = kv_total * 2.0 * c.kv_dim * 2  # K+V read per step
        act = 2.0 * B * (c.d_model * 4 + 2 * (c.q_dim + c.kv_dim))
        flops = 2.0 * B * c.d_model * (2 * c.q_dim + 2 * c.kv_dim) \
            + 4.0 * kv_total * c.q_dim
        T = self.dep.T
        return max(flops / (T * self.hw.peak_flops * self.hw.flop_efficiency),
                   (w + kv_bytes + act) / (T * self.hw.hbm_bw))

    def decode_step_latency(self, kv_lens: Sequence[int], load_model=None,
                            lkey: int = 0) -> float:
        """One full single-token decode step for a continuous batch.

        Per layer: memory-bound attention over the per-row KV caches + the
        MoE stage at batch width B (per-step expert routing through the
        SAME `ExpertLoadModel` the prefill stage uses — the step straddles
        the slowest MoE device).  One host dispatch per step (the executor
        runs ONE jitted step over all layers)."""
        c = self.cfg
        B = len(kv_lens)
        if B == 0:
            return 0.0
        attn = self.decode_attention_step_latency(kv_lens)
        if load_model is not None and c.num_experts:
            loads = load_model.device_loads(B, layer=lkey)
            hits = load_model.device_experts_hit(B, layer=lkey)
            moe = float(np.max(self.moe_device_latency(loads, hits, B)))
        else:
            moe = self.moe_layer_latency(B)
        return c.num_layers * (attn + moe) + self.hw.host_dispatch

    def kv_transfer_seconds(self, prompt_len: int) -> float:
        """Prefill->decode KV handoff cost: the prompt's whole per-layer
        cache crosses the ICI once (one link, point-to-point)."""
        return self.hw.hop_latency \
            + float(prompt_len) * self.kv_token_bytes() / self.hw.ici_bw

    # ------------------------------------------------------------------ MoE
    def expert_bytes(self) -> float:
        c = self.cfg
        return 3.0 * c.d_model * c.expert_d_ff * 2  # gate/up/down bf16

    def moe_layer_latency(self, tokens: int) -> float:
        """One MoE layer over the E expert chips for `tokens` aggregate tokens.

        Dual regime: at low token count every local expert's weights still have
        to stream from HBM (memory term ~ constant); compute grows linearly.
        """
        c = self.cfg
        if tokens <= 0 or not c.num_experts:
            return 0.0
        E, K = c.num_experts, c.top_k
        e_local = max(E // self.dep.E, 1)
        # expected local experts hit by tokens·K uniform assignments
        hit = e_local * (1.0 - (1.0 - 1.0 / E) ** (tokens * K))
        mem = (hit + (1 if c.num_shared_experts else 0)) * self.expert_bytes() \
            / self.hw.hbm_bw
        flops = tokens * K * 6.0 * c.d_model * c.expert_d_ff / self.dep.E
        if c.num_shared_experts:
            flops += tokens * c.num_shared_experts * 6.0 * c.d_model \
                * c.expert_d_ff / self.dep.E
        comp = flops / (self.hw.peak_flops * self.hw.flop_efficiency)
        act = 2.0 * tokens * K * c.d_model * 2 / self.dep.E / self.hw.hbm_bw
        return max(mem + act, comp)

    def moe_device_latency(self, assignments, experts_hit,
                           total_tokens: float = 0.0):
        """Latency of ONE MoE device processing `assignments` token-expert
        assignments across `experts_hit` resident experts (one layer).

        Vectorized: `assignments`/`experts_hit` may be numpy arrays (e.g. the
        per-device load vector of a batch, or an L×E matrix for a whole sync
        iteration) — the simulator computes all device latencies in one call
        instead of per-event Python recomputation.

        With uniform routing (assignments = tokens·K/E, experts_hit =
        e_local·(1-(1-1/N)^(tokens·K))) this equals moe_layer_latency(tokens)
        exactly, so skew=0 reproduces the seed aggregate model.
        """
        c = self.cfg
        a = np.asarray(assignments, dtype=np.float64)
        hit = np.asarray(experts_hit, dtype=np.float64)
        shared = 1.0 if c.num_shared_experts else 0.0
        mem = (hit + shared) * self.expert_bytes() / self.hw.hbm_bw
        flops = a * 6.0 * c.d_model * c.expert_d_ff
        if c.num_shared_experts:
            # shared experts see every token; token shards split uniformly
            flops = flops + float(total_tokens) * c.num_shared_experts \
                * 6.0 * c.d_model * c.expert_d_ff / self.dep.E
        comp = flops / (self.hw.peak_flops * self.hw.flop_efficiency)
        act = 2.0 * a * c.d_model * 2 / self.hw.hbm_bw
        out = np.maximum(mem + act, comp)
        out = np.where(a + float(total_tokens) > 0, out, 0.0)
        return out if out.ndim else float(out)

    def moe_inflection_tokens(self, hot_fraction: Optional[float] = None) -> int:
        """Token count where the MoE stage leaves the memory-bound plateau.

        `hot_fraction` is the share of all token-assignments landing on the
        most-loaded device (ExpertLoadModel.hot_fraction()); default 1/E
        (uniform routing). Under skew the hottest device goes compute-bound
        at FEWER aggregate tokens, so the batcher's inflection target shrinks.
        """
        frac = hot_fraction if hot_fraction is not None else 1.0 / self.dep.E
        lo, hi = 1, 1 << 22
        while lo < hi:
            mid = (lo + hi) // 2
            c = self.cfg
            flops = mid * c.top_k * 6.0 * c.d_model * c.expert_d_ff * frac
            comp = flops / (self.hw.peak_flops * self.hw.flop_efficiency)
            e_local = max(c.num_experts // self.dep.E, 1)
            mem = e_local * self.expert_bytes() / self.hw.hbm_bw
            if comp >= mem:
                hi = mid
            else:
                lo = mid + 1
        return lo

    # ---------------------------------------------------------------- comms
    def dispatch_bytes(self, tokens: int) -> float:
        """Token payload an attention DP group ships to the MoE stage: one
        hidden-state copy per *distinct target device* (top-K assignments to
        experts co-located on a device are deduplicated — how DeepSeek/ASAP
        count it)."""
        c = self.cfg
        if not c.num_experts:
            return float(tokens) * c.d_model * 2
        copies = self.copies_override if self.copies_override is not None \
            else self.dep.E * (1.0 - (1.0 - 1.0 / self.dep.E) ** c.top_k)
        return float(tokens) * copies * c.d_model * 2

    def async_dispatch_latency(self, tokens: int) -> float:
        """Non-blocking shared-buffer write, E-way parallel, bounded by the
        sending group's aggregate egress (T chips x links)."""
        b = self.dispatch_bytes(tokens)
        egress = self.dep.T * self.hw.collective_bw
        ingress = self.dep.E * self.hw.ici_bw
        return self.hw.base_latency + self.hw.hop_latency \
            + b / min(egress, ingress)

    def dispatch_send_occupancy(self, tokens: int) -> float:
        """Wire time the sending attention group's main stream pays per layer.
        The paper deploys the triple-stream only on MoE devices (L2/HBM
        contention on attention devices), so this is ALWAYS serial."""
        b = self.dispatch_bytes(tokens)
        return self.hw.base_latency + b / (self.dep.T * self.hw.collective_bw)

    def moe_comm_occupancy(self, tokens: int) -> float:
        """Per-layer recv-migrate + combine-send work on the MoE devices.
        Hidden by the two communication streams when overlap is enabled."""
        b = self.dispatch_bytes(tokens)
        recv_migrate = b / self.dep.E / self.hw.hbm_bw
        combine_send = b / (self.dep.E * self.hw.collective_bw)
        return recv_migrate + combine_send + self.hw.base_latency

    def combine_wire_latency(self, tokens: int) -> float:
        """Batch-path delay for expert results to land back (always paid)."""
        b = self.dispatch_bytes(tokens)
        return self.hw.hop_latency + b / (self.dep.E * self.hw.collective_bw)

    def sync_p2p_dispatch_latency(self, tokens: int,
                                  receiver_busy: float = 0.0) -> float:
        """Blocking P2P: per-target handshake, serialized sends, receiver stall."""
        b = self.dispatch_bytes(tokens)
        per = self.hw.p2p_handshake + receiver_busy \
            + (b / self.dep.E) / self.hw.ici_bw
        return self.dep.E * per

    def async_combine_latency(self, tokens: int) -> float:
        return self.async_dispatch_latency(tokens)  # symmetric payload

    # -------------------------------------------------------------- summary
    def stage_utilization(self, token_rate: float, mean_len: float,
                          hot_factor: float = 1.0) -> dict:
        """Steady-state utilization of attention vs MoE pools at `token_rate`
        tokens/s (napkin DSE — used by optimal_deployment).

        `hot_factor` (>= 1) is the most-loaded MoE device's traffic share
        relative to uniform (max device fraction x E).  The MoE pool is gated
        by its straggler, so under routing skew the effective stage
        utilization scales by the hot device's excess (the uniform-load
        assumption undersizes the MoE pool)."""
        c = self.cfg
        L = c.num_layers
        attn_flops_tok = (2.0 * c.d_model * (2 * c.q_dim + 2 * c.kv_dim)
                          + 2.0 * mean_len * c.q_dim) * L
        attn_cap = self.dep.attention_chips * self.hw.peak_flops \
            * self.hw.flop_efficiency
        moe_flops_tok = c.top_k * 6.0 * c.d_model * c.expert_d_ff * L \
            if c.num_experts else 6.0 * c.d_model * c.d_ff * L
        moe_cap = self.dep.E * self.hw.peak_flops * self.hw.flop_efficiency
        return {"attention": token_rate * attn_flops_tok / attn_cap,
                "moe": token_rate * moe_flops_tok / moe_cap
                * max(hot_factor, 1.0)}

    def summary(self) -> dict:
        return {
            "inflection_tokens": self.moe_inflection_tokens(),
            "expert_bytes": self.expert_bytes(),
            "attn_1k": self.attention_layer_latency([1024]),
            "attn_32k": self.attention_layer_latency([32768]),
            "moe_1k": self.moe_layer_latency(1024),
            "moe_32k": self.moe_layer_latency(32768),
        }


def optimal_deployment(cfg: ModelConfig, chips: int = 32, tp: int = 4,
                       mean_len: float = 5000.0, hw: Hardware = V5E,
                       placement: Optional[Placement] = None,
                       expert_fractions: Optional[Sequence[float]] = None
                       ) -> Deployment:
    """Design-space helper (the paper notes D,T,E selection is orthogonal):
    pick the attention/MoE chip split that balances steady-state stage
    utilization for the workload's mean request length.

    Placement-aware: with a `Placement` and/or a measured
    expert-popularity vector (e.g. RouterStatsCollector.fractions_tuple()),
    the MoE side is sized off the MAX-loaded device under that placement —
    skewed routing concentrates traffic, so the straggler needs a bigger MoE
    pool (or a placement that splits it) than the uniform closed form
    suggests.  Defaults (no placement, no popularity) keep the original
    uniform-load behaviour exactly."""
    best, best_imb = None, float("inf")
    skewed = placement is not None or expert_fractions is not None
    pl = placement if placement is not None else Placement()
    n = max(cfg.num_experts, 1)
    fr = tuple(float(x) for x in expert_fractions) \
        if expert_fractions is not None else Placement.uniform_fractions(n)
    if len(fr) != n:
        fr = tuple(float(x) for x in resample_fractions(fr, n))
    for d in range(1, chips // tp):
        e = chips - d * tp
        if e <= 0:
            continue
        dep = Deployment(D=d, T=tp, E=e)
        hot = 1.0
        if skewed and cfg.num_experts:
            pl_e = pl
            if pl.policy == "explicit" and any(
                    dd >= e for h in pl.table_override for dd in h):
                # an explicit layout pins absolute device ids and cannot be
                # re-derived for a smaller candidate pool — keep the skew
                # via the popularity vector on the default base instead
                pl_e = Placement()
            hot = float(pl_e.device_fractions(fr, e).max() * e)
        u = CostModel(cfg, hw, dep).stage_utilization(1.0, mean_len,
                                                      hot_factor=hot)
        imb = abs(u["attention"] - u["moe"])
        if imb < best_imb:
            best, best_imb = dep, imb
    return best or Deployment()
