"""The placement control plane: the measure -> decide half of online expert
placement, shared by the simulator's rebalancer and the executor engine.

    controller = PlacementController(ep=E, num_experts=n, layers=L,
                                     target=Placement("replicated", 2),
                                     policy="hysteresis", ...)
    plan = controller.observe(WindowObservation(now, busy, fractions))
    if plan is not None:
        backend.apply(plan)        # sim: charge queue clocks; executor:
                                   # quiesce + gather weight stacks + swap

The controller consumes per-window observations -- per-device busy time
(from `AsapSim.moe_dev_busy_time` windows or the executor's measured
`moe_busy`) and per-expert routing fractions (`RouterStatsCollector`) -- and
emits `MigrationPlan`s: the placement to install plus the explicit (expert ->
dst device) weight copies with their byte costs.  Executing a plan is the
backend's job (the decision is runtime-agnostic; the mechanism is not):

  * `AsapSim` charges `plan.device_cost(expert_bytes/ici_bw)` to the
    receiving devices' queue clocks, barrier-free.
  * `DisaggregatedExecutor.apply_placement` quiesces the MoE devices,
    builds the receivers' new resident stacks and atomically swaps the
    dispatch tables.

Pure Python and numpy, copied from the reference
(`repro.core.placement_control`) with nothing changed in the arithmetic or
the order of its operations, so the same observations give the same plans.

Policy family (the rebalance decision is a pluggable policy, not a
hard-coded threshold):

  one_shot_threshold -- once the observed busy max/mean imbalance crosses
      `threshold`, migrate to the target placement in one plan; never move
      again.
  hysteresis -- separate trigger/release thresholds + a cooldown (in
      windows): migrate to the target above `threshold`, revert to the boot
      placement only once imbalance falls below `release_threshold`, and
      never emit two plans within `cooldown_windows` of each other --
      oscillating load cannot thrash weights back and forth.
  partial -- cap the bytes migrated per window (`max_bytes_per_window`):
      each window re-places the hottest not-yet-moved experts whose copies
      fit the cap (at least one, so progress is guaranteed), pinning the
      intermediate layout as an explicit-table `Placement`; converges to the
      target over several windows.
  drift -- EWMA popularity tracking (`drift_alpha`) over measured routing
      windows: the target policy's table is re-derived from the smoothed
      popularity each window and re-placed as soon as it changes (subject to
      the cooldown) -- slow topic shifts re-place experts BEFORE the busy-time
      imbalance ever trips a threshold.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cost_model import Placement

Table = Tuple[Tuple[int, ...], ...]


@dataclasses.dataclass(frozen=True)
class WindowObservation:
    """One rebalance window's measurements, in backend-native units.

    `busy` — per-MoE-device busy time accumulated during the window (virtual
    seconds in the sim, clock units in the executor).  `fractions` — the
    per-expert routing fractions observed so far (RouterStatsCollector
    .fractions(), or the sim load model's expectation); None means "no new
    routing information" and keeps the controller's current popularity view.
    """
    now: float
    busy: np.ndarray
    fractions: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class ExpertMove:
    """One expert weight copy: expert `expert` becomes resident on `dst`.

    `copies` is the number of per-layer weight copies the move ships (layers
    sharing one placement table migrate together); `nbytes` is the wire cost
    at the controller's `bytes_per_copy`.  `lkey` identifies the placement
    table the move belongs to (non-zero only under per-layer skew)."""
    expert: int
    dst: int
    lkey: int = 0
    copies: int = 1
    nbytes: float = 0.0


@dataclasses.dataclass
class MigrationPlan:
    """What the controller wants installed: the new `placement` plus the
    explicit weight copies it implies.  Backends install the placement and
    charge/execute the moves; `partial` is True while the plan is an
    intermediate step toward the target."""
    placement: Placement
    moves: List[ExpertMove]
    window: int = 0
    partial: bool = False
    reason: str = ""

    @property
    def total_bytes(self) -> float:
        return float(sum(m.nbytes for m in self.moves))

    def receivers(self) -> Tuple[int, ...]:
        return tuple(sorted({m.dst for m in self.moves}))

    def device_cost(self, per_copy_cost: float, ep: int) -> np.ndarray:
        """Per-device migration cost at `per_copy_cost` units per expert-layer
        copy, accumulated move-by-move in plan order (the receiving device
        pays).  The iteration order is (lkey, expert, host), the order the
        simulator charges its queue clocks in: a change here moves the
        simulator's floats."""
        out = np.zeros(ep)
        for m in self.moves:
            out[m.dst] += per_copy_cost * m.copies
        return out


def diff_tables(old: Table, new: Table, lkey: int = 0, copies: int = 1,
                bytes_per_copy: float = 0.0) -> List[ExpertMove]:
    """Expert copies present in `new` but not `old` (receivers pay; dropping
    a copy is free).  Order: expert-major, then the new table's host order —
    the simulator's migration-charging order."""
    moves: List[ExpertMove] = []
    for e, hosts in enumerate(new):
        old_hosts = old[e]
        for d in hosts:
            if d not in old_hosts:
                moves.append(ExpertMove(expert=e, dst=d, lkey=lkey,
                                        copies=copies,
                                        nbytes=bytes_per_copy * copies))
    return moves


POLICIES = ("one_shot_threshold", "hysteresis", "partial", "drift")


class PlacementController:
    """Backend-agnostic measure→decide loop for online expert placement.

    Construction pins the geometry (`ep` devices, `num_experts`, `layers`)
    and the policy; `observe()` is called once per rebalance window and
    returns a `MigrationPlan` when weights should move (None otherwise).
    The controller tracks what it believes is installed (`placement`); a
    backend that switches placement outside the controller (failure
    injection) must call `sync()`.

    `table_fn(placement, fractions) -> {lkey: table}` builds the placement
    tables the plan diffs — the default derives ONE table from
    `Placement.table` (the executor's view); the simulator overrides it with
    its load model's per-layer tables so zipf-mode skew keeps per-layer
    migration accounting.  `layers` is split evenly across the returned
    tables (L tables → 1 copy each; 1 table → L copies).
    """

    def __init__(self, *, ep: int, num_experts: int,
                 target: Placement, layers: int = 1,
                 policy: str = "one_shot_threshold",
                 threshold: float = 1.05,
                 release_threshold: Optional[float] = None,
                 cooldown_windows: int = 1,
                 max_bytes_per_window: Optional[float] = None,
                 drift_alpha: float = 0.3,
                 bytes_per_copy: float = 0.0,
                 initial: Placement = Placement(),
                 initial_fractions: Optional[Sequence[float]] = None,
                 table_fn: Optional[
                     Callable[[Placement, Tuple[float, ...]],
                              Dict[int, Table]]] = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown rebalance policy {policy!r} "
                             f"(expected one of {POLICIES})")
        if policy == "partial" and not max_bytes_per_window:
            raise ValueError("policy='partial' requires max_bytes_per_window")
        if release_threshold is not None and release_threshold > threshold:
            raise ValueError(
                f"release_threshold ({release_threshold}) must not exceed "
                f"the trigger threshold ({threshold})")
        self.ep = int(ep)
        self.num_experts = max(int(num_experts), 1)
        self.layers = max(int(layers), 1)
        self.policy = policy
        self.threshold = float(threshold)
        self.release_threshold = float(release_threshold) \
            if release_threshold is not None else None
        self.cooldown_windows = max(int(cooldown_windows), 0)
        self.max_bytes_per_window = max_bytes_per_window
        self.drift_alpha = float(drift_alpha)
        self.bytes_per_copy = float(bytes_per_copy)
        self.base = initial  # the boot placement hysteresis reverts to
        self.target = target
        self.placement = initial  # what the controller believes is installed
        fr = tuple(float(x) for x in initial_fractions) \
            if initial_fractions is not None \
            else Placement.uniform_fractions(self.num_experts)
        self.fractions: Tuple[float, ...] = fr
        self._table_fn = table_fn if table_fn is not None \
            else self._default_table_fn
        self.window = 0
        self._last_plan_window: Optional[int] = None
        self.plans: List[MigrationPlan] = []  # emitted-plan history

    # ------------------------------------------------------------ plumbing
    def _default_table_fn(self, placement: Placement,
                          fractions: Tuple[float, ...]) -> Dict[int, Table]:
        return {0: placement.table(fractions, self.ep)}

    def _tables(self, placement: Placement) -> Dict[int, Table]:
        return self._table_fn(placement, self.fractions)

    def _build_plan(self, new_placement: Placement, *, partial: bool = False,
                    reason: str = "") -> MigrationPlan:
        """Diff current→new tables lkey by lkey (ascending — the
        simulator's charging order) into a move list."""
        old_t = self._tables(self.placement)
        new_t = self._tables(new_placement)
        lkeys = sorted(new_t)
        copies = max(self.layers // max(len(lkeys), 1), 1)
        moves: List[ExpertMove] = []
        for l in lkeys:
            moves += diff_tables(old_t.get(l, new_t[l]), new_t[l], lkey=l,
                                 copies=copies,
                                 bytes_per_copy=self.bytes_per_copy)
        return MigrationPlan(placement=new_placement, moves=moves,
                             window=self.window, partial=partial,
                             reason=reason)

    def _emit(self, plan: MigrationPlan) -> MigrationPlan:
        self.placement = plan.placement
        self._last_plan_window = self.window
        self.plans.append(plan)
        return plan

    @staticmethod
    def imbalance(busy: np.ndarray) -> float:
        """Observed busy-time max/mean over the window (1.0 == balanced or
        idle)."""
        mean = float(np.asarray(busy).mean())
        return float(np.asarray(busy).max() / mean) if mean > 0 else 1.0

    def _cooling(self) -> bool:
        return (self._last_plan_window is not None
                and self.window - self._last_plan_window
                < self.cooldown_windows)

    # ---------------------------------------------------------------- state
    @property
    def converged(self) -> bool:
        """Installed placement reached the target (table-level: an explicit
        placement whose table equals the target's counts as converged)."""
        if self.placement == self.target:
            return True
        if self.placement.policy == "explicit":
            return self._tables(self.placement) == self._tables(self.target)
        return False

    @property
    def active(self) -> bool:
        """Whether future windows can still produce plans — the backend's
        keep-ticking predicate.  One-shot/partial controllers go quiet once
        converged (a tick-until-migrated loop); hysteresis and
        drift watch the load forever."""
        if self.policy in ("hysteresis", "drift"):
            return True
        return not self.converged

    def sync(self, *, placement: Optional[Placement] = None,
             target: Optional[Placement] = None,
             base: Optional[Placement] = None):
        """Resynchronize after an out-of-band switch (failure injection
        re-places experts without consulting the controller).  `base` must
        be updated too when devices die — a hysteresis release re-installs
        it, and the boot layout must never route traffic to a dead device."""
        if placement is not None:
            self.placement = placement
        if target is not None:
            self.target = target
        if base is not None:
            self.base = base

    # -------------------------------------------------------------- policies
    def observe(self, obs: WindowObservation) -> Optional[MigrationPlan]:
        """Consume one window; return the MigrationPlan to execute, if any."""
        self.window += 1
        if obs.fractions is not None:
            fr = tuple(float(x) for x in np.asarray(obs.fractions))
            if len(fr) == self.num_experts and sum(fr) > 0:
                if self.policy == "drift":
                    a = self.drift_alpha
                    prev = np.asarray(self.fractions)
                    new = (1.0 - a) * prev + a * np.asarray(fr)
                    self.fractions = tuple(float(x) for x in
                                           new / max(new.sum(), 1e-12))
                else:
                    self.fractions = fr
        imb = self.imbalance(obs.busy)
        return getattr(self, f"_observe_{self.policy}")(obs, imb)

    def _observe_one_shot_threshold(self, obs, imb) -> Optional[MigrationPlan]:
        if self.placement != self.target and imb >= self.threshold:
            return self._emit(self._build_plan(
                self.target, reason=f"imbalance {imb:.3f} >= "
                f"{self.threshold:.3f}"))
        return None

    def _observe_hysteresis(self, obs, imb) -> Optional[MigrationPlan]:
        if self._cooling():
            return None
        if self.placement != self.target and imb >= self.threshold:
            return self._emit(self._build_plan(
                self.target, reason=f"trigger: imbalance {imb:.3f}"))
        release = self.release_threshold
        if release is not None and self.placement != self.base \
                and imb <= release:
            return self._emit(self._build_plan(
                self.base, reason=f"release: imbalance {imb:.3f}"))
        return None

    def _observe_partial(self, obs, imb) -> Optional[MigrationPlan]:
        started = self._last_plan_window is not None
        if self.converged or (not started and imb < self.threshold):
            return None
        # per-expert diff between the installed table and the target table
        # (explicit plans pin ONE table, so partial migration operates on the
        # lkey-0 view; per-layer zipf tables collapse onto it)
        cur = self._tables(self.placement)
        tgt = self._tables(self.target)
        l0 = sorted(tgt)[0]
        cur_t, tgt_t = cur.get(l0, tgt[l0]), tgt[l0]
        fr = np.asarray(self.fractions)
        todo = [e for e in range(len(tgt_t)) if cur_t[e] != tgt_t[e]]
        if not todo:
            # nothing left by the l0 view: install the target placement
            # OBJECT (so convergence is placement-level equality) without
            # re-shipping anything — under per-layer zipf tables a
            # _build_plan(self.target) here would diff every layer's table
            # against the collapsed explicit one and blow the byte cap
            return self._emit(MigrationPlan(
                placement=self.target, moves=[], window=self.window,
                partial=False, reason="partial: target reached"))
        todo.sort(key=lambda e: -fr[e] if e < len(fr) else 0.0)
        cap = float(self.max_bytes_per_window)
        new_hosts = [list(h) for h in cur_t]
        moves: List[ExpertMove] = []
        spent = 0.0
        for e in todo:
            add = [d for d in tgt_t[e] if d not in cur_t[e]]
            cost = self.bytes_per_copy * self.layers * len(add)
            # always take at least one expert so a cap below a single
            # expert's copy cost still converges (soft floor, logged in
            # the plan reason)
            if moves and spent + cost > cap:
                continue
            new_hosts[e] = list(tgt_t[e])
            moves += [ExpertMove(expert=e, dst=d, lkey=l0,
                                 copies=self.layers,
                                 nbytes=self.bytes_per_copy * self.layers)
                      for d in add]
            spent += cost
        remaining = sum(1 for e in range(len(tgt_t))
                        if tuple(new_hosts[e]) != tgt_t[e])
        if remaining == 0:
            # final step: this window's capped selection finishes the l0
            # diff — install the target placement with exactly those moves
            # (never an uncapped all-layer re-diff)
            plan = MigrationPlan(placement=self.target, moves=moves,
                                 window=self.window, partial=False,
                                 reason="partial: final step")
        else:
            plan = MigrationPlan(
                placement=Placement.explicit(new_hosts), moves=moves,
                window=self.window, partial=True,
                reason=f"partial: {remaining} experts remaining, "
                f"{spent:.0f}B this window")
        return self._emit(plan)

    def _observe_drift(self, obs, imb) -> Optional[MigrationPlan]:
        if self._cooling():
            return None
        desired = self.target.table(self.fractions, self.ep)
        cur = self._tables(self.placement)
        cur_t = cur[sorted(cur)[0]]
        if cur_t == desired:
            return None
        # pin the EWMA-derived table explicitly: the target policy object
        # would re-derive it from whatever fractions the backend holds
        return self._emit(MigrationPlan(
            placement=Placement.explicit(desired),
            moves=diff_tables(cur_t, desired, lkey=0, copies=self.layers,
                              bytes_per_copy=self.bytes_per_copy),
            window=self.window, partial=False,
            reason="drift: EWMA popularity re-derived the table"))
