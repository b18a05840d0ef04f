"""Deterministic fault injection for the threaded executor.

Production disaggregated-EP systems treat expert-server failure as routine
(MegaScale-Infer); the paper's asynchrony argument only holds if a
straggling or dead MoE device costs capacity rather than availability.  This
module says *what goes wrong and when*:

  * `FaultPlan` -- a seeded, serializable schedule of `FaultEvent`s, the same
    schema the JAX reference's simulator and executor read (a plan written
    by one package loads in the other through `to_dict`/`from_dict`).
  * `FaultInjector` -- exactly-once consumption of due events for the
    threaded runtime (core/executor.py).  Workers poll it at loop seams;
    dispatch/combine drops are sampled at the buffer-write seams.  All
    consumption state is guarded by one private lock so concurrent workers
    never double-fire an event.

Fault kinds, as the executor interprets them:

  crash_moe      the worker thread raises `InjectedFault` and dies: the
                 supervisor fences it, re-serves its orphaned regions and
                 evacuates its experts onto the survivors.
  stall_moe      the worker sleeps `duration` WITHOUT heartbeating -- the
                 supervisor's stall detector fires.
  drop_dispatch  one batch-layer's payload region to the device is dropped
                 (never written) -- the group's combine times out and the
                 batch replays.
  drop_combine   the device computes but never sends its combine segment
                 once -- the same replay.
  delay_wake     the worker sleeps `duration` WITH heartbeats -- benign
                 latency, no failover.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

FAULT_KINDS = ("crash_moe", "stall_moe", "drop_dispatch", "drop_combine",
               "delay_wake")


class InjectedFault(RuntimeError):
    """Raised inside a worker thread by a `crash_moe` event (the executor's
    stand-in for a dying expert server)."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: at trace-time `t`, `kind` strikes MoE `device`.
    `duration` is the stall/outage length in trace seconds (crash repair,
    stall length, wake delay); drops ignore it in the executor and model it
    as a retransmit stall in the sim."""
    t: float
    kind: str
    device: int
    duration: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.t < 0 or self.duration < 0:
            raise ValueError(f"fault times must be >= 0: {self}")

    def to_dict(self) -> Dict[str, Any]:
        return {"t": self.t, "kind": self.kind, "device": self.device,
                "duration": self.duration}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultEvent":
        return cls(t=float(d["t"]), kind=str(d["kind"]),
                   device=int(d["device"]),
                   duration=float(d.get("duration", 0.0)))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic fault schedule.  `seed` names the scenario (it rides
    along in serialized plans so chaos runs are reproducible by reference);
    the schedule itself is explicit — no hidden randomness at consume time."""
    events: Tuple[FaultEvent, ...]
    seed: int = 0

    def __init__(self, events: Sequence[FaultEvent], seed: int = 0):
        object.__setattr__(self, "events",
                           tuple(sorted(events, key=lambda e: e.t)))
        object.__setattr__(self, "seed", int(seed))

    def validate(self, num_moe_devices: int) -> "FaultPlan":
        """Loud bounds check against the deployment consuming the plan."""
        for ev in self.events:
            if not (0 <= ev.device < num_moe_devices):
                raise ValueError(
                    f"fault plan targets MoE device {ev.device} but the "
                    f"deployment has {num_moe_devices} (0..{num_moe_devices - 1})")
        return self

    @classmethod
    def from_flags(cls, failure_at: Optional[float],
                   failure_duration: float,
                   fail_moe_device: Optional[int]) -> Optional["FaultPlan"]:
        """The legacy serve.py / SimConfig flag triple as a plan.  Returns
        None when no MoE-device fault is requested (a DP-group failure stays
        on the simulator's own `_fail`/`_repair` path — it has no executor
        counterpart)."""
        if fail_moe_device is None:
            return None
        if failure_at is None:
            raise ValueError("fail_moe_device requires failure_at")
        return cls(events=[FaultEvent(t=float(failure_at), kind="crash_moe",
                                      device=int(fail_moe_device),
                                      duration=float(failure_duration))])

    def to_dict(self) -> Dict[str, Any]:
        return {"seed": self.seed,
                "events": [ev.to_dict() for ev in self.events]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultPlan":
        return cls(events=[FaultEvent.from_dict(e) for e in d["events"]],
                   seed=int(d.get("seed", 0)))


class FaultInjector:
    """Exactly-once event consumption for the threaded executor.

    Armed with the executor's clock (trace seconds when the engine drives a
    TraceClock); each seam asks "is an event of my kind due for my device?"
    and a due event fires at most once, no matter how many threads race the
    query.  `fired_events()` is the audit trail the chaos tests assert on.
    """

    def __init__(self, plan: FaultPlan, num_moe_devices: int):
        self.plan = plan.validate(num_moe_devices)
        self._lock = threading.Lock()
        self._fired: List[FaultEvent] = []  # guarded_by: _lock
        self._pending: List[FaultEvent] = list(plan.events)  # guarded_by: _lock
        self._clock: Optional[Callable[[], float]] = None
        self._t0 = 0.0

    def arm(self, clock: Callable[[], float], t0: Optional[float] = None):
        """Anchor the plan's t=0.  The engine passes its TraceClock (already
        zero-based: t0=0); a bare executor arms against the current reading
        of whatever clock it runs on."""
        self._clock = clock
        self._t0 = clock() if t0 is None else float(t0)

    def _now(self) -> float:
        assert self._clock is not None, "FaultInjector.arm() before use"
        return self._clock() - self._t0

    def _take(self, device: int, kinds: Tuple[str, ...]) -> Optional[FaultEvent]:
        now = self._now()
        with self._lock:
            for ev in self._pending:
                if ev.device == device and ev.kind in kinds and ev.t <= now:
                    self._pending.remove(ev)
                    self._fired.append(ev)
                    return ev
        return None

    # ---- seams ----------------------------------------------------------
    def poll_worker(self, device: int) -> Optional[FaultEvent]:
        """Worker-loop seam: a due crash/stall/delay event for this device
        (at most one per call; the worker interprets the kind)."""
        return self._take(device, ("crash_moe", "stall_moe", "delay_wake"))

    def should_drop_dispatch(self, device: int) -> bool:
        """Dispatch-write seam: drop this batch-layer's region to `device`?"""
        return self._take(device, ("drop_dispatch",)) is not None

    def should_drop_combine(self, device: int) -> bool:
        """Combine-write seam: suppress this device's combine segment?"""
        return self._take(device, ("drop_combine",)) is not None

    # ---- audit ----------------------------------------------------------
    def fired_events(self) -> List[FaultEvent]:
        with self._lock:
            return list(self._fired)

    def pending_events(self) -> List[FaultEvent]:
        with self._lock:
            return list(self._pending)
