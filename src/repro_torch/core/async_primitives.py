"""Asynchronous communication primitives (paper §3.2) — faithful protocol model.

The paper's distributed shared-memory abstraction, reproduced with real shared
buffers + bitmap flags + backpressure, executed by the threaded MPMD runtime in
core/executor.py (each simulated NPU = a thread; buffers = process memory,
which is exactly the "globally visible buffer" role UB plays on CloudMatrix).

Buffer structure mirrors Table 2:

  MoE device buffer   — D regions × T rows; each row holds (token metadata,
                        token payload); one T-bit bitmap flag per region.
  Attn device buffer  — E result segments (+ routing metadata); E-bit bitmap.

Protocol invariants (asserted in tests):
  * senders never handshake: write + set-flag, then return (async-*-send);
  * a sender blocks ONLY on backpressure (its previous write not yet drained);
  * receivers poll flags and drain complete regions out-of-order (§3.4.2);
  * flags are cleared by the receiver — acknowledgment is implicit.

`SyncP2P` is the blocking baseline used for the Fig 14 comparison: sender and
receiver rendezvous (handshake) and the transfer occupies both ends.

In the PyTorch port the payload `tokens` / `outputs` are torch tensors that
stay on the executor's device (ids are small host arrays); a payload carries
the CUDA event (`ready`) its consumer's stream waits on before reading them.
Everything else is threading only -- this module imports neither torch nor
numpy.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, List, Optional, Tuple


class AbortedError(RuntimeError):
    """A blocking buffer wait observed the executor's stop event (shutdown or
    panic).  Distinct from TimeoutError so the fault-retry path (a region
    genuinely lost to an injected fault) is never confused with a shutdown —
    see DisaggregatedExecutor."""


class Bitmap:
    """An N-bit flag word with condition-variable semantics.

    `cv` lets several bitmaps share ONE condition variable (and lock): the
    MoE device buffer hands the same cv to all D region bitmaps so a receiver
    can block in `wait_any` on "any region complete" and be woken by whichever
    sender sets the completing bit — no sleep-polling."""

    def __init__(self, n: int, cv: Optional[threading.Condition] = None):
        self.n = n
        self._bits = 0  # guarded_by: _cv
        self._cv = cv if cv is not None else threading.Condition()

    @property
    def full(self) -> bool:
        """All n bits set. Caller must hold the (shared) cv lock."""
        return self._bits == (1 << self.n) - 1  # race-ok: documented caller-holds-cv contract; every in-repo caller is inside `with cv`

    def set_bit(self, i: int):
        with self._cv:
            self._bits |= (1 << i)
            self._cv.notify_all()

    def clear(self):
        with self._cv:
            self._bits = 0
            self._cv.notify_all()

    def test(self, i: int) -> bool:
        with self._cv:
            return bool(self._bits & (1 << i))

    def all_set(self) -> bool:
        with self._cv:
            return self.full

    def any_set(self) -> bool:
        """Any bit set, under the cv lock.  The shared-cv case is safe to
        call with the cv already held (Condition's default lock is an RLock,
        and an explicit shared cv is re-entered by the same thread)."""
        with self._cv:
            return self._bits != 0

    def wake(self):
        """Wake blocked waiters (pair with setting a `stop` event so parked
        threads observe it promptly on shutdown/panic)."""
        with self._cv:
            self._cv.notify_all()

    @staticmethod
    def _wait_slice(deadline: Optional[float]) -> Optional[float]:
        """Next cv.wait slice: <= 0.05s so a stop event set without a
        matching wake() still exits promptly AND so no single cv.wait
        exceeds the lockdep held-lock-wait budget (the failover path blocks
        in these waits while holding the executor's swap lock).
        None signals timeout expiry."""
        wait = 0.05
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            wait = min(wait, remaining)
        return wait

    def wait_all(self, timeout: Optional[float] = None,
                 stop: Optional[threading.Event] = None) -> bool:
        """Block until all n bits are set.  Returns False on timeout; raises
        AbortedError once `stop` is set (shutdown/panic)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not self.full:
                if stop is not None and stop.is_set():
                    raise AbortedError("bitmap wait_all aborted: stop is set")
                wait = self._wait_slice(deadline)
                if wait is None:
                    return False
                self._cv.wait(wait)
            return True

    def wait_clear(self, i: int, timeout: Optional[float] = None,
                   stop: Optional[threading.Event] = None) -> bool:
        """Backpressure: block while bit i is still set.  Returns False on
        timeout; raises AbortedError once `stop` is set."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._bits & (1 << i):
                if stop is not None and stop.is_set():
                    raise AbortedError("bitmap wait_clear aborted: stop is set")
                wait = self._wait_slice(deadline)
                if wait is None:
                    return False
                self._cv.wait(wait)
            return True


@dataclasses.dataclass
class DispatchPayload:
    """One TP member's shard of a dispatched batch-layer (region row)."""
    layer: int
    slot: int  # dual-batch slot (0/1) on the sending group
    counts: Any  # tokens per local expert (metadata ①)
    tokens: Any  # hidden states (payload ②)
    token_ids: Any  # positions for combine
    expert_ids: Any  # local expert index per row
    weights: Any = None
    ready: Any = None  # CUDA event recorded after `tokens` was produced


class MoEDeviceBuffer:
    """Shared buffer resident on one MoE device: D regions × T rows + flags."""

    def __init__(self, D: int, T: int):
        self.D, self.T = D, T
        # region rows are preallocated once and overwritten in place — a
        # drain clears slots instead of reallocating the row list, mirroring
        # a fixed shared-memory region on the real device
        self.rows: List[List[Optional[DispatchPayload]]] = \
            [[None] * T for _ in range(D)]  # guarded_by: protocol
        # all regions share one condition variable so `wait_any` can block on
        # "any region complete" and wake on the completing sender's set_bit
        self._cv = threading.Condition()
        self.flags = [Bitmap(T, cv=self._cv) for _ in range(D)]

    # ---- sender side (attention device NPU_ij) ----
    def dispatch_send(self, dp_i: int, tp_j: int, payload: DispatchPayload,
                      timeout: Optional[float] = 240.0,
                      stop: Optional[threading.Event] = None):
        """async-dispatch-send: backpressure-wait, write, set flag, return."""
        if not self.flags[dp_i].wait_clear(tp_j, timeout, stop=stop):
            raise TimeoutError("dispatch backpressure timeout")
        # race-ok: bitmap handshake — flag clear ⇒ receiver drained this row,
        # and the write happens-before the flag set that publishes it
        self.rows[dp_i][tp_j] = payload
        self.flags[dp_i].set_bit(tp_j)

    # ---- receiver side (MoE device) ----
    def poll_ready(self) -> Optional[int]:
        """Any region with all T flags set (out-of-order across DP groups)."""
        for i in range(self.D):
            if self.flags[i].all_set():
                return i
        return None

    def wait_any(self, timeout: Optional[float] = None,
                 stop: Optional[threading.Event] = None) -> Optional[int]:
        """Block until ANY region has all T flags set; return its index.

        Event-driven replacement for the poll_ready + sleep loop: the shared
        condition variable is notified by every dispatch_send, so the receiver
        wakes exactly when a region completes.  Returns None on `timeout`
        expiry or once `stop` is set (checked on every wakeup; pair with
        `wake()` after setting the event for a prompt exit)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                for i in range(self.D):
                    if self.flags[i].full:
                        return i
                if stop is not None and stop.is_set():
                    return None
                wait = None if deadline is None \
                    else deadline - time.monotonic()
                if wait is not None and wait <= 0:
                    return None
                self._cv.wait(wait)

    def wake(self):
        """Wake any `wait_any` blockers (used on executor shutdown)."""
        with self._cv:
            self._cv.notify_all()

    def any_pending(self) -> bool:
        """True while any region holds undrained rows (any flag bit set).
        The live re-placement quiesce polls this with dispatch
        frozen: once it reads False and the device reports no in-flight
        region, every payload routed under the OLD dispatch tables has been
        served and the resident weight stacks may be swapped."""
        with self._cv:  # hold once for a consistent snapshot across regions
            return any(f.any_set() for f in self.flags)

    def dispatch_recv(self, dp_i: int) -> List[DispatchPayload]:
        """async-dispatch-recv: migrate payload to private memory, clear flags."""
        assert self.flags[dp_i].all_set(), "recv before region complete"
        # race-ok: region complete — every sender's set_bit happened-before
        # all_set() observed true, and no sender rewrites until the clear below
        row = self.rows[dp_i]
        out = list(row)  # "migrate to private memory"
        for j in range(self.T):  # clear the preallocated row in place
            row[j] = None
        self.flags[dp_i].clear()  # acknowledge: sender may write again
        return out  # type: ignore

    def recv_any(self, timeout: Optional[float] = None,
                 stop: Optional[threading.Event] = None,
                 admit: Optional[Callable[[], bool]] = None,
                 on_take: Optional[Callable[[int, List[DispatchPayload]],
                                            None]] = None):
        """wait_any + dispatch_recv as ONE atomic step under the shared cv
       .  The split API leaves a window between "region i is
        ready" and "take region i" in which a supervisor evacuating a dead
        device could take the same region — the fused version checks the
        admission fence and migrates the rows without dropping the lock.

          admit    worker-generation fence: evaluated under the cv; a False
                   return means this receiver was fenced out by a failover
                   (`fenced`) and must exit — returns None immediately.
          on_take  runs under the cv AFTER the rows are migrated and BEFORE
                   the flags clear — the worker publishes "I am serving
                   region i" (`_moe_active`/`_moe_current`) with no gap the
                   quiesce or the supervisor could observe.

        Returns (region, rows), or None on timeout/stop/fence."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                if admit is not None and not admit():
                    return None  # fenced out by a failover
                for i in range(self.D):
                    if self.flags[i].full:
                        # race-ok: region complete and cv held — no sender
                        # rewrites until the clear below (same handshake as
                        # dispatch_recv, fused with the wait)
                        row = self.rows[i]
                        out = list(row)
                        for j in range(self.T):
                            row[j] = None
                        if on_take is not None:
                            on_take(i, out)
                        self.flags[i].clear()  # re-entrant: shares this cv
                        return i, out
                if stop is not None and stop.is_set():
                    return None
                wait = 0.05 if timeout is None \
                    else min(0.05, deadline - time.monotonic())
                if wait <= 0 and timeout is not None:
                    return None
                self._cv.wait(wait)

    def recv_many(self, max_regions: Optional[int] = None,
                  timeout: Optional[float] = None,
                  stop: Optional[threading.Event] = None,
                  admit: Optional[Callable[[], bool]] = None,
                  on_take: Optional[Callable[[int, List[DispatchPayload]],
                                             None]] = None):
        """Atomic MULTI-take: drain every currently-complete region (up to
        `max_regions`) under ONE cv acquisition.  The continuous
        batcher's primitive — N sequential `recv_any` calls would re-acquire
        the cv N times and leave N-1 windows in which a supervisor fence or a
        quiesce could interleave mid-drain; here the admission check, every
        row migration, every `on_take` publication, and every flag clear
        happen in one critical section, so the batch the worker serves is
        exactly the batch it published.

          max_regions  cap on regions taken this call (None = all D).
          admit        worker-generation fence, evaluated under the cv BEFORE
                       any take; False ⇒ fenced out, returns None.
          on_take      runs under the cv per region, AFTER its rows migrate
                       and BEFORE its flags clear — same publication contract
                       as `recv_any` (no observable taken-but-unpublished
                       gap), invoked once per region in take order.

        Blocks like `recv_any` while NOTHING is ready; once at least one
        region is complete it takes all complete regions WITHOUT waiting for
        more (accumulation windows are the caller's policy, layered on
        timeout=0 re-drains).  Returns a non-empty list of (region, rows)
        pairs, or None on timeout/stop/fence."""
        cap = self.D if max_regions is None else max(1, min(max_regions, self.D))
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                if admit is not None and not admit():
                    return None  # fenced out by a failover
                taken: List[Tuple[int, List[DispatchPayload]]] = []
                for i in range(self.D):
                    if len(taken) >= cap:
                        break
                    if self.flags[i].full:
                        # race-ok: region complete and cv held — identical
                        # handshake to recv_any, repeated per region inside
                        # the same critical section
                        row = self.rows[i]
                        out = list(row)
                        for j in range(self.T):
                            row[j] = None
                        if on_take is not None:
                            on_take(i, out)
                        self.flags[i].clear()  # re-entrant: shares this cv
                        taken.append((i, out))
                if taken:
                    return taken
                if stop is not None and stop.is_set():
                    return None
                wait = 0.05 if timeout is None \
                    else min(0.05, deadline - time.monotonic())
                if wait <= 0 and timeout is not None:
                    return None
                self._cv.wait(wait)

    def fenced(self, fn: Callable[[], Any]) -> Any:
        """Run `fn` under the buffer's shared cv: the supervisor bumps the
        worker-generation fence through here, atomically w.r.t. every
        `recv_any` admission check, then wakes parked receivers so a fenced
        worker observes the bump promptly."""
        with self._cv:
            out = fn()
            self._cv.notify_all()
            return out


@dataclasses.dataclass
class CombinePayload:
    layer: int
    token_ids: Any
    expert_ids: Any
    outputs: Any  # expert results (②)
    ready: Any = None  # CUDA event recorded after `outputs` was produced


class AttnDeviceBuffer:
    """Shared buffer on one attention device: E result segments + E-bit flag.
    One instance per dual-batch slot."""

    def __init__(self, E: int):
        self.E = E
        self.segments: List[Optional[CombinePayload]] = [None] * E  # guarded_by: protocol
        self.flags = Bitmap(E)

    # ---- sender side (MoE device e) ----
    def combine_send(self, e: int, payload: CombinePayload,
                     timeout: Optional[float] = 240.0,
                     stop: Optional[threading.Event] = None):
        if not self.flags.wait_clear(e, timeout, stop=stop):
            raise TimeoutError("combine backpressure timeout")
        # race-ok: bitmap handshake — bit e clear ⇒ receiver drained segment e
        self.segments[e] = payload
        self.flags.set_bit(e)

    def has_segment(self, e: int) -> bool:
        """Bit e set: device e's result for the parked batch-layer is already
        delivered and unconsumed.  The failover path's first-combine-wins
        pre-check."""
        return self.flags.test(e)

    def wake(self):
        """Wake blocked combine waiters (executor shutdown/panic)."""
        self.flags.wake()

    # ---- receiver side (attention device) ----
    def combine_recv(self, timeout: Optional[float] = 240.0,
                     stop: Optional[threading.Event] = None
                     ) -> List[CombinePayload]:
        """Wait for ALL E segments (empty results still send a marker so the
        bitmap completes — 'all activated expert results received')."""
        if not self.flags.wait_all(timeout, stop=stop):
            raise TimeoutError("combine recv timeout")
        # race-ok: all E set_bits happened-before wait_all returned true;
        # senders stay blocked on backpressure until the clear below
        out = list(self.segments)
        self.segments = [None] * self.E  # race-ok: same window — flags still set
        self.flags.clear()
        return out  # type: ignore

    def scrub(self):
        """Drop any parked segments and clear the flags (fault-retry path).
        The caller (DisaggregatedExecutor._scrub_group_slot) has verified no
        MoE device still serves this (group, slot) — so no sender is parked
        in backpressure and none will write until the group re-dispatches."""
        # race-ok: caller-guaranteed quiescence (no sender active for this
        # buffer; the owning group worker is the only other toucher)
        self.segments = [None] * self.E
        self.flags.clear()


# ---------------------------------------------------------------------------
# Synchronous P2P baseline (Fig 14)
# ---------------------------------------------------------------------------


class SyncP2P:
    """Blocking point-to-point: sender and receiver must rendezvous; the
    transfer completes only once the receiver has accepted it (handshake +
    receiver-busy stall — the overheads §5.4 attributes to sync P2P)."""

    def __init__(self):
        self._lock = threading.Condition()
        self._mailbox: Optional[Tuple[Any, Any]] = None  # guarded_by: _lock
        self._ready = False  # receiver parked in recv()  guarded_by: _lock

    def send(self, tag: Any, payload: Any, timeout: Optional[float] = 240.0):
        with self._lock:
            if not self._lock.wait_for(lambda: self._ready and
                                       self._mailbox is None, timeout):
                raise TimeoutError("p2p send: no receiver")
            self._mailbox = (tag, payload)
            self._lock.notify_all()
            # blocking: wait for the receiver to take it (ack)
            if not self._lock.wait_for(lambda: self._mailbox is None, timeout):
                raise TimeoutError("p2p send: no ack")

    def recv(self, timeout: Optional[float] = 240.0) -> Tuple[Any, Any]:
        with self._lock:
            self._ready = True
            self._lock.notify_all()
            if not self._lock.wait_for(lambda: self._mailbox is not None,
                                       timeout):
                raise TimeoutError("p2p recv timeout")
            out = self._mailbox
            self._mailbox = None
            self._ready = False
            self._lock.notify_all()
            return out
