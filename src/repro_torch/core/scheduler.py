"""Request scheduling policies.

ASAP (§3.3): length-aware batching + dual-batch pairing. The batcher only has
to exceed the MoE inflection point -- it does NOT balance across DP groups,
because the async pipeline lets groups progress independently. Under
expert-routing skew the inflection target is the HOTTEST MoE device's
compute-bound knee, not the aggregate stage's (the simulator derives it via
CostModel.moe_inflection_tokens(ExpertLoadModel.hot_fraction())).
`DecodeAdmissionQueue` admits requests into the decode stage of
prefill/decode serving.

Baselines of the simulator (§5.1):
  Default        -- vLLM-like: aggregate queued requests and partition into D
                    sub-batches with balanced *total token counts* (LPT
                    greedy).  Balancing sum(s) is provably inadequate because
                    attention cost is sum(s^2) (paper §2.2.1).
  ChunkedPrefill -- split long prompts into fixed-size chunks, reducing
                    sequence-length variance; still synchronous.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.trace import Request

_batch_counter = itertools.count()


@dataclasses.dataclass
class Batch:
    requests: List[Request]
    bid: int = dataclasses.field(default_factory=lambda: next(_batch_counter))
    exclusive: bool = False  # long batch: no dual-batch interleaving (§3.3.2)
    # chunked-prefill bookkeeping
    chunk_of: Optional[Request] = None
    chunk_start: int = 0
    chunk_len: int = 0

    @property
    def seq_lens(self) -> List[int]:
        if self.chunk_of is not None:
            return [self.chunk_len]
        return [r.length for r in self.requests]

    @property
    def total_tokens(self) -> int:
        return sum(self.seq_lens)


@dataclasses.dataclass
class LengthAwareBatcher:
    """ASAP §3.3.1 + §3.3.2.

    Accumulates requests until Σ tokens ≥ `inflection` (then keeps them for
    pairing), caps batches at `max_tokens`, gives > `exclusive_cutoff` requests
    an exclusive batch with interleaving disabled, and flushes on `max_wait`.
    """
    inflection: int
    max_tokens: int = 32_768
    exclusive_cutoff: int = 16_384
    max_wait: float = 0.02  # seconds a pending batch may age before flush

    _pending: List[Request] = dataclasses.field(default_factory=list)
    # per-request enqueue times: the age clock tracks the OLDEST pending
    # request (_pending_t[0]), so a partial emission does not restart the
    # timer for leftovers (which would let them wait up to 2x max_wait).
    _pending_t: List[float] = dataclasses.field(default_factory=list)

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    @property
    def pending_tokens(self) -> int:
        return sum(r.length for r in self._pending)

    def next_flush_due(self, now: float) -> Optional[float]:
        """When the oldest pending request will age out (None if empty) —
        the executor engine's admission loop sleeps until min(next arrival,
        this deadline) instead of spin-polling the batcher."""
        if not self._pending:
            return None
        return self._pending_t[0] + self.max_wait

    def retarget(self, inflection: float) -> int:
        """Re-derive the inflection target online: the placement control
        plane calls this
        when a placement switch moves the hottest MoE device's compute-bound
        knee.  Pending requests are kept — they are simply judged against
        the new target on the next add/poll.  Clamped to >= 1 (a zero target
        would emit empty-forever batches); returns the previous target so
        callers can log the change."""
        old = self.inflection
        self.inflection = max(int(inflection), 1)
        return old

    def expel(self, pred) -> List[Request]:
        """Remove and return every pending request matching `pred`.  `_pending` and
        `_pending_t` stay in lockstep; survivors keep their original age so
        aging-based flushes are unaffected."""
        hit = [i for i, r in enumerate(self._pending) if pred(r)]
        if not hit:
            return []
        out = [self._pending[i] for i in hit]
        drop = set(hit)
        self._pending = [r for i, r in enumerate(self._pending)
                         if i not in drop]
        self._pending_t = [t for i, t in enumerate(self._pending_t)
                           if i not in drop]
        return out

    def add(self, req: Request, now: float) -> List[Batch]:
        out: List[Batch] = []
        if req.length > self.exclusive_cutoff:
            out.append(Batch(requests=[req], exclusive=True))
            out.extend(self.poll(now))
            return out
        self._pending.append(req)
        self._pending_t.append(now)
        out.extend(self.poll(now))
        return out

    def poll(self, now: float) -> List[Batch]:
        """Emit batches whose token count passed the inflection point (or aged)."""
        out: List[Batch] = []
        while True:
            total, cut = 0, 0
            for i, r in enumerate(self._pending):
                if total + r.length > self.max_tokens and total > 0:
                    break
                total += r.length
                cut = i + 1
            if cut == 0:
                break
            aged = now - self._pending_t[0] >= self.max_wait
            if total >= self.inflection or total >= self.max_tokens or aged:
                out.append(Batch(requests=self._pending[:cut]))
                self._pending = self._pending[cut:]
                self._pending_t = self._pending_t[cut:]
                if aged and total < self.inflection:
                    break
            else:
                break
        return out

    def flush(self, now: float) -> List[Batch]:
        out = []
        if self._pending:
            out.append(Batch(requests=self._pending))
            self._pending = []
            self._pending_t = []
        return out


def balanced_partition(requests: Sequence[Request], d: int,
                       max_tokens_per_group: int) -> Tuple[List[List[Request]], List[Request]]:
    """Default baseline: LPT greedy on *total token counts* (the inadequate
    metric — attention is Σ s²). Returns (groups, overflow)."""
    groups: List[List[Request]] = [[] for _ in range(d)]
    loads = [0] * d
    overflow: List[Request] = []
    for r in sorted(requests, key=lambda r: -r.length):
        g = min(range(d), key=lambda i: loads[i])
        if loads[g] + r.length > max_tokens_per_group and loads[g] > 0:
            overflow.append(r)
            continue
        groups[g].append(r)
        loads[g] += r.length
    return groups, overflow


def chunk_requests(requests: Sequence[Request], chunk: int) -> List[Batch]:
    """ChunkedPrefill: split each prompt into `chunk`-token pieces (in order)."""
    out: List[Batch] = []
    for r in requests:
        start = 0
        while start < r.length:
            c = min(chunk, r.length - start)
            out.append(Batch(requests=[r], chunk_of=r, chunk_start=start,
                             chunk_len=c))
            start += c
    return out


class DecodeAdmissionQueue:
    """Ready-time-ordered admission into a width-capped decode batch: pops
    eligible requests (KV handoff landed, a slot free) in ready order.
    Single-threaded by design -- each decode engine owns one instance and
    drives it from its own admission point."""

    def __init__(self, width: int):
        assert width >= 1
        self.width = width
        self._heap: List[Tuple[float, int, object]] = []
        self._ctr = itertools.count()
        self.active = 0  # occupied decode slots; caller releases

    def push(self, t_ready: float, item):
        heapq.heappush(self._heap, (t_ready, next(self._ctr), item))

    def next_ready(self) -> Optional[float]:
        """Ready time of the head entry (None when empty)."""
        return self._heap[0][0] if self._heap else None

    def admit(self, now: float) -> List[object]:
        """Pop every entry ready by `now` that fits under the width cap,
        marking its slot occupied.  The caller calls release() per leave."""
        out: List[object] = []
        while self._heap and self._heap[0][0] <= now \
                and self.active < self.width:
            _, _, item = heapq.heappop(self._heap)
            self.active += 1
            out.append(item)
        return out

    def release(self, n: int = 1):
        """Return `n` slots after requests left the decode batch."""
        self.active = max(self.active - n, 0)

    def drain_all(self) -> List[object]:
        """Remove and return every still-pending entry (shutdown path)."""
        out = [item for _, _, item in self._heap]
        self._heap = []
        return out

    def __len__(self) -> int:
        return len(self._heap)


def pair_batches(ready: List[Batch]) -> List[Tuple[Batch, Optional[Batch]]]:
    """Dual-batch pairing (§3.3.2): co-schedule two non-exclusive batches."""
    pairs: List[Tuple[Batch, Optional[Batch]]] = []
    buf: Optional[Batch] = None
    for b in ready:
        if b.exclusive:
            pairs.append((b, None))
        elif buf is None:
            buf = b
        else:
            pairs.append((buf, b))
            buf = None
    if buf is not None:
        pairs.append((buf, None))
    return pairs
