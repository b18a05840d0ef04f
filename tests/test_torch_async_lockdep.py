"""The port's buffer protocol (`repro_torch.core.async_primitives`) under the
port's runtime lockdep sanitizer (`repro_torch.analysis.lockdep`), after
tests/test_async_lockdep.py at smaller sizes: multi-sender /
multi-receiver dispatch, the combine round trip, backpressure and wake on
stop, with every repo-created lock instrumented -- no order inversion, no
held-lock wait, no lost or duplicated payload.  Every wait is bounded, so a
hang fails the test well inside the suite's clock."""
import threading
import time

import pytest
import torch

from repro_torch.analysis import lockdep
from repro_torch.core.async_primitives import (AttnDeviceBuffer,
                                               CombinePayload,
                                               DispatchPayload,
                                               MoEDeviceBuffer)

SEED = 20260806
JOIN = 30.0  # seconds a thread may take to finish before the test fails


def _payload(dp_i, tp_j, gen, layer=0, slot=0):
    return DispatchPayload(layer=layer, slot=slot,
                           counts=torch.tensor([2]),
                           tokens=torch.randn((2, 4), generator=gen),
                           token_ids=torch.tensor([dp_i, tp_j]),
                           expert_ids=torch.zeros(2, dtype=torch.long))


def _run(threads):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN)
    assert not any(t.is_alive() for t in threads), "a thread hung"


def test_moe_buffer_stress_multi_sender_multi_receiver():
    """D*T senders fan into E MoE buffers; E receiver threads drain regions
    out of order.  Every (round, dp, tp) payload arrives exactly once at
    every device, and lockdep stays silent."""
    D, T, E, ROUNDS = 2, 3, 2, 12
    lockdep.reset()
    with lockdep.lockdep_active(raise_on_violation=True):
        bufs = [MoEDeviceBuffer(D, T) for _ in range(E)]
        stop = threading.Event()
        got = [[] for _ in range(E)]  # receiver-private, no lock needed
        errors = []

        def sender(dp_i, tp_j):
            gen = torch.Generator().manual_seed(SEED + dp_i * 100 + tp_j)
            try:
                for r in range(ROUNDS):
                    for e in range(E):
                        bufs[e].dispatch_send(
                            dp_i, tp_j, _payload(dp_i, tp_j, gen, layer=r),
                            timeout=JOIN, stop=stop)
            except BaseException as ex:
                errors.append(ex)
                stop.set()

        def receiver(e):
            try:
                while len(got[e]) < D * ROUNDS:
                    i = bufs[e].wait_any(timeout=JOIN, stop=stop)
                    if i is None:
                        if stop.is_set():
                            return
                        raise TimeoutError(f"receiver {e} starved")
                    rows = bufs[e].dispatch_recv(i)
                    assert len(rows) == T
                    assert all(r is not None for r in rows)
                    got[e].append((i, [r.layer for r in rows]))
            except BaseException as ex:
                errors.append(ex)
                stop.set()

        _run([threading.Thread(target=sender, args=(i, j))
              for i in range(D) for j in range(T)]
             + [threading.Thread(target=receiver, args=(e,))
                for e in range(E)])
        assert errors == [], errors
        for e in range(E):
            # every device saw every region ROUNDS times, each drained
            # region round-coherent (backpressure serializes a sender's
            # rounds per region)
            assert len(got[e]) == D * ROUNDS
            per_region = [0] * D
            for i, layers in got[e]:
                per_region[i] += 1
                assert len(set(layers)) == 1, layers
            assert per_region == [ROUNDS] * D
        assert lockdep.violations() == []
    lockdep.reset()


def test_combine_stress_and_roundtrip():
    """E MoE senders combine into per-group attention buffers while the
    receivers run combine_recv concurrently: the dispatch/combine round
    trip's second half, instrumented."""
    E, GROUPS, ROUNDS = 3, 2, 8
    lockdep.reset()
    with lockdep.lockdep_active(raise_on_violation=True):
        bufs = [AttnDeviceBuffer(E) for _ in range(GROUPS)]
        errors = []

        def sender(e):
            gen = torch.Generator().manual_seed(SEED + e)
            try:
                for r in range(ROUNDS):
                    for g in range(GROUPS):
                        bufs[g].combine_send(e, CombinePayload(
                            layer=r, token_ids=torch.arange(2),
                            expert_ids=torch.full((2,), e),
                            outputs=torch.randn((2, 4), generator=gen)),
                            timeout=JOIN)
            except BaseException as ex:
                errors.append(ex)

        def receiver(g):
            try:
                for r in range(ROUNDS):
                    segs = bufs[g].combine_recv(timeout=JOIN)
                    assert len(segs) == E
                    assert sorted(int(s.expert_ids[0]) for s in segs) \
                        == list(range(E))
                    assert {s.layer for s in segs} == {r}
            except BaseException as ex:
                errors.append(ex)

        _run([threading.Thread(target=sender, args=(e,)) for e in range(E)]
             + [threading.Thread(target=receiver, args=(g,))
                for g in range(GROUPS)])
        assert errors == [], errors
        assert lockdep.violations() == []
    lockdep.reset()


def test_backpressure_timeout_under_lockdep():
    """An undrained region stalls the sender (bounded by its timeout) --
    the protocol's one blocking point -- and the stall is no lockdep
    violation (it holds no other lock while waiting)."""
    gen = torch.Generator().manual_seed(SEED)
    lockdep.reset()
    with lockdep.lockdep_active(raise_on_violation=True):
        buf = MoEDeviceBuffer(D=1, T=1)
        buf.dispatch_send(0, 0, _payload(0, 0, gen), timeout=JOIN)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            buf.dispatch_send(0, 0, _payload(0, 0, gen), timeout=0.2)
        assert time.monotonic() - t0 >= 0.15
        # the drain acknowledges; the sender may proceed again
        assert buf.wait_any(timeout=1.0) == 0
        rows = buf.dispatch_recv(0)
        assert len(rows) == 1
        buf.dispatch_send(0, 0, _payload(0, 0, gen), timeout=1.0)
        assert lockdep.violations() == []
    lockdep.reset()


def test_wake_on_stop_under_lockdep():
    """wait_any parked with no traffic exits promptly on stop + wake -- the
    executor's shutdown path -- with the sanitizer installed."""
    lockdep.reset()
    with lockdep.lockdep_active(raise_on_violation=True):
        buf = MoEDeviceBuffer(D=2, T=2)
        stop = threading.Event()
        out = {}

        def rx():
            out["r"] = buf.wait_any(timeout=JOIN, stop=stop)

        t = threading.Thread(target=rx)
        t.start()
        time.sleep(0.1)
        stop.set()
        buf.wake()
        t.join(timeout=5)
        assert not t.is_alive()
        assert out["r"] is None
        assert lockdep.violations() == []
        # the sanitizer did instrument the buffer's condition, at its site
        assert any(s.startswith("src/repro_torch/core/async_primitives.py:")
                   for s in lockdep.instrumented_sites())
    lockdep.reset()
