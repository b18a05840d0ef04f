"""Protocol invariants of the shared-buffer async primitives (paper §3.2),
against the PyTorch port's copy; payload rows are torch tensors here."""
import threading
import time

import pytest
import torch

from repro_torch.core.async_primitives import (AbortedError, AttnDeviceBuffer,
                                               Bitmap, CombinePayload,
                                               DispatchPayload,
                                               MoEDeviceBuffer, SyncP2P)


def _payload(layer=0, slot=0):
    return DispatchPayload(layer=layer, slot=slot, counts=[1], tokens=torch.ones(1, 4),
                           token_ids=[(0, 0)], expert_ids=[0])


def test_bitmap_all_set_and_clear():
    b = Bitmap(3)
    assert not b.all_set()
    for i in range(3):
        b.set_bit(i)
    assert b.all_set()
    b.clear()
    assert not b.all_set()


def test_dispatch_send_is_nonblocking_when_clear():
    buf = MoEDeviceBuffer(D=2, T=1)
    t0 = time.monotonic()
    buf.dispatch_send(0, 0, _payload())
    assert time.monotonic() - t0 < 0.1  # no handshake: returns immediately
    assert buf.poll_ready() == 0


def test_dispatch_backpressure_blocks_until_recv():
    """Second send to the same region must block until the receiver drains."""
    buf = MoEDeviceBuffer(D=1, T=1)
    buf.dispatch_send(0, 0, _payload(layer=0))
    done = threading.Event()

    def sender():
        buf.dispatch_send(0, 0, _payload(layer=1))  # blocks on flag
        done.set()

    t = threading.Thread(target=sender, daemon=True)
    t.start()
    time.sleep(0.05)
    assert not done.is_set(), "sender must be blocked by backpressure"
    rows = buf.dispatch_recv(0)
    assert rows[0].layer == 0
    t.join(timeout=2)
    assert done.is_set(), "sender unblocks after receiver clears the flag"
    assert buf.dispatch_recv(0)[0].layer == 1


def test_recv_requires_all_tp_rows():
    buf = MoEDeviceBuffer(D=1, T=2)
    buf.dispatch_send(0, 0, _payload())
    assert buf.poll_ready() is None  # only 1 of T=2 flags set
    buf.dispatch_send(0, 1, _payload())
    assert buf.poll_ready() == 0


def test_out_of_order_regions():
    """MoE device drains whichever DP group completes first (§3.4.2)."""
    buf = MoEDeviceBuffer(D=3, T=1)
    buf.dispatch_send(2, 0, _payload(layer=7))
    assert buf.poll_ready() == 2  # group 2 ready before groups 0, 1
    rows = buf.dispatch_recv(2)
    assert rows[0].layer == 7


def test_combine_waits_for_all_segments():
    buf = AttnDeviceBuffer(E=3)
    for e in range(2):
        buf.combine_send(e, CombinePayload(0, [], [], None))
    got = []

    def recv():
        got.append(buf.combine_recv(timeout=5))

    t = threading.Thread(target=recv, daemon=True)
    t.start()
    time.sleep(0.05)
    assert not got, "combine_recv must wait for all E segments"
    buf.combine_send(2, CombinePayload(0, [], [], None))
    t.join(timeout=2)
    assert len(got) == 1 and len(got[0]) == 3


def test_wait_any_returns_ready_region_immediately():
    buf = MoEDeviceBuffer(D=3, T=1)
    buf.dispatch_send(2, 0, _payload(layer=7))
    assert buf.wait_any(timeout=1.0) == 2


def test_wait_any_blocks_until_send_completes_region():
    """Event-driven: the receiver parks on the shared condition variable and
    is woken by the completing sender — no sleep-polling."""
    buf = MoEDeviceBuffer(D=2, T=2)
    buf.dispatch_send(1, 0, _payload())  # 1 of T=2 rows: region incomplete
    got = []

    def recv():
        got.append(buf.wait_any(timeout=5.0))

    t = threading.Thread(target=recv, daemon=True)
    t.start()
    time.sleep(0.05)
    assert not got, "wait_any must block while no region is complete"
    buf.dispatch_send(1, 1, _payload())  # completes region 1 -> wakes waiter
    t.join(timeout=2)
    assert got == [1]


def test_wait_any_timeout_and_stop():
    buf = MoEDeviceBuffer(D=1, T=1)
    t0 = time.monotonic()
    assert buf.wait_any(timeout=0.05) is None  # expiry -> None
    assert time.monotonic() - t0 < 1.0
    stop = threading.Event()
    got = []

    def recv():
        got.append(buf.wait_any(timeout=30.0, stop=stop))

    t = threading.Thread(target=recv, daemon=True)
    t.start()
    time.sleep(0.02)
    stop.set()
    buf.wake()  # prompt wakeup: waiter must exit well before the timeout
    t.join(timeout=2)
    assert got == [None]


def test_dispatch_recv_reuses_preallocated_row():
    buf = MoEDeviceBuffer(D=1, T=2)
    row_before = buf.rows[0]
    buf.dispatch_send(0, 0, _payload())
    buf.dispatch_send(0, 1, _payload())
    buf.dispatch_recv(0)
    assert buf.rows[0] is row_before  # cleared in place, not reallocated
    assert buf.rows[0] == [None, None]


def test_sync_p2p_blocks_without_receiver():
    p2p = SyncP2P()
    with pytest.raises(TimeoutError):
        p2p.send("tag", b"data", timeout=0.1)  # no rendezvous partner


def test_sync_p2p_rendezvous_transfers():
    p2p = SyncP2P()
    out = []

    def receiver():
        out.append(p2p.recv(timeout=5))

    t = threading.Thread(target=receiver, daemon=True)
    t.start()
    time.sleep(0.02)
    p2p.send("tag", 123, timeout=5)
    t.join(timeout=2)
    assert out == [("tag", 123)]


def test_async_beats_sync_under_busy_receiver():
    """The paper's Fig 14 mechanism: a busy receiver stalls a sync P2P sender
    but NOT an async shared-buffer sender."""
    busy = 0.2
    # --- sync: sender waits for the receiver to come around
    p2p = SyncP2P()

    def busy_receiver():
        time.sleep(busy)
        p2p.recv(timeout=5)

    t = threading.Thread(target=busy_receiver, daemon=True)
    t.start()
    t0 = time.monotonic()
    p2p.send("x", b"payload", timeout=5)
    sync_latency = time.monotonic() - t0
    t.join()
    # --- async: write + set flag, return immediately
    buf = MoEDeviceBuffer(D=1, T=1)
    t0 = time.monotonic()
    buf.dispatch_send(0, 0, _payload())
    async_latency = time.monotonic() - t0
    assert sync_latency >= busy * 0.9
    assert async_latency < busy / 4


# ------------------------------------------------------------- recv_many


def test_recv_many_takes_all_complete_regions_atomically():
    """one call drains EVERY complete region under one cv
    acquisition, in region order, and clears their flags (backpressure
    released for all of them)."""
    buf = MoEDeviceBuffer(D=3, T=1)
    buf.dispatch_send(2, 0, _payload(layer=7))
    buf.dispatch_send(0, 0, _payload(layer=3))
    taken = buf.recv_many(timeout=1.0)
    assert [i for i, _ in taken] == [0, 2]
    assert taken[0][1][0].layer == 3 and taken[1][1][0].layer == 7
    # flags cleared: senders can refill both regions without backpressure
    buf.dispatch_send(0, 0, _payload())
    buf.dispatch_send(2, 0, _payload())


def test_recv_many_respects_max_regions():
    buf = MoEDeviceBuffer(D=3, T=1)
    for i in range(3):
        buf.dispatch_send(i, 0, _payload(layer=i))
    first = buf.recv_many(max_regions=2, timeout=1.0)
    assert [i for i, _ in first] == [0, 1]
    rest = buf.recv_many(timeout=1.0)
    assert [i for i, _ in rest] == [2]


def test_recv_many_skips_incomplete_regions():
    buf = MoEDeviceBuffer(D=2, T=2)
    buf.dispatch_send(0, 0, _payload())
    buf.dispatch_send(0, 1, _payload())
    buf.dispatch_send(1, 0, _payload())  # 1 of T=2 rows: incomplete
    taken = buf.recv_many(timeout=0.1)
    assert [i for i, _ in taken] == [0]


def test_recv_many_blocks_until_first_completion():
    buf = MoEDeviceBuffer(D=2, T=2)
    buf.dispatch_send(1, 0, _payload())
    got = []

    def recv():
        got.append(buf.recv_many(timeout=5.0))

    t = threading.Thread(target=recv, daemon=True)
    t.start()
    time.sleep(0.05)
    assert not got, "recv_many must block while no region is complete"
    buf.dispatch_send(1, 1, _payload())  # completes region 1 -> wakes waiter
    t.join(timeout=2)
    assert [i for i, _ in got[0]] == [1]


def test_recv_many_timeout_stop_and_fence():
    buf = MoEDeviceBuffer(D=1, T=1)
    t0 = time.monotonic()
    assert buf.recv_many(timeout=0.05) is None
    assert time.monotonic() - t0 < 1.0
    stop = threading.Event()
    stop.set()
    assert buf.recv_many(timeout=5.0, stop=stop) is None
    # admission fence: evaluated under the cv BEFORE any take — a fenced-out
    # worker must not drain even a ready region
    buf.dispatch_send(0, 0, _payload())
    assert buf.recv_many(timeout=1.0, admit=lambda: False) is None
    assert buf.poll_ready() == 0  # region untouched, supervisor will own it


def test_recv_many_on_take_publishes_before_flag_clear():
    """The exactly-once publication contract: on_take(i, rows) runs with the
    region's rows already migrated but its flags STILL SET, so there is no
    observable taken-but-unpublished window."""
    buf = MoEDeviceBuffer(D=2, T=1)
    buf.dispatch_send(0, 0, _payload(layer=1))
    buf.dispatch_send(1, 0, _payload(layer=2))
    seen = []

    def on_take(i, rows):
        seen.append((i, rows[0].layer, buf.flags[i].all_set()))

    taken = buf.recv_many(timeout=1.0, on_take=on_take)
    assert [i for i, _ in taken] == [0, 1]
    assert seen == [(0, 1, True), (1, 2, True)]


# ------------------------------------------------- recv_any / stop / payloads


def test_recv_any_takes_one_region_atomically_with_on_take():
    buf = MoEDeviceBuffer(D=2, T=1)
    buf.dispatch_send(1, 0, _payload(layer=5))
    seen = []
    got = buf.recv_any(timeout=1.0, on_take=lambda i, rows: seen.append(
        (i, rows[0].layer, buf.flags[i].all_set())))
    assert got[0] == 1 and got[1][0].layer == 5
    assert seen == [(1, 5, True)]  # published before the flags cleared
    assert not buf.any_pending()
    assert buf.recv_any(timeout=0.05) is None  # nothing left: timeout
    assert buf.recv_any(timeout=1.0, admit=lambda: False) is None


def test_recv_any_returns_none_on_stop_and_waits_raise_aborted():
    buf = MoEDeviceBuffer(D=1, T=1)
    stop = threading.Event()
    stop.set()
    assert buf.recv_any(timeout=5.0, stop=stop) is None
    buf.dispatch_send(0, 0, _payload())
    with pytest.raises(AbortedError):  # backpressure wait observes stop
        buf.dispatch_send(0, 0, _payload(), stop=stop)
    abuf = AttnDeviceBuffer(E=2)
    with pytest.raises(AbortedError):
        abuf.combine_recv(timeout=5.0, stop=stop)


def test_payloads_carry_tensors_and_ready_event_slot():
    p = _payload()
    assert isinstance(p.tokens, torch.Tensor) and p.ready is None
    c = CombinePayload(layer=0, token_ids=[], expert_ids=[],
                       outputs=torch.zeros(0, 4))
    assert c.ready is None and c.outputs.shape == (0, 4)
    buf = AttnDeviceBuffer(E=1)
    buf.combine_send(0, c)
    assert buf.has_segment(0)
    assert buf.combine_recv(timeout=1.0)[0] is c
    assert not buf.has_segment(0)
