"""The span readers (`perfbench/spantrace.py`) over a hand-made record: a
reduced trace with known busy intervals, anchors and runtime events, and
hand-made spans, every number worked out by hand below."""
import types

import pytest

from perfbench import spantrace as ST

US = 1_000  # ns
OFF = 5_000_000  # trace ns minus spans' ns


def _ev(cat, name, ts_us, dur_us, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us,
            "pid": 1, "tid": tid}


def _anchor(mid_trace_ns, side, half=1 * US, tid=1, lag=0):
    """The host's reading around a sync whose event is centred at
    `mid_trace_ns`; `lag` ns more after it (a wait for the GIL)."""
    mid = mid_trace_ns - OFF
    return {"side": side, "tid": tid, "ident": None,
            "before_ns": mid - half, "after_ns": mid + half + lag}


def _anchors(start_us=5, stop_us=1005):
    return [_anchor(start_us * US, "start"), _anchor(stop_us * US, "stop")]


def _doc(extra=()):
    # the anchors' syncs: [0, 10] us and [1000, 1010] us on thread 1;
    # kernels busy [150, 250], [400, 450], [650, 900] us
    evs = [_ev("cuda_runtime", ST.SYNC_NAME, 0.0, 10.0),
           _ev("cuda_runtime", ST.SYNC_NAME, 1000.0, 10.0),
           _ev("kernel", "k1", 150.0, 100.0, "stream 7"),
           _ev("kernel", "k2", 400.0, 50.0, "stream 7"),
           _ev("kernel", "k3", 650.0, 250.0, "stream 8")]
    return {"traceEvents": evs + list(extra)}


def _span(name, s_us, e_us, tid, **a):
    return (name, int(s_us * US) - OFF, int(e_us * US) - OFF, tid, a)


SPANS = [
    # two jobs in flight: [100, 500] us on group 10, [300, 700] on 11
    _span("executor", 100, 500, 10, bid=0, g=0),
    _span("executor", 300, 700, 11, bid=1, g=1),
    _span("attn", 100, 160, 10, bid=0, layer=0),
    _span("dispatch", 160, 200, 10, bid=0, layer=0),
    _span("moe_wait", 200, 400, 10, bid=0, layer=0),
    _span("combine", 400, 420, 10, bid=0, layer=0),
    _span("attn", 300, 350, 11, bid=1, layer=0),
    _span("moe_wait", 350, 600, 11, bid=1, layer=0),
    _span("combine", 600, 650, 11, bid=1, layer=0),
    _span("pack", 260, 280, 20, e=0),
    _span("launch", 280, 290, 20, e=0),
    _span("sync", 290, 320, 20, e=0),
    _span("combine_send", 120, 140, 21, e=1),
    _span("recv", 0, 260, 20, e=0),
]
LOG = [("attn", 0, 0, 0, (1, 8)), ("combine", 0, 0, 0),
       ("attn", 1, 0, 0, (1, 8)), ("combine", 1, 0, 0)]


def _rec(spans=SPANS, anchors=None, doc=None):
    anchors = anchors or _anchors()
    trace = ST.reduce_trace(doc or _doc(), anchors)
    return types.SimpleNamespace(trace=trace, spans=spans, log=LOG,
                                 clock_offset_ns=trace["clock_offset_ns"])


def test_the_anchors_recover_a_known_offset():
    rec = _rec()
    assert rec.trace["clock_offset_ns"] == OFF
    assert rec.trace["anchor_drift_ns"] == 0
    # an anchor read 50 us late on the host moves its offset by 50 us
    late = _rec(anchors=_anchors(stop_us=955))
    assert late.trace["anchor_drift_ns"] == 50 * US
    assert late.trace["busy_intervals"] == [
        (150 * US, 250 * US), (400 * US, 450 * US), (650 * US, 900 * US)]
    # the existing keys are tracing.reduce_trace's
    assert rec.trace["busy_s"] == pytest.approx(400e-6)


def test_several_anchors_an_end_keep_what_all_of_them_allow():
    # three syncs at each end, and the profiler's own after the last;
    # the second anchor's host waited 400 us for the GIL after its sync,
    # the fourth's 900 us: taken alone, each would move the offset by half
    ts = [0.0, 20.0, 40.0, 1000.0, 1020.0, 1040.0, 1060.0]
    doc = {"traceEvents": [_ev("cuda_runtime", ST.SYNC_NAME, t, 10.0)
                           for t in ts]}
    anchors = [_anchor((t + 5) * US, side, lag=lag)
               for t, side, lag in ((0, "start", 0), (20, "start", 400 * US),
                                    (40, "start", 0), (1000, "stop", 900 * US),
                                    (1020, "stop", 0), (1040, "stop", 0))]
    red = ST.reduce_trace(doc, anchors)
    assert abs(red["clock_offset_ns"] - OFF) <= 1
    assert red["anchor_drift_ns"] <= 1
    # alone, the slow anchor's midpoint is off by half its wait
    doc["traceEvents"] = [doc["traceEvents"][i] for i in (1, 3)]
    alone = ST.reduce_trace(doc, anchors[1:2] + anchors[3:4])
    assert alone["clock_offset_ns"] == OFF - 200 * US
    assert alone["anchor_drift_ns"] == 250 * US


@pytest.mark.parametrize("low,shown", [(0x037FE6C0, 0x037FE6C0),
                                       (0xD8FFD6C0, 0x27002940)])
def test_the_trace_names_a_thread_by_its_ident_cut_to_32_bits(low, shown):
    # a runtime event carries pthread_self()'s low 32 bits, read as a
    # signed number; the trace shows its magnitude
    ident = (0x7F7E << 32) | low
    assert shown in ST.trace_tids(5, ident)
    doc = _doc()
    for ev in doc["traceEvents"][:2]:
        ev["tid"] = shown
    anchors = [dict(a, tid=5, ident=ident) for a in _anchors()]
    red = ST.reduce_trace(doc, anchors)
    assert red["clock_offset_ns"] == OFF and red["anchor_drift_ns"] == 0


def test_device_idle_in_flight_pct():
    # in flight [100, 700]; busy inside it 100 + 50 + 50: idle 400 of 600
    assert ST.device_idle_in_flight_pct(_rec()) == pytest.approx(
        100 * 400 / 600)


def test_host_work_ms_per_batch_layer():
    # attn 60 + 50, dispatch 40, combine 20 + 50, pack 20, launch 10,
    # combine_send 20 us = 270 us over two batch-layers; waits left out
    assert ST.host_work_ms_per_batch_layer(_rec()) == pytest.approx(0.135)


def test_moe_wait_ms_per_batch_layer():
    assert ST.moe_wait_ms_per_batch_layer(_rec()) == pytest.approx(
        (0.200 + 0.250) / 2)


def test_idle_in_flight_host_work_pct():
    # idle in flight [100, 150], [250, 400], [450, 650]; work inside it
    # [100, 150], [260, 290], [300, 350], [600, 650]: 180 of 400 us
    assert ST.idle_in_flight_host_work_pct(_rec()) == pytest.approx(45.0)


def test_idle_by_phase_splits_shared_time_evenly():
    got = dict(ST.idle_by_phase(_rec()))
    # [120, 140] attn and combine_send share: 10 us each
    want = {"attn": 90e-6, "combine_send": 10e-6, "combine": 50e-6,
            "pack": 20e-6, "launch": 10e-6, ST.ALL_BLOCKED: 220e-6}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k
    assert sum(got.values()) == pytest.approx(400e-6)


READERS = [ST.device_idle_in_flight_pct, ST.host_work_ms_per_batch_layer,
           ST.moe_wait_ms_per_batch_layer, ST.idle_in_flight_host_work_pct,
           ST.idle_by_phase, ST.alignment_checks]


@pytest.mark.parametrize("case", ["no_trace", "no_spans", "empty_spans",
                                  "drift", "no_anchor_sync"])
@pytest.mark.parametrize("read", READERS, ids=lambda f: f.__name__)
def test_every_reader_reads_none_without_a_sound_clock(case, read):
    rec = _rec()
    if case == "no_trace":
        rec.trace = None
    elif case == "no_spans":
        del rec.spans  # a record of the harness as it is: no such field
    elif case == "empty_spans":
        rec.spans = []
    elif case == "drift":
        rec = _rec(anchors=_anchors(stop_us=1005 + 201))
    else:
        doc = _doc()
        doc["traceEvents"] = doc["traceEvents"][2:]
        rec = _rec(doc=doc)
    assert read(rec) is None


def test_drift_at_the_bar_still_reads():
    rec = _rec(anchors=_anchors(stop_us=1005 + 200))
    assert rec.trace["anchor_drift_ns"] == 200 * US
    assert ST.moe_wait_ms_per_batch_layer(rec) is not None


def test_alignment_checks():
    spans = SPANS + [
        _span("router_read", 160, 161, 10, bid=0, layer=0),
        _span("router_read", 350, 351, 11, bid=1, layer=0),
    ]
    extra = [
        # a copy inside the first read, on its thread; the second read's
        # copy is on another thread
        _ev("cuda_runtime", "cudaMemcpyAsync", 160.2, 0.5, 10),
        _ev("cuda_runtime", "cudaMemcpyAsync", 350.2, 0.5, 10),
        # the MoE sync holds a stream sync on thread 20
        _ev("cuda_runtime", "cudaStreamSynchronize", 291.0, 25.0, 20),
    ]
    checks = ST.alignment_checks(_rec(spans=spans, doc=_doc(extra)),
                                 tol_ns=0)
    # the profiler may name a thread by the low 32 bits of its ident
    ident = (7 << 32) | 777
    extra32 = [dict(ev, tid=777) if ev["tid"] == 10 else ev for ev in extra]
    rec32 = _rec(spans=spans, doc=_doc(extra32))
    rec32.trace["thread_idents"] = {10: ident}
    assert ST.alignment_checks(rec32, tol_ns=0) == checks
    assert checks["anchor_drift_us"] == 0
    assert checks["router_read_with_copy_or_sync"] == 0.5
    assert checks["sync_with_stream_sync"] == 1.0
    # job 0 on thread 10: attn, dispatch, moe_wait, combine cover
    # [100, 420] of [100, 500] (80 %); job 1: [300, 650] of [300, 700]
    assert checks["jobs_90pct_covered"] == 0.0
    spans.append(_span("final", 420, 500, 10, bid=0, g=0))
    checks = ST.alignment_checks(_rec(spans=spans, doc=_doc(extra)))
    assert checks["jobs_90pct_covered"] == 0.5
