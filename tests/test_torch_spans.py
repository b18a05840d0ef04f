"""The port's span recorder (`core/spans.py`) on the CPU: off, it reads no
clock and records nothing; on, an `ExecutorEngine` over a D = 2, E = 2
executor leaves one span of each group step per batch-layer inside its
job's "executor" span, request spans that its children tile, a queue share
equal to the engine's, and MoE spans naming the log's regions."""
import collections
import json
import sys
import threading
import time

import numpy as np
import pytest

from _torch_port import smoke_setup
from repro_torch.core import spans as spans_mod
from repro_torch.core.engine import ExecutorEngine
from repro_torch.core.executor import DisaggregatedExecutor
from repro_torch.core.scheduler import LengthAwareBatcher
from repro_torch.core.spans import SPANS, Recorder, chrome_trace, clock_ns
from repro_torch.core.trace import Request, TraceClock
from repro_torch.launch import serve

GROUP_STEPS = ("attn", "router_read", "dispatch", "moe_wait", "combine")
MOE_SPANS = ("pack", "launch", "unpack", "sync", "combine_send")
MS = 1_000_000  # ns


def _requests():
    rng = np.random.RandomState(5)
    # pairs close enough to share a batch, and gaps that leave one alone
    arrivals = [0.0, 0.01, 0.15, 0.3, 0.31, 0.5]
    return [Request(rid=i, arrival=a, length=int(rng.choice([8, 16, 24])))
            for i, a in enumerate(arrivals)]


def _serve(cfg, params, reqs):
    ex = DisaggregatedExecutor(params, cfg, D=2, E=2, device="cpu")
    eng = ExecutorEngine(
        ex, clock=TraceClock(speed=1.0),
        batcher=LengthAwareBatcher(inflection=48, max_tokens=128,
                                   exclusive_cutoff=1 << 30, max_wait=0.05))
    eng.submit_all(reqs)
    results = eng.drain(timeout=120)
    eng.close()
    with ex._log_lock:
        log = list(ex.log)
    return results, log


@pytest.fixture(scope="module")
def setup():
    return smoke_setup(num_experts=8)


@pytest.fixture(scope="module")
def served(setup):
    _, _, cfg, params = setup
    reqs = _requests()
    SPANS.start()
    try:
        results, log = _serve(cfg, params, reqs)
    finally:
        SPANS.stop()
    spans = SPANS.take()
    assert sorted(r.rid for r in results) == [r.rid for r in reqs]
    assert all(r.ok for r in results)
    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s[0]].append(s)
    return results, log, spans, by_name


def test_off_records_nothing_and_reads_no_clock(setup, monkeypatch):
    _, _, cfg, params = setup
    SPANS.stop()
    SPANS.take()
    callers = []
    real = time.monotonic_ns

    def counted():
        mod = sys._getframe(1).f_globals.get("__name__", "")
        if mod.startswith("repro_torch"):
            callers.append(mod)
        return real()

    monkeypatch.setattr(time, "monotonic_ns", counted)
    results, log = _serve(cfg, params, _requests()[:3])
    assert len(results) == 3 and any(ev[0] == "combine" for ev in log)
    assert callers == []
    assert SPANS.take() == []


def test_each_batch_layer_has_one_of_each_group_step_in_its_job(served):
    _, log, _, by_name = served
    execs = {s[4]["bid"]: s for s in by_name["executor"]}
    per = collections.Counter()
    for name in GROUP_STEPS:
        for _, start, end, tid, a in by_name[name]:
            per[(name, a["bid"], a["layer"])] += 1
            ex = execs[a["bid"]]
            assert tid == ex[3] and a["g"] == ex[4]["g"]
            assert ex[1] <= start <= end <= ex[2], (name, a)
    layers = {(k[1], k[2]) for k in per}
    assert len(layers) == sum(1 for ev in log if ev[0] == "combine")
    assert all(per[(name, b, layer)] == 1 for name in GROUP_STEPS
               for b, layer in layers)
    # one "final" per job, inside it
    finals = {s[4]["bid"]: s for s in by_name["final"]}
    assert finals.keys() == execs.keys()
    for b, f in finals.items():
        assert execs[b][1] <= f[1] <= f[2] <= execs[b][2] + 1000


def test_request_children_tile_the_request(served):
    results, _, _, by_name = served
    execs = {s[4]["bid"]: s for s in by_name["executor"]}
    waits = {s[4]["bid"]: s for s in by_name["admission_wait"]}
    holds = {s[4]["rid"]: s for s in by_name["batcher_hold"]}
    reqs = {s[4]["rid"]: s for s in by_name["request"]}
    assert sorted(reqs) == sorted(r.rid for r in results)
    for rid, (_, start, end, tid, a) in reqs.items():
        hold, wait, ex = holds[rid], waits[a["bid"]], execs[a["bid"]]
        assert hold[3] == wait[3] == tid != ex[3]  # the admission thread
        assert abs(hold[1] - start) <= MS
        assert abs(wait[1] - hold[2]) <= MS
        assert abs(ex[1] - wait[2]) <= MS
        assert abs(ex[2] - end) <= MS
    assert {s[4]["bid"] for s in by_name["first_token"]} == set(execs)


def test_batcher_hold_and_admission_wait_sum_to_the_queue_share(served):
    results, _, _, by_name = served
    waits = {s[4]["bid"]: s for s in by_name["admission_wait"]}
    holds = {s[4]["rid"]: s for s in by_name["batcher_hold"]}
    for r in results:
        hold, wait = holds[r.rid], waits[r.batch_id]
        queue_ns = (hold[2] - hold[1]) + (wait[2] - wait[1])
        assert abs(queue_ns - r.decomposition["queue"] * 1e9) <= MS


def _moe_regions_of_the_log(log, by_name, L):
    """(e, bid, layer, g) of each "moe" event: a (group, slot)'s jobs in the
    order their attention started, each visiting every device once a
    layer, so device e's events of a slot come in blocks of L."""
    firsts = {}
    for _, start, _, _, a in by_name["attn"]:
        key = (a["g"], a["slot"], a["bid"])
        firsts[key] = min(firsts.get(key, start), start)
    bids = collections.defaultdict(list)
    for (g, slot, bid), start in sorted(firsts.items(), key=lambda kv: kv[1]):
        bids[(g, slot)].append(bid)
    seen = collections.Counter()
    out = []
    for ev in log:
        if ev[0] != "moe":
            continue
        _, e, g, slot, layer, _ = ev
        k = seen[(e, g, slot)]
        seen[(e, g, slot)] += 1
        assert k % L == layer
        out.append((e, bids[(g, slot)][k // L], layer, g))
    return out


def test_moe_spans_name_the_regions_of_the_log(served, setup):
    _, log, _, by_name = served
    L = setup[2].num_layers
    want = _moe_regions_of_the_log(log, by_name, L)
    sent = [(a["e"],) + tuple(r) for s in by_name["combine_send"]
            for a in [s[4]] for r in a["regions"]]
    assert collections.Counter(sent) == collections.Counter(want)
    pairs = {(b, layer) for _, b, layer, _ in want}
    for name in MOE_SPANS:
        named = {(r[0], r[1]) for s in by_name[name] for r in s[4]["regions"]}
        assert named <= pairs, name
        assert named, name
    launched = {(r[0], r[1]) for s in by_name["launch"]
                for r in s[4]["regions"]}
    assert launched == pairs  # every batch-layer routed rows to a device
    assert all(s[4]["rows"] > 0 and s[4]["C"] >= 1 for s in by_name["launch"])
    assert by_name["recv"] and all("e" in s[4] for s in by_name["recv"])


def test_clock_ns_reads_trace_time_on_the_monotonic_clock():
    clock = TraceClock(speed=4.0).start()
    before = time.monotonic_ns()
    t = clock.now()
    after = time.monotonic_ns()
    assert before - 1000 <= clock_ns(clock.now, t) <= after + 1000
    assert clock_ns(clock.now, t + 4.0) - clock_ns(clock.now, t) \
        == pytest.approx(1e9, abs=1e3)
    assert clock_ns(time.monotonic, 2.5) == 2_500_000_000


def test_take_gathers_every_thread_and_keeps_later_appends():
    rec = Recorder()
    rec.start()

    def work(i):
        for j in range(3):
            rec.add("x", j, j + 1, i=i)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    rec.add("y", 10, 11)
    got = rec.take()
    assert len(got) == 13
    assert len({s[3] for s in got if s[0] == "x"}) == 4
    assert got[-1][0] == "y" and got[-1][3] == threading.get_native_id()
    rec.add("z", 1, 2)
    assert [s[0] for s in rec.take()] == ["z"]
    assert rec.take() == []
    rec.stop()


def test_serve_save_spans_writes_one_chrome_event_per_span(tmp_path,
                                                           monkeypatch):
    taken = []

    def spy(spans):
        taken.append(list(spans))
        return chrome_trace(spans)

    monkeypatch.setattr(spans_mod, "chrome_trace", spy)
    path = tmp_path / "spans.json"
    rc = serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                     "--time-scale", "50", "--save-spans", str(path)])
    assert rc == 0 and not SPANS.on
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    assert len(taken) == 1 and len(events) == len(taken[0]) > 0
    assert {ev["ph"] for ev in events} == {"X"}
    names = {ev["name"] for ev in events}
    assert {"request", "executor", "attn", "moe_wait", "launch"} <= names
    for ev, s in zip(events, taken[0]):
        assert ev["tid"] == s[3] and ev["ts"] == s[1] / 1e3
        assert ev["dur"] == (s[2] - s[1]) / 1e3 >= 0


def test_save_spans_is_refused_where_no_executor_engine_serves():
    for extra in (["--engine", "sim"], ["--mode", "pd"]):
        with pytest.raises(SystemExit) as e:
            serve.main(["--save-spans", "x.json"] + extra)
        assert e.value.code == 2
