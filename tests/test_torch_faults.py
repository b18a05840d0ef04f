"""Fault injection and the request lifecycle in the port (CPU, kernels' plain
versions), after tests/test_faults.py and tests/test_executor_faults.py:
`repro_torch.core.faults` held against `repro.core.faults` on the same
inputs; the `ExecutorEngine` under a crash (supervised and not), overload
shedding, deadlines, hedging and a drain through a crash storm, each request
ending in exactly one definite status; and serve's fault flags."""
import json
import time

import numpy as np
import pytest

from _torch_port import smoke_setup
from repro.core import faults as ref_faults
from repro_torch.core import faults
from repro_torch.core.engine import ExecutorEngine
from repro_torch.core.executor import DisaggregatedExecutor
from repro_torch.core.faults import FaultEvent, FaultPlan, InjectedFault
from repro_torch.core.scheduler import LengthAwareBatcher
from repro_torch.core.trace import Request, TraceClock
from repro_torch.launch import serve

TERMINAL = {"ok", "timeout", "shed", "failed"}
TIMEOUT = 60.0  # drain bound: a hang fails the test, not the suite


# ---------------------------------------------------------------------------
# the module, against the reference's
# ---------------------------------------------------------------------------


def _both(fn):
    """fn(module) on the port's module and on the reference's."""
    return fn(faults), fn(ref_faults)


def test_fault_kinds_equal():
    assert faults.FAULT_KINDS == ref_faults.FAULT_KINDS == (
        "crash_moe", "stall_moe", "drop_dispatch", "drop_combine",
        "delay_wake")


@pytest.mark.parametrize("kw", [
    dict(t=1.0, kind="meteor_strike", device=0),
    dict(t=-1.0, kind="crash_moe", device=0),
    dict(t=1.0, kind="stall_moe", device=0, duration=-0.5)])
def test_event_validation_matches(kw):
    for mod in (faults, ref_faults):
        with pytest.raises(ValueError):
            mod.FaultEvent(**kw)


def test_plan_sorts_and_round_trips_like_the_reference():
    events = [dict(t=5.0, kind="crash_moe", device=0),
              dict(t=1.0, kind="delay_wake", device=1, duration=0.5),
              dict(t=3.0, kind="drop_combine", device=2)]
    port, ref = _both(lambda m: m.FaultPlan(
        events=[m.FaultEvent(**e) for e in events], seed=7))
    assert [ev.t for ev in port.events] == [1.0, 3.0, 5.0]
    assert port.to_dict() == ref.to_dict()
    # a plan written by one package loads in the other
    assert ref_faults.FaultPlan.from_dict(port.to_dict()) == ref
    assert FaultPlan.from_dict(ref.to_dict()) == port
    assert FaultEvent.from_dict(port.events[0].to_dict()) == port.events[0]


def test_from_flags_and_validate_match():
    for mod in (faults, ref_faults):
        assert mod.FaultPlan.from_flags(8.0, 5.0, None) is None
        with pytest.raises(ValueError):
            mod.FaultPlan.from_flags(None, 5.0, 0)
        plan = mod.FaultPlan(events=[mod.FaultEvent(t=1.0, kind="crash_moe",
                                                    device=4)])
        with pytest.raises(ValueError):
            plan.validate(4)
        assert plan.validate(5) is plan
    port, ref = _both(lambda m: m.FaultPlan.from_flags(8.0, 5.0, 2))
    assert port.to_dict() == ref.to_dict()
    assert port.events == (FaultEvent(t=8.0, kind="crash_moe", device=2,
                                      duration=5.0),)


def _replay(mod, queries):
    """The same seam queries, under a fake clock, on one module's
    injector: (answers, fired kinds, pending count)."""
    plan = mod.FaultPlan(events=[
        mod.FaultEvent(t=1.0, kind="crash_moe", device=0),
        mod.FaultEvent(t=1.0, kind="drop_dispatch", device=1),
        mod.FaultEvent(t=1.0, kind="drop_combine", device=1),
        mod.FaultEvent(t=2.0, kind="stall_moe", device=1, duration=3.0),
        mod.FaultEvent(t=0.0, kind="delay_wake", device=0, duration=1.0)])
    inj = mod.FaultInjector(plan, num_moe_devices=2)
    now = [0.5]
    inj.arm(lambda: now[0], t0=0.5)
    out = []
    for t, seam, dev in queries:
        now[0] = t
        r = getattr(inj, seam)(dev)
        out.append(r.to_dict() if hasattr(r, "to_dict") else r)
    return (out, [ev.kind for ev in inj.fired_events()],
            len(inj.pending_events()))


def test_injector_exactly_once_and_device_scoped_like_the_reference():
    queries = [(0.5, "poll_worker", 1), (0.5, "poll_worker", 0),
               (0.5, "poll_worker", 0), (1.0, "should_drop_dispatch", 1),
               (1.5, "should_drop_dispatch", 0),
               (1.5, "should_drop_dispatch", 1),
               (1.5, "should_drop_dispatch", 1), (1.5, "poll_worker", 1),
               (1.5, "poll_worker", 0), (1.5, "poll_worker", 0),
               (1.5, "should_drop_combine", 0),
               (1.5, "should_drop_combine", 1),
               (1.5, "should_drop_combine", 1), (3.0, "poll_worker", 1),
               (3.0, "poll_worker", 1)]
    port, ref = _both(lambda m: _replay(m, queries))
    assert port == ref
    answers, fired, pending = port
    assert fired == ["delay_wake", "drop_dispatch", "crash_moe",
                     "drop_combine", "stall_moe"]
    assert pending == 0 and sum(1 for a in answers if a) == 5


# ---------------------------------------------------------------------------
# the engine's request lifecycle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    _, _, cfg, params = smoke_setup(num_layers=2, num_experts=8, top_k=2)
    return cfg, params


def _engine(model, batcher=None, ex_kw=None, **kw):
    cfg, params = model
    ex = DisaggregatedExecutor(params, cfg, D=2, E=4, device="cpu",
                               **(ex_kw or {}))
    return ExecutorEngine(
        ex, clock=TraceClock(speed=50.0),
        batcher=batcher or LengthAwareBatcher(
            inflection=48, max_tokens=128, exclusive_cutoff=1 << 30,
            max_wait=0.05), **kw)


def _trace(n=6, seed=0, spacing=0.1):
    rng = np.random.RandomState(seed)
    return [Request(rid=i, arrival=i * spacing,
                    length=int(rng.choice([8, 16, 24, 32])))
            for i in range(n)]


def _definite(results, reqs):
    """One terminal result per submitted request: nothing lost, nothing
    duplicated, every status definite."""
    assert sorted(r.rid for r in results) == sorted(r.rid for r in reqs)
    assert all(r.status in TERMINAL for r in results)


def test_engine_crash_failover_serves_every_request(model):
    eng = _engine(model, fault_plan=FaultPlan(
        [FaultEvent(t=0.5, kind="crash_moe", device=1)]))
    reqs = _trace(8)
    eng.submit_all(reqs)
    results = eng.drain(timeout=TIMEOUT)
    # close() joins the supervisor, whose failover counts only after its
    # evacuation swap: stats read before it race that swap
    eng.close()
    st = eng.stats()
    _definite(results, reqs)
    assert all(r.status == "ok" for r in results), \
        [(r.rid, r.status) for r in results]
    assert st.failovers == eng.ex.failovers == 1
    assert 1 in eng.ex.placement.dead
    assert st.migrations == 1 and st.migrated_bytes > 0
    assert sum(st.statuses.values()) == len(reqs)


def test_unsupervised_crash_fails_definitely(model):
    """supervise=False: the crash panics the executor, but drain() still
    ends every request with a definite status, a restart raises with the
    ORIGINAL cause, and close() does not mask it."""
    eng = _engine(model, ex_kw=dict(supervise=False), fault_plan=FaultPlan(
        [FaultEvent(t=0.2, kind="crash_moe", device=1)]))
    reqs = _trace(8)
    eng.submit_all(reqs)
    results = eng.drain(timeout=TIMEOUT)
    _definite(results, reqs)
    assert any(r.status == "failed" for r in results)
    assert eng.ex.failovers == 0
    with pytest.raises(RuntimeError) as ei:
        eng.ex.ensure_started()
    assert isinstance(ei.value.__cause__, InjectedFault)
    eng.close()


def test_close_during_in_flight_crash(model):
    """close() racing an injected crash terminates cleanly: buffer waits
    released, survivors joined, no hang."""
    eng = _engine(model, ex_kw=dict(supervise=False), fault_plan=FaultPlan(
        [FaultEvent(t=0.2, kind="crash_moe", device=0)]))
    eng.submit_all(_trace(6))
    time.sleep(0.1)  # let the crash land while work is in flight
    t0 = time.monotonic()
    eng.close()
    assert time.monotonic() - t0 < TIMEOUT
    assert not any(t.is_alive() for t in eng.ex._hung)


def test_overload_sheds_at_admission(model):
    batcher = LengthAwareBatcher(inflection=1 << 30, max_tokens=1 << 30,
                                 exclusive_cutoff=1 << 30, max_wait=1e9)
    eng = _engine(model, batcher=batcher, max_queue=2)
    reqs = [Request(rid=i, arrival=0.0, length=8) for i in range(6)]
    eng.submit_all(reqs)
    results = eng.drain(timeout=TIMEOUT)
    eng.close()
    _definite(results, reqs)
    assert sum(r.status == "shed" for r in results) == 4
    assert sum(r.status == "ok" for r in results) == 2
    assert all(r.retries == 0 for r in results)


def test_request_deadline_yields_timeout(model):
    eng = _engine(model, request_deadline=1e-6)
    reqs = _trace(6)
    eng.submit_all(reqs)
    results = eng.drain(timeout=TIMEOUT)
    eng.close()
    _definite(results, reqs)
    assert all(r.status in ("ok", "timeout") for r in results)
    assert any(r.status == "timeout" for r in results)


def test_hedged_redispatch_is_idempotent(model):
    """An aggressive hedge_factor clones overdue batches while device 0
    wakes late, yet completions dedup: exactly one result per request."""
    eng = _engine(model, hedge_factor=0.05, fault_plan=FaultPlan(
        [FaultEvent(t=0.3, kind="delay_wake", device=0, duration=2.0)]))
    reqs = _trace(8, spacing=0.05)
    eng.submit_all(reqs)
    results = eng.drain(timeout=TIMEOUT)
    st = eng.stats()
    eng.close()
    _definite(results, reqs)
    assert all(r.status == "ok" for r in results)
    assert st.hedges_issued >= 1 and 0 <= st.hedge_wins <= st.hedges_issued
    assert st.completed == len(reqs) and st.failovers == 0


def test_drain_through_a_crash_storm_ends_definitely(model):
    eng = _engine(model, ex_kw=dict(region_timeout=2.0),
                  fault_plan=FaultPlan([
                      FaultEvent(t=0.3, kind="crash_moe", device=1),
                      FaultEvent(t=0.6, kind="drop_combine", device=0)]))
    reqs = _trace(10, spacing=0.05)
    eng.submit_all(reqs)
    results = eng.drain(timeout=TIMEOUT)
    st = eng.stats()
    eng.close()
    _definite(results, reqs)
    assert sum(st.statuses.values()) == len(reqs)


# ---------------------------------------------------------------------------
# serve's fault flags
# ---------------------------------------------------------------------------


def test_serve_crash_serves_every_request_with_one_failover(tmp_path,
                                                            capsys):
    stats = tmp_path / "stats.json"
    rc = serve.main(["--smoke", "--device", "cpu", "--fail-moe-device", "1",
                     "--failure-at", "0.5", "--save-stats", str(stats)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "fault plan armed" in out and "supervised failover: 1" in out
    saved = json.loads(stats.read_text())
    assert saved["statuses"] == {"ok": 8} and saved["failovers"] == 1
    assert saved["dead_devices"] == [1]


def test_serve_every_fault_flag_parses(tmp_path):
    stats = tmp_path / "stats.json"
    rc = serve.main(["--smoke", "--device", "cpu", "--requests", "4",
                     "--time-scale", "50", "--fail-moe-device", "0",
                     "--failure-at", "1000", "--failure-duration", "2",
                     "--request-deadline", "1000", "--max-queue", "64",
                     "--hedge-factor", "100", "--save-stats", str(stats)])
    assert rc == 0
    saved = json.loads(stats.read_text())
    assert saved["statuses"] == {"ok": 4} and saved["failovers"] == 0


@pytest.mark.parametrize("argv,needle", [
    (["--fail-moe-device", "9", "--failure-at", "0.5"], "MoE device 9"),
    (["--fail-moe-device", "1"], "requires --failure-at"),
    (["--failure-at", "0.5"], "--fail-moe-device"),
    (["--max-queue", "0"], "--max-queue"),
    (["--hedge-factor", "-1"], "--hedge-factor"),
    (["--mode", "pd", "--request-deadline", "1"], "--mode pd")])
def test_serve_rejects_bad_fault_flags(argv, needle, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--smoke", "--device", "cpu"] + argv)
    assert e.value.code == 2
    assert needle in capsys.readouterr().err
