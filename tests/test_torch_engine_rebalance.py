"""The executor engine's placement control plane on the port's CPU executor
(kernels' plain versions), after the reference's
tests/test_placement_control.py::test_executor_live_swap_parity_mid_run and
tests/test_executor_faults.py::test_sim_executor_failover_placement_parity:
a live migration mid-run that loses or duplicates no request and ends on
the table the reference's `ExpertLoadModel` gives; the same FaultPlan
giving one table in the port's executor, the port's simulator and the
reference's simulator; a crash that lands during a rebalance tick, in both
orders of the two swaps; and serve's placement-control and simulator
flags."""
import json
import time

import numpy as np
import pytest

from _torch_port import smoke_setup
from repro.configs import get_config as jax_get_config
from repro.core.cost_model import Deployment as RefDeployment
from repro.core.cost_model import ExpertLoadModel as RefExpertLoadModel
from repro.core.cost_model import Placement as RefPlacement
from repro.core.faults import FaultEvent as RefFaultEvent
from repro.core.faults import FaultPlan as RefFaultPlan
from repro.core.simulator import AsapSim as RefAsapSim
from repro.core.simulator import SimConfig as RefSimConfig
from repro_torch.configs import get_config
from repro_torch.core import executor as executor_mod
from repro_torch.core.cost_model import Deployment, ExpertLoadModel, Placement
from repro_torch.core.engine import ExecutorEngine, RouterStatsCollector
from repro_torch.core.executor import DisaggregatedExecutor
from repro_torch.core.faults import FaultEvent, FaultPlan
from repro_torch.core.scheduler import LengthAwareBatcher
from repro_torch.core.simulator import AsapSim, SimConfig
from repro_torch.core.trace import Request, TraceClock
from repro_torch.launch import serve

D, E = 2, 4
TIMEOUT = 60.0  # a hang fails the test, well inside the suite's clock


@pytest.fixture(scope="module")
def model():
    """The reference scenario's model: qwen3 smoke, 3 layers, 8 experts
    top-2 (port cfg, port params on the CPU)."""
    _, _, cfg, params = smoke_setup(num_layers=3, num_experts=8, top_k=2)
    return cfg, params


def _reqs():
    rng = np.random.RandomState(0)
    return [Request(rid=i, arrival=i * 0.4,
                    length=int(rng.choice([8, 16, 24, 32])))
            for i in range(10)]


def _engine(model, rebalance=True, **kw):
    cfg, params = model
    ex = DisaggregatedExecutor(params, cfg, D=D, E=E, device="cpu",
                               region_timeout=5.0)  # boots round robin
    rb = dict(rebalance_interval=1.0, rebalance_threshold=1.0,
              rebalance_target=Placement("replicated", replicate_hot=2)) \
        if rebalance else {}
    return ExecutorEngine(
        ex, clock=TraceClock(speed=50.0),
        batcher=LengthAwareBatcher(inflection=48, max_tokens=128,
                                   exclusive_cutoff=1 << 30, max_wait=0.05),
        **rb, **kw)


def _serve(eng, reqs):
    handles = eng.submit_all(reqs)
    results = eng.drain(timeout=TIMEOUT)
    eng.close()
    assert all(h.done() for h in handles)
    return results


def test_live_swap_mid_run_matches_the_reference_table(model):
    """A migration happens LIVE while requests are in flight; every rid
    completes exactly once with a first token equal to a frozen
    round-robin run's; the executor's table is the reference's
    ExpertLoadModel table for the executor's measured fractions."""
    cfg, _ = model
    eng = _engine(model)
    results = _serve(eng, _reqs())
    ex, st = eng.ex, eng.stats()
    assert st.migrations >= 1 and st.migrated_bytes > 0
    assert st.placement_policy == "replicated"
    assert ex.migrations[0]["moved_copies"] > 0
    assert eng.rebalance_windows  # the window the controller fired on
    assert sorted(r.rid for r in results) == list(range(10))
    assert all(r.ok and r.first_token is not None for r in results)
    # the reference's load model, fed the port executor's measured
    # fractions, gives the table the port installed
    target = RefPlacement("replicated", replicate_hot=2)
    lm = RefExpertLoadModel(num_experts=cfg.num_experts, top_k=cfg.top_k,
                            ep=E, mode="measured",
                            measured=ex.expert_fractions, placement=target)
    assert ex.table == lm.placement_table(0)
    assert ex.table == ExpertLoadModel(
        num_experts=cfg.num_experts, top_k=cfg.top_k, ep=E, mode="measured",
        measured=ex.expert_fractions,
        placement=Placement("replicated", replicate_hot=2)
    ).placement_table(0)
    assert ex.dev_experts == target.device_experts(ex.expert_fractions, E)
    for e, hosts in enumerate(ex.table):
        for d in hosts:
            assert e in ex.dev_experts[d]
    # the controller's view is what the executor serves
    assert eng.controller.placement == ex.placement
    assert eng.controller.converged and not eng.controller.active
    # first tokens equal a frozen round-robin run of the same requests
    frozen = _engine(model, rebalance=False)
    assert frozen.controller is None
    want = _serve(frozen, _reqs())
    assert not frozen.ex.migrations and frozen.ex.placement == Placement()
    assert {r.rid: r.first_token for r in results} \
        == {r.rid: r.first_token for r in want}


def test_router_stats_resampled_and_reference_json(model, tmp_path):
    """`resampled` as the reference's; `load` reads a file the reference's
    collector wrote, and the reference reads the port's."""
    from repro.core.engine import RouterStatsCollector as RefCollector
    rng = np.random.default_rng(0)
    col, jcol = RouterStatsCollector(8), RefCollector(8)
    for layer in range(3):
        ids = rng.integers(0, 8, size=64)
        col.record(layer, ids)
        jcol.record(layer, ids)
    for n in (8, 16, 256):
        assert col.resampled(n) == jcol.resampled(n)
    jcol.save(str(tmp_path / "ref.json"))
    col.save(str(tmp_path / "port.json"))
    a = RouterStatsCollector.load(str(tmp_path / "ref.json"))
    b = RefCollector.load(str(tmp_path / "port.json"))
    assert a.to_dict() == jcol.to_dict() and b.to_dict() == col.to_dict()
    assert a.fractions_tuple(1) == jcol.fractions_tuple(1)


def test_failover_placement_parity_executor_and_both_simulators(model):
    """The SAME crash (device 1) gives ONE table in the port's executor,
    the port's simulator and the reference's simulator; and where the
    engine runs a controller, `_on_failover` syncs its view."""
    plan = FaultPlan([FaultEvent(t=0.5, kind="crash_moe", device=1)])
    eng = _engine(model, fault_plan=plan)
    results = _serve(eng, _reqs())
    assert all(r.status == "ok" for r in results) and len(results) == 10
    ex_pl = eng.ex.placement
    assert ex_pl.dead == (1,) and eng.ex.failovers == 1
    c = eng.controller
    assert c.placement == ex_pl
    assert c.target.dead == (1,) and c.base.dead == (1,)
    fr = Placement.uniform_fractions(8)
    for t in (c.placement, c.target, c.base):
        assert all(1 not in h for h in t.table(fr, E))

    sim_kw = dict(mode="asap", rps=1.0, duration=10.0)
    sim = AsapSim(get_config("deepseek_v32"), SimConfig(
        fault_plan=FaultPlan([FaultEvent(t=2.0, kind="crash_moe", device=1,
                                         duration=5.0)]), **sim_kw),
        Deployment(D=2, T=2, E=4))
    sim.simulate()
    jsim = RefAsapSim(jax_get_config("deepseek_v32"), RefSimConfig(
        fault_plan=RefFaultPlan([RefFaultEvent(t=2.0, kind="crash_moe",
                                               device=1, duration=5.0)]),
        **sim_kw), RefDeployment(D=2, T=2, E=4))
    jsim.simulate()
    assert sim.load_model.placement.dead == jsim.load_model.placement.dead \
        == (1,)
    # a frozen engine under the same plan: round-robin base, device 1 dead
    frozen = _engine(model, rebalance=False, fault_plan=plan)
    _serve(frozen, _reqs())
    assert frozen.ex.placement.dead == (1,)
    table = frozen.ex.placement.table(fr, E)
    assert table == sim.load_model.placement.table(fr, E) \
        == jsim.load_model.placement.table(fr, E)


def _wait(pred, what, ex=None, e=None):
    deadline = time.monotonic() + TIMEOUT
    while not pred():
        assert time.monotonic() < deadline, what + (
            "" if ex is None else _waiting_on(ex, e))
        time.sleep(0.001)


def _waiting_on(ex, e) -> str:
    """What a wait on MoE worker `e` is waiting on: the thread's liveness
    and stack, its fence generation, the injector's pending and fired
    events, the worker's idle backoff and in-flight regions."""
    import sys
    import traceback
    th = ex._moe_threads[e]
    frame = sys._current_frames().get(th.ident)
    inj = ex.fault_injector
    return (f"\nworker {e}: alive {th.is_alive()}, _moe_gen {ex._moe_gen[e]}"
            f", idle_backoff {ex.idle_backoff}, current "
            f"{ex._moe_current[e]!r:.200}, injector pending "
            f"{inj.pending_events() if inj else None} fired "
            f"{inj.fired_events() if inj else None}, failovers "
            f"{ex.failovers}, errors {ex.errors}\nstack:\n"
            + ("".join(traceback.format_stack(frame)) if frame else "-"))


@pytest.mark.parametrize("order", ["swap_first", "failover_first"])
def test_crash_during_a_rebalance_tick(model, order, monkeypatch):
    """MoE device 3 (which the target gives a replica) crashes while the
    controller's tick executes its plan.  swap_first: the crash lands once
    the swap holds `_swap_lock` and quiesces -- the swap gives way
    (SwapAborted), the supervisor fails the device over, and a later tick
    installs the target degraded.  failover_first: the failover completes
    while the tick waits -- the swap then installs the target with device
    3 failed.  Either way: every request ends ok exactly once, no hang, no
    executor error, device 3 dead in the executor and in the controller's
    view, and no table routes to it."""
    eng = _engine(model)
    ex = eng.ex
    fired = []

    def crash_and_wait_dead():
        # the worker thread itself, not the slot: once it is failed over,
        # the supervisor puts a new (live) thread in _moe_threads[3], so a
        # failover that completes between two polls of the slot would hide
        # the death from the wait for good
        worker = ex._moe_threads[3]
        ex.arm_faults(FaultPlan([FaultEvent(t=0.0, kind="crash_moe",
                                            device=3)]))
        _wait(lambda: not worker.is_alive(), "no crash", ex, 3)

    aborted = []
    if order == "swap_first":
        real = DisaggregatedExecutor._apply_placement_locked

        def locked(self, placement, *a, **kw):
            if kw.get("drain_hook") is not None or fired:
                return real(self, placement, *a, **kw)
            fired.append(placement)
            crash_and_wait_dead()  # under _swap_lock: no failover yet
            try:
                return real(self, placement, *a, **kw)
            except executor_mod.SwapAborted:
                aborted.append(placement)
                raise
        monkeypatch.setattr(DisaggregatedExecutor, "_apply_placement_locked",
                            locked)
    else:
        real_apply = ex.apply_placement

        def apply(placement, **kw):
            if not fired:
                fired.append(placement)
                crash_and_wait_dead()
                _wait(lambda: ex.failovers >= 1, "no failover", ex, 3)
            return real_apply(placement, **kw)
        ex.apply_placement = apply

    results = _serve(eng, _reqs())
    assert fired, "the controller never fired"
    assert sorted(r.rid for r in results) == list(range(10))
    assert all(r.status == "ok" for r in results)
    assert not ex.errors and ex.failovers == 1
    assert ex.placement.dead == (3,)
    if order == "swap_first":
        assert aborted, "the swap did not give way to the failover"
    c = eng.controller
    assert c.placement == ex.placement
    assert c.target.dead == (3,) and c.base.dead == (3,)
    assert all(3 not in h for h in ex.table)
    assert all(3 not in h for h in c.placement.table(ex.expert_fractions, E))


def test_concurrent_polls_tick_the_controller_once_per_window(model):
    """Ticks from many threads at once (poll() from 6 pollers beside the
    drain, with a short interpreter switch interval): the one-shot plan is
    executed once, every request ends ok exactly once, and the controller's
    view is what the executor serves."""
    import sys
    import threading
    eng = _engine(model)
    stop = threading.Event()
    polled, errors = [], []

    def poller():
        try:
            while not stop.is_set():
                polled.extend(eng.poll())
        except BaseException as exc:  # re-raised on the test thread
            errors.append(exc)
            raise
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=poller) for _ in range(6)]
    try:
        handles = eng.submit_all(_reqs())
        for t in threads:
            t.start()
        drained = eng.drain(timeout=TIMEOUT)
    finally:
        stop.set()
        for t in threads:
            t.join(TIMEOUT)
        sys.setswitchinterval(old)
        eng.close()
    assert not any(t.is_alive() for t in threads) and not errors
    results = polled + drained
    assert sorted(r.rid for r in results) == list(range(10))
    assert all(h.done() and h.result().ok for h in handles)
    assert [m["kind"] for m in eng.ex.migrations] == ["rebalance"]
    assert len(eng.controller.plans) == 1
    assert eng.controller.placement == eng.ex.placement


# ---------------------------------------------------------------------------
# serve: placement control and the simulator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv,needle", [
    (["--rebalance-policy", "drift"], "requires --rebalance-interval"),
    (["--rebalance-threshold", "1.2"], "requires --rebalance-interval"),
    (["--rebalance-release", "1.0"], "requires --rebalance-interval"),
    (["--rebalance-cooldown", "3"], "requires --rebalance-interval"),
    (["--rebalance-max-bytes", "1e6"], "requires --rebalance-interval"),
    (["--rebalance-interval", "1", "--rebalance-policy", "partial"],
     "requires --rebalance-max-bytes"),
    (["--rebalance-interval", "1", "--rebalance-release", "2.0"],
     "must not exceed --rebalance-threshold"),
    (["--rebalance-interval", "0"], "--rebalance-interval must be positive"),
    (["--rebalance-interval", "1", "--rebalance-policy", "bogus"],
     "invalid choice"),
    (["--mode", "pd", "--rebalance-interval", "1"], "--mode pd"),
    (["--engine", "sim", "--request-deadline", "1"],
     "--engine sim does not consume it"),
    (["--engine", "sim", "--moe-batch-window", "0.01"],
     "--engine sim does not consume it"),
    (["--engine", "sim", "--moe-batch-window", "0.01",
      "--moe-batch-max-tokens", "64"], "--engine sim does not consume it"),
    (["--engine", "sim", "--smoke"], "--smoke sizes the executor's model"),
    (["--mode", "default"], "requires --engine sim"),
    (["--measured-from", "stats.json"], "requires --engine sim"),
    (["--ep-skew", "1.2"], "requires --engine sim"),
    (["--placement", "greedy_balanced", "--replicate-hot", "2"],
     "conflicts with"),
    (["--engine", "sim", "--tuning-table", "t.json"],
     "--tuning-table batches/tunes the REAL executor's super-kernel "
     "launches; --engine sim does not consume it"),
])
def test_serve_rejects_bad_rebalance_and_sim_flags(argv, needle, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--device", "cpu"] + argv)
    assert e.value.code == 2
    assert needle in capsys.readouterr().err


def test_serve_sim_engine_matches_the_reference_and_reads_measured_stats(
        tmp_path, capsys):
    """`--engine sim` prints the reference CLI's summary lines, with
    rebalancing, a MoE failure, and load driven by measured router stats
    saved by the port's executor."""
    from repro.launch import serve as ref_serve
    argv = ["--engine", "sim", "--rps", "2", "--duration", "8",
            "--ep-skew", "1.2", "--replicate-hot", "2",
            "--rebalance-interval", "2", "--failure-at", "3",
            "--fail-moe-device", "1"]
    assert serve.main(argv) == 0
    got = capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        import sys
        old = sys.argv
        sys.argv = ["serve"] + argv
        try:
            ref_serve.main()
        finally:
            sys.argv = old
    assert e.value.code == 0
    want = capsys.readouterr().out
    assert got == want and "migration(s)" in got and "completed:" in got
    # measured router stats from a CPU executor run feed the simulator
    stats = tmp_path / "router.json"
    assert serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                       "--time-scale", "50", "--save-router-stats",
                       str(stats)]) == 0
    assert json.loads(stats.read_text())["num_experts"] == 8
    capsys.readouterr()
    assert serve.main(["--engine", "sim", "--rps", "1", "--duration", "5",
                       "--measured-from", str(stats)]) == 0
    out = capsys.readouterr().out
    assert "MEASURED fractions" in out and "[measured fractions]" in out


def test_serve_pd_sim_matches_the_reference(capsys):
    from repro.launch import serve as ref_serve
    argv = ["--engine", "sim", "--mode", "pd", "--rps", "2",
            "--duration", "5", "--out-len-mean", "6"]
    assert serve.main(argv) == 0
    got = capsys.readouterr().out
    import sys
    old = sys.argv
    sys.argv = ["serve"] + argv
    try:
        with pytest.raises(SystemExit) as e:
            ref_serve.main()
    finally:
        sys.argv = old
    assert e.value.code == 0
    want = capsys.readouterr().out
    # the port says "link time" where the reference says "wire time"
    assert got == want.replace("ms wire time", "ms link time")
    assert "kv handoffs:" in got


def test_serve_executor_migrates_live(tmp_path, capsys):
    """--rebalance-interval on the executor engine: boots round-robin,
    migrates live toward --replicate-hot 2, every request ok."""
    stats = tmp_path / "stats.json"
    rc = serve.main(["--smoke", "--device", "cpu", "--requests", "8",
                     "--time-scale", "20", "--replicate-hot", "2",
                     "--rebalance-interval", "0.5",
                     "--rebalance-threshold", "1.0",
                     "--save-stats", str(stats)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "placement control plane: policy=one_shot_threshold" in out
    assert "live re-placement: 1 migration(s)" in out
    assert "now serving placement=replicated" in out
    saved = json.loads(stats.read_text())
    assert saved["statuses"] == {"ok": 8}
    assert saved["placement_policy"] == "replicated"
    assert [m["kind"] for m in saved["migration_log"]] == ["rebalance"]
