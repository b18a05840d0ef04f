"""The port's simulator (`repro_torch.core.simulator`) and its engines
(`SimEngine`, `SimDecodeEngine`) against the reference's: the same
configuration through both gives equal results, float for float (`==`) --
`run_sim` in the asap / default / chunked modes with routing skew,
failures, replication and rebalancing, `slo_throughput`, and the
completions the two engines stream."""
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import simulator as ref
from repro.core.cost_model import Deployment as RefDeployment
from repro.core.decode import SimDecodeEngine as RefSimDecodeEngine
from repro.core.engine import SimEngine as RefSimEngine
from repro.core.faults import FaultEvent as RefFaultEvent
from repro.core.faults import FaultPlan as RefFaultPlan
from repro.core.orchestrator import PDOrchestrator as RefPDOrchestrator
from repro.core.trace import TraceConfig as RefTraceConfig
from repro.core.trace import generate_requests as ref_generate_requests
from repro_torch.configs import get_config
from repro_torch.core import simulator as port
from repro_torch.core.cost_model import Deployment
from repro_torch.core.decode import SimDecodeEngine
from repro_torch.core.engine import SimEngine
from repro_torch.core.faults import FaultEvent, FaultPlan
from repro_torch.core.orchestrator import PDOrchestrator
from repro_torch.core.trace import TraceConfig, generate_requests

ARCH = "deepseek_v32"

CASES = {
    "asap": dict(mode="asap", rps=2.0, duration=10.0),
    "asap_zipf_skew": dict(mode="asap", rps=2.0, duration=10.0, ep_skew=1.2),
    "asap_layer_skew_greedy": dict(mode="asap", rps=2.0, duration=10.0,
                                   ep_skew=1.0, ep_skew_mode="layer",
                                   placement="greedy_balanced"),
    "asap_replicated_rebalance": dict(mode="asap", rps=2.0, duration=10.0,
                                      ep_skew=1.2, replicate_hot=2,
                                      rebalance_interval=2.0),
    "asap_hysteresis": dict(mode="asap", rps=1.5, duration=10.0,
                            ep_skew=1.2, replicate_hot=2,
                            rebalance_interval=2.0, rebalance_threshold=1.01,
                            rebalance_policy="hysteresis",
                            rebalance_release=0.5),
    "asap_group_failure": dict(mode="asap", rps=1.5, duration=10.0,
                               failure_at=3.0, failure_duration=2.0),
    "asap_moe_failure": dict(mode="asap", rps=1.0, duration=10.0,
                             ep_skew=1.2, replicate_hot=2, failure_at=3.0,
                             failure_moe_device=2),
    "asap_measured": dict(mode="asap", rps=2.0, duration=10.0,
                          measured_fractions=(0.4, 0.2, 0.1, 0.1, 0.05,
                                              0.05, 0.05, 0.05)),
    "asap_ablations": dict(mode="asap", rps=2.0, duration=10.0,
                           interleave=False, overlap=False,
                           super_kernel=False),
    "default": dict(mode="default", rps=1.5, duration=10.0),
    "default_skew_moe_failure": dict(mode="default", rps=1.0, duration=10.0,
                                     ep_skew=1.2, failure_at=3.0,
                                     failure_moe_device=1),
    "default_group_failure": dict(mode="default", rps=1.0, duration=10.0,
                                  failure_at=3.0),
    "chunked": dict(mode="chunked", rps=1.5, duration=10.0, ep_skew=0.8),
}


def _same_result(got, want):
    assert got.total_requests == want.total_requests
    assert [vars(r) for r in got.requests] == [vars(r) for r in want.requests]
    assert got.decomposition == want.decomposition
    for f in ("moe_device_util", "moe_device_mean_qdepth",
              "moe_device_peak_qdepth"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.array_equal(a, b), f
    assert got.mean_ttft == want.mean_ttft and got.p99_ttft == want.p99_ttft
    assert got.moe_imbalance() == want.moe_imbalance()
    assert got.completed_fraction() == want.completed_fraction()


@pytest.mark.parametrize("case", list(CASES))
def test_run_sim_equals_the_reference(case):
    kw = CASES[case]
    deps = dict(asap_dep=Deployment(D=4, T=4, E=16),
                sync_dep=Deployment(D=8, T=4, E=32))
    jdeps = dict(asap_dep=RefDeployment(D=4, T=4, E=16),
                 sync_dep=RefDeployment(D=8, T=4, E=32))
    got = port.run_sim(get_config(ARCH), port.SimConfig(**kw), **deps)
    want = ref.run_sim(jax_get_config(ARCH), ref.SimConfig(**kw), **jdeps)
    assert len(got.requests) > 0
    _same_result(got, want)


def test_fault_plan_drives_both_simulators_alike():
    """A FaultPlan (a crash, a stall, a dropped combine) interpreted by
    both simulators, and the degraded placement it leaves."""
    events = [("crash_moe", 2.0, 1, 3.0), ("stall_moe", 4.0, 0, 0.5),
              ("drop_combine", 5.0, 2, 0.0)]
    plan = FaultPlan([FaultEvent(t=t, kind=k, device=d, duration=w)
                      for k, t, d, w in events])
    jplan = RefFaultPlan([RefFaultEvent(t=t, kind=k, device=d, duration=w)
                          for k, t, d, w in events])
    kw = dict(mode="asap", rps=1.0, duration=10.0)
    sim = port.AsapSim(get_config(ARCH), port.SimConfig(fault_plan=plan, **kw),
                       Deployment(D=2, T=2, E=4))
    jsim = ref.AsapSim(jax_get_config(ARCH),
                       ref.SimConfig(fault_plan=jplan, **kw),
                       RefDeployment(D=2, T=2, E=4))
    _same_result(sim.simulate(), jsim.simulate())
    assert sim.load_model.placement.dead == jsim.load_model.placement.dead \
        == (1,)


@pytest.mark.parametrize("mode,kw", [
    ("asap", dict(ep_skew=1.2)),
    ("default", dict()),
])
def test_slo_throughput_equals_the_reference(mode, kw):
    args = dict(slo=5.0, duration=6.0, refine=1.0, rps_max=8.0, **kw)
    got = port.slo_throughput(get_config(ARCH), mode, **args)
    want = ref.slo_throughput(jax_get_config(ARCH), mode, **args)
    assert got == want and got > 0


def test_drain_horizon_equals_the_reference():
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    for tc, jtc in ((TraceConfig(), RefTraceConfig()),
                    (TraceConfig(out_len_mean=32.0, out_len_cv=0.5),
                     RefTraceConfig(out_len_mean=32.0, out_len_cv=0.5))):
        s = port.SimConfig(rps=3.0, duration=12.0, trace=tc)
        js = ref.SimConfig(rps=3.0, duration=12.0, trace=jtc)
        assert port.drain_horizon(s, port.AsapSim(cfg, s).cm) \
            == ref.drain_horizon(js, ref.AsapSim(jcfg, js).cm)


def _stream(engine, reqs):
    """Submit `reqs`, poll len(reqs) + 2 times, then drain: every
    completion in the order the engine streamed it."""
    handles = engine.submit_all(reqs)
    out = []
    for _ in range(len(reqs) + 2):
        out += [("poll", r.rid, r.first_token_time, r.status,
                 tuple(sorted(r.decomposition.items()))) for r in
                engine.poll()]
    out += [("drain", r.rid, r.first_token_time, r.status,
             tuple(sorted(r.decomposition.items())))
            for r in engine.drain()]
    assert all(h.done() for h in handles)
    return out


@pytest.mark.parametrize("mode", ["asap", "default"])
def test_sim_engine_streams_the_reference_completions(mode):
    kw = dict(mode=mode, rps=2.0, duration=8.0, ep_skew=1.2)
    if mode == "asap":
        kw.update(replicate_hot=2, rebalance_interval=2.0)
    eng = SimEngine(get_config(ARCH), port.SimConfig(**kw))
    jeng = RefSimEngine(jax_get_config(ARCH), ref.SimConfig(**kw))
    assert eng.virtual
    reqs = generate_requests(2.0, 8.0, TraceConfig())
    jreqs = ref_generate_requests(2.0, 8.0, RefTraceConfig())
    assert [vars(r) for r in reqs] == [vars(r) for r in jreqs]
    got, want = _stream(eng, reqs), _stream(jeng, jreqs)
    assert got == want and len(got) == len(reqs)
    st, jst = eng.stats(), jeng.stats()
    for f in ("engine", "elapsed", "submitted", "completed",
              "router_assignments", "placement_policy", "migrations",
              "migrated_bytes", "statuses"):
        assert getattr(st, f) == getattr(jst, f), f
    assert np.array_equal(st.expert_fractions, jst.expert_fractions)
    assert np.array_equal(st.moe_device_util, jst.moe_device_util)
    # a handle's result() fast-forwards the virtual clock the same way
    e2 = SimEngine(get_config(ARCH), port.SimConfig(**kw))
    j2 = RefSimEngine(jax_get_config(ARCH), ref.SimConfig(**kw))
    h = e2.submit_all(generate_requests(2.0, 8.0, TraceConfig()))[3]
    jh = j2.submit_all(ref_generate_requests(2.0, 8.0, RefTraceConfig()))[3]
    assert h.result().first_token_time == jh.result().first_token_time


def test_sim_engine_overload_ends_in_timeouts_like_the_reference():
    """Beyond the horizon an overloaded config leaves requests unserved;
    drain() ends them `timeout` in both packages."""
    kw = dict(mode="default", rps=40.0, duration=2.0)
    eng = SimEngine(get_config(ARCH), port.SimConfig(**kw))
    jeng = RefSimEngine(jax_get_config(ARCH), ref.SimConfig(**kw))
    eng._horizon = jeng._horizon = 6.0
    got = _stream(eng, generate_requests(40.0, 2.0, TraceConfig()))
    want = _stream(jeng, ref_generate_requests(40.0, 2.0, RefTraceConfig()))
    assert got == want
    assert any(r[3] == "timeout" for r in got)


@pytest.mark.parametrize("colocated", [False, True])
def test_sim_pd_streams_the_reference_completions(colocated):
    """Prefill SimEngine -> KV handoff -> SimDecodeEngine under the
    PDOrchestrator, priced on the prefill simulator's hardware: the same
    completions (times, tokens out, TPOT) and KV accounting as the
    reference's."""
    def run(mods):
        SE, SDE, PD, SC, TC, gen = mods
        tc = TC(out_len_mean=6.0, out_len_cv=0.5)
        pre = SE(get_config(ARCH) if SE is SimEngine
                 else jax_get_config(ARCH),
                 SC(mode="asap", rps=2.0, duration=6.0, ep_skew=1.2,
                    trace=tc))
        dec = SDE(pre.cfg, pre._sim.cm, load_model=pre._sim.load_model,
                  width=8)
        orch = PD([pre], [dec], hw=pre._sim.cm.hw, colocated=colocated)
        reqs = gen(2.0, 6.0, tc)
        orch.submit_all(reqs)
        res = orch.drain()
        return ([(r.rid, r.status, r.first_token_time, r.completion_time,
                  r.tokens_out, r.token_times, r.tpot,
                  tuple(sorted(r.decomposition.items())))
                 for r in sorted(res, key=lambda r: r.rid)],
                (orch.kv_log.count, orch.kv_log.bytes, orch.kv_log.seconds),
                [r.out_len for r in reqs])
    got = run((SimEngine, SimDecodeEngine, PDOrchestrator, port.SimConfig,
               TraceConfig, generate_requests))
    want = run((RefSimEngine, RefSimDecodeEngine, RefPDOrchestrator,
                ref.SimConfig, RefTraceConfig, ref_generate_requests))
    assert got == want
    results, kv, out_lens = got
    assert all(r[1] == "ok" and r[4] == n for r, n in zip(results, out_lens))
    assert (kv[0] == 0) == colocated


def _entries(entries):
    return [tuple(getattr(e, k) for k in e.__slots__) for e in entries]


def test_decode_sim_equals_the_reference():
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    cm = port.AsapSim(cfg, port.SimConfig(ep_skew=1.2)).cm
    jcm = ref.AsapSim(jcfg, ref.SimConfig(ep_skew=1.2)).cm
    ds, jds = port.DecodeSim(cfg, cm, width=3), ref.DecodeSim(jcfg, jcm,
                                                               width=3)
    rng = np.random.default_rng(4)
    for rid in range(7):
        args = (rid, int(rng.integers(64, 4096)), int(rng.integers(1, 20)),
                float(rng.uniform(0, 0.5)))
        ds.enroll(*args)
        jds.enroll(*args)
    for t in (0.1, 0.3, 1.0):
        ds.advance(t)
        jds.advance(t)
        assert ds.now == jds.now and ds.load == jds.load
        assert _entries(ds.completed) == _entries(jds.completed)
    assert ds.remaining_work() == jds.remaining_work()
    left, jleft = ds.drain(1e9), jds.drain(1e9)
    assert _entries(left) == _entries(jleft)
    assert _entries(ds.completed) == _entries(jds.completed)
    assert len(ds.completed) == 7
