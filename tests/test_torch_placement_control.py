"""The port's placement control plane (`repro_torch.core.placement_control`)
against the reference's: the same observation sequences through both
controllers, under every policy, give equal plans (placements, moves,
bytes, flags) and equal controller state; `diff_tables` is equal on random
tables; and the port's `AsapSim`, rebalancing through the port's
controller, reproduces the reference tests' float-hex golden traces and the
reference simulator's plan history."""
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import cost_model as ref_cm
from repro.core import placement_control as ref
from repro.core.simulator import AsapSim as RefAsapSim
from repro.core.simulator import SimConfig as RefSimConfig
from repro_torch.configs import get_config
from repro_torch.core import cost_model as port_cm
from repro_torch.core import placement_control as port
from repro_torch.core.simulator import AsapSim, SimConfig

EP, N = 4, 8


def _pl(p):
    """A placement's identity, comparable across the packages."""
    return (p.policy, p.replicate_hot, p.dead, p.table_override)


def _plan(p, ep=EP):
    if p is None:
        return None
    return (_pl(p.placement),
            [(m.expert, m.dst, m.lkey, m.copies, m.nbytes) for m in p.moves],
            p.window, p.partial, p.reason, p.total_bytes, p.receivers(),
            tuple(p.device_cost(0.37, ep)))


def _state(c):
    return (_pl(c.placement), _pl(c.target), _pl(c.base), c.fractions,
            c.window, c.converged, c.active, len(c.plans))


def _zipf(n=N, alpha=1.2):
    p = np.arange(1, n + 1, dtype=np.float64) ** (-alpha)
    return p / p.sum()


TARGETS = {
    "replicated2": lambda m: m.Placement("replicated", replicate_hot=2),
    "greedy": lambda m: m.Placement("greedy_balanced"),
    "replicated4": lambda m: m.Placement("replicated", replicate_hot=4),
}

SCENARIOS = [
    ("one_shot_threshold", "replicated2", dict(threshold=1.2)),
    ("one_shot_threshold", "greedy", dict(threshold=1.0)),
    ("hysteresis", "replicated2", dict(threshold=1.5, release_threshold=1.05,
                                       cooldown_windows=2)),
    ("hysteresis", "replicated4", dict(threshold=1.3, release_threshold=1.2,
                                       cooldown_windows=0)),
    ("partial", "greedy", dict(threshold=1.0, max_bytes_per_window=400.0)),
    ("partial", "replicated4", dict(threshold=1.3,
                                    max_bytes_per_window=150.0)),
    ("drift", "replicated2", dict(drift_alpha=0.6, cooldown_windows=0)),
    ("drift", "replicated4", dict(drift_alpha=0.3, cooldown_windows=2)),
]


def _controller(mod, policy, target, kw):
    return mod.PlacementController(
        ep=EP, num_experts=N, layers=2, target=TARGETS[target](
            ref_cm if mod is ref else port_cm),
        policy=policy, bytes_per_copy=100.0,
        initial_fractions=_zipf(), **kw)


def _windows(seed, n=40):
    """Busy windows of varying imbalance, idle ones, and routing fractions
    (a zipf head that moves) on some of them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        busy = rng.uniform(0.5, 1.5, size=EP)
        busy[int(rng.integers(EP))] *= rng.uniform(1.0, 2.5)
        if i % 11 == 10:
            busy[:] = 0.0  # an idle window
        fr = None
        if i % 3 == 0:
            fr = np.roll(_zipf(), int(rng.integers(N))) \
                * rng.uniform(0.5, 2.0)
        out.append((float(i), busy, fr))
    return out


@pytest.mark.parametrize("policy,target,kw", SCENARIOS,
                         ids=[f"{p}-{t}-{i}" for i, (p, t, _) in
                              enumerate(SCENARIOS)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controllers_emit_equal_plans(policy, target, kw, seed):
    c = _controller(port, policy, target, kw)
    jc = _controller(ref, policy, target, kw)
    assert _state(c) == _state(jc)
    emitted = 0
    for now, busy, fr in _windows(seed):
        p = c.observe(port.WindowObservation(now, busy, fr))
        jp = jc.observe(ref.WindowObservation(now, busy, fr))
        assert _plan(p) == _plan(jp)
        assert _state(c) == _state(jc)
        emitted += p is not None
    assert emitted >= 1
    assert port.PlacementController.imbalance(busy) \
        == ref.PlacementController.imbalance(busy)


def test_sync_and_failure_follow_the_reference():
    """An out-of-band failover: both controllers synced the same way emit
    the same plans afterwards (the hysteresis release re-installs a base
    without the dead device)."""
    kw = dict(threshold=1.2, release_threshold=1.1, cooldown_windows=0)
    pairs = [(mod, _controller(mod, "hysteresis", "replicated2", kw))
             for mod in (port, ref)]
    for mod, ctl in pairs:
        assert ctl.observe(mod.WindowObservation(
            0.0, np.array([3.0, 1.0, 1.0, 1.0]))) is not None
        ctl.sync(placement=ctl.placement.fail(1),
                 target=ctl.target.fail(1), base=ctl.base.fail(1))
    (_, c), (_, jc) = pairs
    assert _state(c) == _state(jc)
    p = c.observe(port.WindowObservation(1.0, np.ones(EP)))
    jp = jc.observe(ref.WindowObservation(1.0, np.ones(EP)))
    assert p is not None and _plan(p) == _plan(jp)
    assert all(1 not in h for h in p.placement.table(c.fractions, EP))


@pytest.mark.parametrize("seed", range(4))
def test_diff_tables_equals_the_reference(seed):
    rng = np.random.default_rng(seed)

    def table():
        return tuple(tuple(int(d) for d in rng.choice(
            EP, size=int(rng.integers(1, 3)), replace=False))
            for _ in range(N))
    old, new = table(), table()
    got = port.diff_tables(old, new, lkey=seed, copies=3,
                           bytes_per_copy=7.5)
    want = ref.diff_tables(old, new, lkey=seed, copies=3,
                           bytes_per_copy=7.5)
    assert [vars(m) for m in got] == [vars(m) for m in want]
    assert port.POLICIES == ref.POLICIES


def test_constructor_errors_match_the_reference():
    for policy, kw in (("nonsense", {}), ("partial", {}),
                       ("hysteresis", dict(threshold=1.1,
                                           release_threshold=1.2))):
        with pytest.raises(ValueError) as e:
            _controller(port, policy, "replicated2", kw)
        with pytest.raises(ValueError) as je:
            _controller(ref, policy, "replicated2", kw)
        assert str(e.value) == str(je.value)


# Golden values of tests/test_placement_control.py (float hex): the port's
# simulator, rebalancing through the port's controller, must reproduce them.
GOLDEN = [
    (dict(mode="asap", rps=2.0, duration=20.0, ep_skew=1.2,
          placement="replicated", replicate_hot=2, rebalance_interval=4.0),
     dict(n_done=30, mean="0x1.a225a6d6419d0p-1", p99="0x1.7b92ad07ce3a7p+1",
          busy_sum="0x1.f601d3d333ce8p+5", busy_max="0x1.036d8cabf9637p+2",
          now="0x1.39701a46a530cp+4", inflection=2329)),
    (dict(mode="asap", rps=1.5, duration=15.0, ep_skew=1.0,
          ep_skew_mode="layer", placement="greedy_balanced",
          rebalance_interval=3.0, rebalance_threshold=1.02),
     dict(n_done=22, mean="0x1.e562ab7ba3dd9p-1", p99="0x1.9cb22d8641ae4p+1",
          busy_sum="0x1.2a086a92bf92ep+6", busy_max="0x1.64cc1f32aaefcp+2",
          now="0x1.1b768d151e85bp+4", inflection=1768)),
]


@pytest.mark.parametrize("kw,golden", GOLDEN)
def test_port_simulator_reproduces_the_golden_trace(kw, golden):
    sim = AsapSim(get_config("deepseek_v32"), SimConfig(**kw))
    sim.start()
    sim.run(horizon=200.0)
    t = np.array([r.ttft for r in sim.done])
    assert len(sim.done) == golden["n_done"]
    assert float(t.mean()).hex() == golden["mean"]
    assert float(np.percentile(t, 99)).hex() == golden["p99"]
    assert float(sim.moe_dev_busy_time.sum()).hex() == golden["busy_sum"]
    assert float(sim.moe_dev_busy_time.max()).hex() == golden["busy_max"]
    assert float(sim.now).hex() == golden["now"]
    assert sim.batcher.inflection == golden["inflection"]
    assert len(sim.controller.plans) == 1 and sim.controller.converged
    assert sim.load_model.placement == sim.controller.target


@pytest.mark.parametrize("kw", [
    dict(rebalance_policy="hysteresis", rebalance_release=0.5),
    dict(rebalance_policy="partial", rebalance_max_bytes=200e6),
    dict(rebalance_policy="partial", ep_skew_mode="zipf",
         rebalance_max_bytes=6.0 * 3 * 7168 * 2048 * 2 * 61),
    dict(rebalance_policy="drift"),
    dict(rebalance_policy="one_shot_threshold", failure_at=5.0,
         failure_moe_device=0),
])
def test_simulator_plan_history_equals_the_reference(kw):
    base = dict(mode="asap", rps=1.5, duration=15.0, ep_skew=1.2,
                placement="replicated", replicate_hot=2,
                rebalance_interval=3.0, rebalance_threshold=1.01)
    sim = AsapSim(get_config("deepseek_v32"), SimConfig(**{**base, **kw}))
    jsim = RefAsapSim(jax_get_config("deepseek_v32"),
                      RefSimConfig(**{**base, **kw}))
    for s in (sim, jsim):
        s.start()
        s.run(horizon=200.0)
    assert sim.ep == jsim.ep == 16
    assert [_plan(p, 16) for p in sim.controller.plans] \
        == [_plan(p, 16) for p in jsim.controller.plans]
    assert _state(sim.controller) == _state(jsim.controller)
    assert [(r.rid, r.first_token_time) for r in sim.done] \
        == [(r.rid, r.first_token_time) for r in jsim.done]
    assert np.array_equal(sim.moe_dev_busy_time, jsim.moe_dev_busy_time)
