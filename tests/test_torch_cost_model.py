"""The port's analytic cost model (`repro_torch.core.cost_model`) against the
reference's (`repro.core.cost_model`): the same inputs through both give
equal outputs, float for float (`==`, no tolerance) -- `CostModel`'s
methods, `ExpertLoadModel` in every mode and placement, `optimal_deployment`
and `resample_fractions`.  The `H100` preset has no reference to equal: it
runs `CostModel` and `AsapSim` to completion."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import cost_model as ref
from repro_torch.configs import get_config
from repro_torch.core import cost_model as port

ARCHS = ["deepseek_v32", "qwen3_moe_235b_a22b", "dbrx_132b"]
DEPS = [dict(D=4, T=4, E=16), dict(D=2, T=2, E=4), dict(D=8, T=4, E=32)]


def _same(a, b):
    """Equal, float for float: arrays by value and dtype, containers
    element-wise."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b), (a, b)
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert type(a) is type(b) and a == b, (a, b)


def _placements(mod, n):
    """The same placement policies in `mod` (either package)."""
    table = tuple((e % 3,) if e % 5 else (e % 3, 3) for e in range(n))
    return {
        "round_robin": mod.Placement(),
        "greedy": mod.Placement("greedy_balanced"),
        "replicated2": mod.Placement("replicated", replicate_hot=2),
        "replicated5_dead1": mod.Placement("replicated",
                                           replicate_hot=5).fail(1),
        "explicit": mod.Placement.explicit(table),
        "explicit_dead3": mod.Placement.explicit(table).fail(3),
    }


def test_presets():
    """V5E is the reference's preset field for field (the port adds a
    name); Hardware() is V5E; H100 keeps the port's KV-handoff fields."""
    for f in dataclasses.fields(ref.Hardware):
        assert getattr(port.V5E, f.name) == getattr(ref.V5E, f.name)
    assert port.Hardware() == port.V5E
    assert port.V5E.collective_bw == ref.V5E.collective_bw
    assert port.H100.name == "h100-sxm" and port.H100.ici_links == 1
    assert port.H100.collective_bw == port.H100.ici_bw == 450e9
    assert port.Deployment() == port.Deployment(D=4, T=4, E=16)
    assert dataclasses.asdict(port.Deployment(D=3, T=2, E=5)) \
        == dataclasses.asdict(ref.Deployment(D=3, T=2, E=5))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dep", DEPS, ids=lambda d: f"D{d['D']}T{d['T']}E{d['E']}")
def test_cost_model_methods_equal_the_reference(arch, dep):
    jcm = ref.CostModel(jax_get_config(arch), dep=ref.Deployment(**dep))
    cm = port.CostModel(get_config(arch), dep=port.Deployment(**dep))
    rng = np.random.default_rng(len(arch) + dep["E"])
    for _ in range(3):
        lens = [int(x) for x in rng.integers(1, 40_000, size=int(
            rng.integers(1, 9)))]
        tokens = int(rng.integers(0, 70_000))
        for name in ("attention_layer_flops", "attention_layer_bytes",
                     "attention_layer_latency", "prefill_attention_latency",
                     "decode_attention_step_latency",
                     "decode_step_latency"):
            _same(getattr(cm, name)(lens), getattr(jcm, name)(lens))
        for name in ("moe_layer_latency", "dispatch_bytes",
                     "async_dispatch_latency", "dispatch_send_occupancy",
                     "moe_comm_occupancy", "combine_wire_latency",
                     "sync_p2p_dispatch_latency", "async_combine_latency",
                     "kv_transfer_seconds"):
            _same(getattr(cm, name)(tokens), getattr(jcm, name)(tokens))
        busy = float(rng.uniform(0, 1e-3))
        _same(cm.sync_p2p_dispatch_latency(tokens, receiver_busy=busy),
              jcm.sync_p2p_dispatch_latency(tokens, receiver_busy=busy))
        a = rng.uniform(0, 5000, size=(3, dep["E"]))
        hit = rng.uniform(0, 8, size=(3, dep["E"]))
        _same(cm.moe_device_latency(a, hit, float(tokens)),
              jcm.moe_device_latency(a, hit, float(tokens)))
        _same(cm.moe_device_latency(float(a[0, 0]), float(hit[0, 0])),
              jcm.moe_device_latency(float(a[0, 0]), float(hit[0, 0])))
        hot = float(rng.uniform(1.0 / dep["E"], 1.0))
        _same(cm.moe_inflection_tokens(hot), jcm.moe_inflection_tokens(hot))
        _same(cm.stage_utilization(1.5, 4000.0, hot_factor=1.7),
              jcm.stage_utilization(1.5, 4000.0, hot_factor=1.7))
    _same(cm.kv_token_bytes(), jcm.kv_token_bytes())
    _same(cm.expert_bytes(), jcm.expert_bytes())
    _same(cm.moe_inflection_tokens(), jcm.moe_inflection_tokens())
    _same(cm.summary(), jcm.summary())
    # with a dispatch fan-out override and a load model in the decode step
    lm = port.ExpertLoadModel(cm.cfg.num_experts, cm.cfg.top_k, dep["E"],
                              mode="zipf", alpha=1.2)
    jlm = ref.ExpertLoadModel(cm.cfg.num_experts, cm.cfg.top_k, dep["E"],
                              mode="zipf", alpha=1.2)
    _same(cm.decode_step_latency([100, 2000, 17], lm, lkey=2),
          jcm.decode_step_latency([100, 2000, 17], jlm, lkey=2))
    cm2 = dataclasses.replace(cm, copies_override=lm.expected_copies())
    jcm2 = dataclasses.replace(jcm, copies_override=jlm.expected_copies())
    _same(cm2.dispatch_bytes(1234), jcm2.dispatch_bytes(1234))


def _load_models(mod, mode, n, ep, placement, measured):
    kw = dict(mode=mode, placement=placement)
    if mode in ("zipf", "layer"):
        kw.update(alpha=1.2, seed=3)
    if mode == "measured":
        kw.update(measured=measured, seed=5)
    return mod.ExpertLoadModel(num_experts=n, top_k=4, ep=ep, **kw)


@pytest.mark.parametrize("mode", ["uniform", "zipf", "layer", "measured",
                                  "measured_resampled"])
@pytest.mark.parametrize("policy", list(_placements(port, 16)))
def test_expert_load_model_equals_the_reference(mode, policy):
    n, ep = 16, 4
    rng = np.random.default_rng(7)
    measured = tuple(float(x) for x in rng.dirichlet(
        np.full(n if mode == "measured" else 6, 0.4)))
    m = "measured" if mode.startswith("measured") else mode
    lm = _load_models(port, m, n, ep, _placements(port, n)[policy], measured)
    jlm = _load_models(ref, m, n, ep, _placements(ref, n)[policy], measured)
    for layer in range(3):
        _same(lm.expert_fractions(layer), jlm.expert_fractions(layer))
        _same(lm.placement_table(layer), jlm.placement_table(layer))
        _same(lm.device_fractions(layer), jlm.device_fractions(layer))
        for tokens in (0.0, 1.0, 333.0, 5000.0):
            _same(lm.device_loads(tokens, layer),
                  jlm.device_loads(tokens, layer))
            _same(lm.device_experts_hit(tokens, layer),
                  jlm.device_experts_hit(tokens, layer))
    _same(lm.hot_fraction(), jlm.hot_fraction())
    _same(lm.expected_copies(), jlm.expected_copies())
    _same(lm.layer_device_loads(777.0, 5), jlm.layer_device_loads(777.0, 5))
    _same(lm.layer_device_hits(777.0, 5), jlm.layer_device_hits(777.0, 5))
    _same(lm.layer_hot_factors(5), jlm.layer_hot_factors(5))
    if policy != "explicit_dead3":
        _same(lm.with_failed(2).placement_table(0),
              jlm.with_failed(2).placement_table(0))
        _same(lm.with_failed(2).device_fractions(0),
              jlm.with_failed(2).device_fractions(0))


@pytest.mark.parametrize("m,n", [(8, 8), (8, 256), (256, 16), (5, 128),
                                 (128, 128)])
def test_resample_fractions_equals_the_reference(m, n):
    fr = tuple(float(x) for x in
               np.random.default_rng(m * 1000 + n).dirichlet(np.ones(m)))
    _same(port.resample_fractions(fr, n), ref.resample_fractions(fr, n))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", ["uniform", "placement", "fractions",
                                  "both", "explicit", "long"])
def test_optimal_deployment_equals_the_reference(arch, case):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    n = cfg.num_experts
    fr = tuple(float(x) for x in np.arange(1, 9, dtype=np.float64) ** -1.2)
    table = tuple((e % 4,) for e in range(n))
    kw, jkw = {}, {}
    if case in ("placement", "both"):
        kw["placement"] = port.Placement("replicated", replicate_hot=2)
        jkw["placement"] = ref.Placement("replicated", replicate_hot=2)
    if case in ("fractions", "both"):
        kw["expert_fractions"] = jkw["expert_fractions"] = fr
    if case == "explicit":  # device ids beyond small candidate pools
        kw["placement"] = port.Placement.explicit(
            tuple((e % 24,) for e in range(n)))
        jkw["placement"] = ref.Placement.explicit(
            tuple((e % 24,) for e in range(n)))
    if case == "long":
        kw["placement"] = port.Placement.explicit(table)
        jkw["placement"] = ref.Placement.explicit(table)
        kw["mean_len"] = jkw["mean_len"] = 30_000.0
    got = port.optimal_deployment(cfg, chips=48, **kw)
    want = ref.optimal_deployment(jcfg, chips=48, **jkw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_h100_preset_runs_the_cost_model_and_the_simulator():
    """The H100 preset where the reference's constructors take `hw`: every
    CostModel method gives a finite positive time, and AsapSim serves a
    short trace to completion (no reference to equal: the reference has no
    such preset)."""
    from repro_torch.core.simulator import AsapSim, SimConfig
    cfg = get_config("deepseek_v32")
    cm = port.CostModel(cfg, port.H100, port.Deployment(D=2, T=2, E=4))
    for v in (cm.attention_layer_latency([4096]), cm.moe_layer_latency(4096),
              cm.async_dispatch_latency(4096), cm.kv_transfer_seconds(4096),
              cm.sync_p2p_dispatch_latency(4096),
              cm.decode_step_latency([512, 1024])):
        assert np.isfinite(v) and v > 0
    # the H100 is faster than the reference's preset on every term
    v5e = port.CostModel(cfg, port.V5E, port.Deployment(D=2, T=2, E=4))
    assert cm.attention_layer_latency([4096]) \
        < v5e.attention_layer_latency([4096])
    sim = AsapSim(cfg, SimConfig(mode="asap", rps=2.0, duration=5.0,
                                 ep_skew=1.2, placement="replicated",
                                 replicate_hot=2, rebalance_interval=1.0),
                  port.Deployment(D=2, T=2, E=4), port.H100)
    res = sim.simulate()
    assert sim.cm.hw is port.H100
    assert res.completed_fraction() == 1.0 and len(sim.done) > 0
    assert all(np.isfinite(r.ttft) and r.ttft > 0 for r in sim.done)
