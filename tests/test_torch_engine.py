"""The port's ExecutorEngine (CPU) against the JAX model on bridged params:
timed admission, out-of-order streaming, TTFT decomposition, first tokens."""
import json

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import smoke_setup
from repro.models.lm import lm_backbone as jax_lm_backbone
from repro.models.lm import lm_head as jax_lm_head
from repro_torch.core.engine import (ExecutorEngine, RouterStatsCollector,
                                     _pad_bucket)
from repro_torch.core.executor import DisaggregatedExecutor
from repro_torch.core.scheduler import LengthAwareBatcher
from repro_torch.core.trace import (Request, TraceClock, TraceConfig,
                                    generate_requests, sample_lengths)
from repro_torch.launch import serve


def _engine(params, cfg, D=2, E=4, speed=200.0):
    ex = DisaggregatedExecutor(params, cfg, D=D, E=E, device="cpu")
    return ExecutorEngine(
        ex, clock=TraceClock(speed=speed),
        batcher=LengthAwareBatcher(inflection=48, max_tokens=128,
                                   exclusive_cutoff=1 << 30, max_wait=0.05))


def _trace(n=6, seed=0, spacing=0.1):
    rng = np.random.RandomState(seed)
    return [Request(rid=i, arrival=i * spacing,
                    length=int(rng.choice([8, 16, 24, 32])))
            for i in range(n)]


def _check_result_contract(results, reqs):
    assert sorted(r.rid for r in results) == sorted(r.rid for r in reqs)
    for r in results:
        assert r.ok and r.status == "ok"
        assert r.ttft >= 0
        assert all(v >= 0 for v in r.decomposition.values())
        assert sum(r.decomposition.values()) <= r.ttft + 1e-6


def test_engine_serves_late_arrivals_with_jax_first_tokens():
    jcfg, jparams, cfg, params = smoke_setup(num_experts=8)
    reqs = _trace(6)
    rng = np.random.RandomState(3)
    prompts = {r.rid: rng.randint(0, cfg.vocab_size, r.length)
               for r in reqs}
    eng = _engine(params, cfg)
    handles = [eng.submit(r, prompts[r.rid]) for r in reqs]
    results = eng.drain(timeout=300)
    _check_result_contract(results, reqs)
    assert all(h.done() for h in handles)
    st = eng.stats()
    eng.close()
    assert st.completed == 6 and st.statuses == {"ok": 6}
    assert st.expert_fractions.sum() == pytest.approx(1.0)
    assert st.router_assignments == sum(
        r.length for r in reqs) * cfg.num_layers * cfg.top_k  # pads excluded
    assert st.moe_launches > 0 and st.regions_per_launch() == 1.0
    # first token == argmax of the JAX head over the JAX backbone at each
    # request's last position (padding does not reach it: causal attention)
    for r in results:
        toks = jnp.asarray(prompts[r.rid])[None]
        h, _ = jax_lm_backbone(jparams, jcfg, toks, moe_mode="dense")
        logits = np.asarray(jax_lm_head(jparams, h[0, -1], jcfg))
        assert r.first_token == int(np.argmax(logits))
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] > 1e-4, "argmax is a near-tie"


def test_late_arrival_not_batched_with_t0_wave_and_completions_stream():
    _, _, cfg, params = smoke_setup(num_experts=8)
    eng = _engine(params, cfg, speed=5.0)
    early = [Request(rid=i, arrival=0.0, length=16) for i in range(3)]
    late = Request(rid=3, arrival=2.0, length=16)
    eng.submit_all(early + [late])
    h_late = eng._handles[3]
    results = eng.drain(timeout=300)
    eng.close()
    _check_result_contract(results, early + [late])
    by = {r.rid: r for r in results}
    assert by[3].batch_id not in {by[i].batch_id for i in range(3)}
    assert by[3].first_token_time >= 2.0
    assert h_late.result().rid == 3


def test_poll_streams_results_and_handles_block():
    _, _, cfg, params = smoke_setup()
    eng = _engine(params, cfg, D=1, E=2)
    reqs = _trace(4, seed=2, spacing=0.05)
    handles = eng.submit_all(reqs)
    first = handles[0].result(timeout=300)
    assert first.rid == 0 and first.first_token is not None
    got = list(eng.poll())
    got += eng.drain(timeout=300)
    eng.close()
    assert sorted(r.rid for r in got) == [0, 1, 2, 3]


def test_router_stats_collector_round_trip(tmp_path):
    c = RouterStatsCollector(4)
    assert c.fractions().tolist() == [0.25] * 4
    c.record(0, np.array([0, 0, 1, 3]))
    c.record(1, counts=np.array([0, 0, 4, 0]))
    assert c.total == 8
    np.testing.assert_allclose(c.fractions(), [0.25, 0.125, 0.5, 0.125])
    assert c.hot_experts(1).tolist() == [2]
    path = tmp_path / "stats.json"
    c.save(str(path))
    d = RouterStatsCollector.load(str(path))
    np.testing.assert_array_equal(d.fractions(0), c.fractions(0))


@pytest.mark.parametrize("n,want", [(1, 8), (8, 8), (9, 16), (100, 128)])
def test_pad_bucket(n, want):
    assert _pad_bucket(n) == want


def test_trace_equals_reference():
    from repro.core import trace as jtrace
    tc, jtc = TraceConfig(seed=3), jtrace.TraceConfig(seed=3)
    np.testing.assert_array_equal(sample_lengths(50, tc),
                                  jtrace.sample_lengths(50, jtc))
    a, b = generate_requests(4.0, 5.0, tc), jtrace.generate_requests(4.0, 5.0,
                                                                     jtc)
    assert [(r.rid, r.arrival, r.length) for r in a] == \
        [(r.rid, r.arrival, r.length) for r in b]


def test_batcher_equals_reference():
    from repro.core import scheduler as jsched
    from repro.core import trace as jtrace
    mine = LengthAwareBatcher(inflection=64, max_tokens=128, max_wait=0.05)
    ref = jsched.LengthAwareBatcher(inflection=64, max_tokens=128,
                                    max_wait=0.05)
    rng = np.random.RandomState(0)
    now = 0.0
    for i in range(40):
        now += float(rng.exponential(0.02))
        n = int(rng.randint(4, 90))
        a = mine.add(Request(rid=i, arrival=now, length=n), now)
        b = ref.add(jtrace.Request(rid=i, arrival=now, length=n), now)
        assert [[r.rid for r in x.requests] for x in a] == \
            [[r.rid for r in x.requests] for x in b]
    assert [r.rid for x in mine.flush(now) for r in x.requests] == \
        [r.rid for x in ref.flush(now) for r in x.requests]


def test_serve_main_smoke_cpu(tmp_path, capsys):
    stats = tmp_path / "stats.json"
    rc = serve.main(["--smoke", "--device", "cpu", "--requests", "4",
                     "--time-scale", "50", "--save-stats", str(stats)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "completed 4/4 requests" in out and "status=ok" in out
    saved = json.loads(stats.read_text())
    assert saved["completed"] == 4 and saved["device"] == "cpu"


def test_serve_rejects_flags_outside_the_slice():
    # --moe-batch-window and --moe-path are ported (their invalid
    # combinations: test_torch_moe_batching.py), and so are --engine sim,
    # the --rebalance-* flags (test_torch_engine_rebalance.py) and
    # --tuning-table (test_torch_tuning.py); --moe-kernel stays out
    for flag in (["--moe-kernel", "ref"],):
        with pytest.raises(SystemExit) as e:
            serve.main(["--smoke", "--device", "cpu"] + flag)
        assert e.value.code == 2  # argparse error, nothing silently ignored


def test_serve_requests_reuses_a_long_lived_executor():
    _, _, cfg, params = smoke_setup(num_experts=8)
    kw = dict(rps=50.0, time_scale=50.0, device="cpu", max_batch_tokens=64)
    first = serve.serve_requests(cfg, params, lengths=[16, 24, 8], **kw)
    ex = first["executor"]
    assert all(r.ok for r in first["results"]) and first["batch_layers"] > 0
    second = serve.serve_requests(cfg, params, lengths=[12, 30], executor=ex,
                                  **kw)
    assert second["executor"] is ex
    assert sorted(r.rid for r in second["results"]) == [0, 1]
    assert all(r.ok and r.ttft >= 0 for r in second["results"])
    # telemetry is this wave's alone
    assert second["stats"].moe_launches == len(second["buckets"])
    st = second["stats"]
    assert st.bucket_hits + st.bucket_misses == st.moe_launches
    assert st.completed == 2 and st.elapsed < 60  # this wave's own clock
