"""The port's prefill/decode runtime on the CPU: KV handoff accounting, the
decode admission queue, the decode runtime against the JAX `DecodeExecutor`
(MoE config, so the capacity layer runs), emitted prefill KV against JAX
`lm_prefill`, and prefill->decode serving end to end (after
tests/test_pd.py)."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, smoke_setup, t
from repro.core.decode import DecodeExecutor as JaxDecodeExecutor
from repro.core.kv import KVHandle as JaxKVHandle
from repro.core.kv import KVSpec as JaxKVSpec
from repro.core.kv import transfer_seconds as jax_transfer_seconds
from repro.models.lm import lm_prefill as jax_lm_prefill
from repro_torch.core.cost_model import H100, Hardware
from repro_torch.core.decode import DecodeExecutor, ExecDecodeEngine
from repro_torch.core.engine import ExecutorEngine, RequestResult
from repro_torch.core.executor import BatchJob, DisaggregatedExecutor
from repro_torch.core.kv import KVHandle, KVSpec, KVTransferLog, \
    transfer_seconds
from repro_torch.core.orchestrator import PDOrchestrator
from repro_torch.core.scheduler import DecodeAdmissionQueue, \
    LengthAwareBatcher
from repro_torch.core.trace import Request, TraceClock
from repro_torch.kernels.dispatch_combine.dispatch_combine import (
    combine_gather, dispatch_scatter)
from repro_torch.launch import serve
from repro_torch.models.lm import lm_forward

# ------------------------------------------------------------- KV handoff


def test_kv_spec_pricing_and_log():
    jcfg, _, cfg, _ = smoke_setup()
    bf = cfg.replace(dtype=torch.bfloat16)
    spec, jspec = KVSpec.from_config(bf), JaxKVSpec.from_config(jcfg)
    assert spec == KVSpec(jspec.num_layers, jspec.num_kv_heads,
                          jspec.head_dim, jspec.bytes_per_el)
    assert spec.token_bytes == jspec.token_bytes
    assert spec.layer_shape(7) == jspec.layer_shape(7)
    assert KVSpec.from_config(cfg).bytes_per_el == 4  # the cache's own type
    h = KVHandle(rid=0, prompt_len=1000, spec=spec, created_at=0.0)
    jh = JaxKVHandle(rid=0, prompt_len=1000, spec=jspec, created_at=0.0)
    assert h.bytes == jh.bytes == 1000 * spec.token_bytes
    hw = Hardware(name="x", ici_bw=1e9, hop_latency=1e-5)
    assert transfer_seconds(h, hw) == jax_transfer_seconds(jh, hw) \
        == pytest.approx(1e-5 + h.bytes / 1e9)
    assert H100.ici_bw == 450e9 and 0 < H100.hop_latency < 1e-3
    log = KVTransferLog()
    threads = [threading.Thread(target=lambda: [log.record(h, 0.5)
                                                for _ in range(100)])
               for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert log.count == 400 and log.bytes == 400 * h.bytes
    assert log.seconds == pytest.approx(200.0)


def test_decode_admission_queue_width_and_ready_order():
    q = DecodeAdmissionQueue(width=2)
    q.push(3.0, "late")
    q.push(1.0, "a")
    q.push(2.0, "b")
    assert q.next_ready() == 1.0
    assert q.admit(0.5) == []  # nothing ready yet
    assert q.admit(2.5) == ["a", "b"]  # ready order, capped at width
    assert q.admit(10.0) == []  # width exhausted until a release
    q.release()
    assert q.admit(10.0) == ["late"]
    q.release(2)
    assert q.active == 0 and len(q) == 0
    assert q.drain_all() == [] and q.next_ready() is None


def test_request_result_decode_properties():
    r = RequestResult(rid=0, arrival=1.0, length=8, first_token_time=2.0,
                      decomposition={})
    assert r.tpot is None and r.completion_latency == 1.0
    r.tokens_out, r.completion_time = 5, 4.0
    assert r.tpot == pytest.approx(0.5) and r.completion_latency == 3.0


# ------------------------------------------------------------ decode runtime


def _payload(rid, cfg, plen, seed=0):
    rng = np.random.default_rng(seed + rid)
    shape = (cfg.num_layers, plen, cfg.num_kv_heads, cfg.head_dim)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _handles(rid, cfg, plen):
    k, v = _payload(rid, cfg, plen)
    spec = KVSpec.from_config(cfg)
    return (KVHandle(rid=rid, prompt_len=plen, spec=spec, created_at=0.0,
                     payload=(t(k), t(v))),
            JaxKVHandle(rid=rid, prompt_len=plen,
                        spec=JaxKVSpec.from_config(cfg), created_at=0.0,
                        payload=(k, v)))


def test_decode_executor_matches_jax_decode_executor():
    """The same KV payloads and first tokens into both runtimes, several
    steps with a join and a leave in between: the caches agree at 1e-5 and
    the tokens wherever the top-2 logit gap exceeds 1e-3 (a row whose token
    differs at a near-tie is compared no further)."""
    jcfg, jparams, cfg, params = smoke_setup(num_layers=2, num_experts=8)
    rt = DecodeExecutor(params, cfg, slots=3, max_len=32)
    jrt = JaxDecodeExecutor(jparams, jcfg, slots=3, max_len=32)
    live = {0, 1}
    for slot, (rid, plen, tok) in enumerate([(0, 7, 11), (1, 12, 300)]):
        h, jh = _handles(rid, cfg, plen)
        rt.occupy(slot, h, tok)
        jrt.occupy(slot, jh, tok)
    diverged = set()
    for step in range(6):
        if step == 2:  # a join into the free slot
            h, jh = _handles(2, cfg, 4)
            rt.occupy(2, h, 5)
            jrt.occupy(2, jh, 5)
            live.add(2)
        if step == 4:  # a leave
            rt.release(0)
            jrt.release(0)
            live.discard(0)
        _, toks = rt.step_once()
        _, jtoks = jrt.step_once()
        logits = rt._logits.numpy()
        top2 = np.sort(logits, -1)[:, -2:]
        for s in sorted(live - diverged):
            if toks[s] != jtoks[s]:
                assert top2[s, 1] - top2[s, 0] <= 1e-3, (step, s)
                diverged.add(s)
        for s in sorted(live - diverged):
            close(rt._k[:, s], jrt._k[:, s], 1e-5)
            close(rt._v[:, s], jrt._v[:, s], 1e-5)
    np.testing.assert_array_equal(rt._lengths.numpy(),
                                  np.asarray(jrt._lengths))
    assert not diverged or len(diverged) < len(live)
    assert rt.trace_counts["decode_step"] == 1


def test_decode_step_probe_stays_one_across_joins_leaves_turnover():
    """More requests than slots, staggered enrollment, slot turnover: the
    step's shapes and capacity never change (the reference pins one jit
    trace here), and each decode step launches nothing on the CPU."""
    _, _, cfg, params = smoke_setup(num_layers=2, num_experts=8)
    clock = [0.0]
    rt = DecodeExecutor(params, cfg, slots=3, max_len=32,
                        clock=lambda: clock[0])
    eng = ExecDecodeEngine(rt)
    launches = (dispatch_scatter.launches, combine_gather.launches)
    for rid, (plen, steps) in enumerate([(8, 3), (5, 1), (12, 4)]):
        eng.enroll(_handles(rid, cfg, plen)[0], steps=steps, t_ready=0.0)
    done = eng.pump(max_steps=2)
    clock[0] = 1.0
    eng.enroll(_handles(3, cfg, 6)[0], steps=2, t_ready=0.5)
    eng.enroll(_handles(4, cfg, 9)[0], steps=3, t_ready=0.5)
    done += eng.pump()
    comps, leftovers = eng.drain(timeout=30.0)
    done += comps
    assert leftovers == []
    assert sorted(c.rid for c in done) == [0, 1, 2, 3, 4]
    by_rid = {c.rid: c for c in done}
    for rid, steps in [(0, 3), (1, 1), (2, 4), (3, 2), (4, 3)]:
        assert len(by_rid[rid].token_times) == steps
        assert len(by_rid[rid].tokens) == steps
        assert all(0 <= x < cfg.vocab_size for x in by_rid[rid].tokens)
    assert rt.trace_counts["decode_step"] == 1
    assert eng.load == 0
    assert (dispatch_scatter.launches, combine_gather.launches) == launches


def test_decode_engine_slot_cap_and_cache_bound():
    _, _, cfg, params = smoke_setup(num_layers=2, num_experts=8)
    eng = ExecDecodeEngine(DecodeExecutor(params, cfg, slots=2, max_len=32))
    with pytest.raises(ValueError):
        eng.enroll(_handles(0, cfg, 30)[0], steps=8, t_ready=0.0)  # > cache
    for rid in range(4):
        eng.enroll(_handles(rid, cfg, 6)[0], steps=2, t_ready=0.0)
    assert eng.load == 4
    done, leftovers = eng.drain(timeout=30.0)
    assert leftovers == [] and len(done) == 4
    assert eng.rt.trace_counts["decode_step"] == 1


# ------------------------------------------------------ prefill KV export


def test_executor_emit_kv_matches_jax_lm_prefill_caches():
    """A padded batch through the emit_kv executor: each request's
    [L, len, kvh, hd] K and V, contiguous, against the reference's
    lm_prefill caches (capacity large enough that nothing drops; the
    executor's MoE is dropless), at 5e-5."""
    jcfg, jparams, cfg, params = smoke_setup(num_experts=8)
    jcfg, cfg = (c.replace(capacity_factor=8.0) for c in (jcfg, cfg))
    lengths = [13, 5, 16]
    tokens = np.zeros((3, 16), np.int64)
    rng = np.random.RandomState(30)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.randint(0, cfg.vocab_size, n)
    ex = DisaggregatedExecutor(params, cfg, D=1, E=2, emit_kv=True,
                               device="cpu")
    job, = ex.run([[BatchJob(tokens=tokens, lengths=lengths)]])
    _, jcaches = jax_lm_prefill(jparams, jcfg, jnp.asarray(tokens))
    jk, jv = np.asarray(jcaches[0].k), np.asarray(jcaches[0].v)
    assert len(job.kv) == 3
    for i, (k, v, ready) in enumerate(job.kv):
        n = lengths[i]
        assert k.shape == (cfg.num_layers, n, cfg.num_kv_heads, cfg.head_dim)
        assert k.is_contiguous() and v.is_contiguous() and ready is None
        close(k, jk[:, i, :n], 5e-5)
        close(v, jv[:, i, :n], 5e-5)
    plain = DisaggregatedExecutor(params, cfg, D=1, E=2, device="cpu")
    job, = plain.run([[BatchJob(tokens=tokens, lengths=lengths)]])
    assert job.kv is None  # without emit_kv nothing is kept


def test_keep_kv_needs_emit_kv_and_take_kv_is_once():
    _, _, cfg, params = smoke_setup(num_layers=1, num_experts=8)
    with pytest.raises(ValueError):
        ExecutorEngine(DisaggregatedExecutor(params, cfg, D=1, E=2,
                                             device="cpu"), keep_kv=True)
    eng = ExecutorEngine(DisaggregatedExecutor(params, cfg, D=1, E=2,
                                               emit_kv=True, device="cpu"),
                         clock=TraceClock(speed=200.0), keep_kv=True)
    eng.submit(Request(rid=0, arrival=0.0, length=9))
    res, = eng.drain(timeout=120)
    h = eng.take_kv(0)
    assert res.ok and h.prompt_len == 9 and h.created_at == \
        res.first_token_time
    assert h.payload[0].shape == (1, 9, cfg.num_kv_heads, cfg.head_dim)
    with pytest.raises(KeyError):
        eng.take_kv(0)
    eng.close()


# ------------------------------------------------------------ PD end to end


def _check_pd_contract(results, reqs):
    """The extended result contract (as tests/test_pd.py states it): one
    result per request, no lost/duplicated rids, definite statuses,
    non-negative decomposition components summing to <= the completion
    latency, and the TPOT identity."""
    by_rid = {r.rid: r for r in results}
    assert sorted(by_rid) == sorted(q.rid for q in reqs)
    assert len(results) == len(by_rid)  # no duplicates
    for q in reqs:
        r = by_rid[q.rid]
        assert r.arrival == q.arrival and r.length == q.length
        assert r.status in ("ok", "timeout", "shed", "failed")
        if r.status != "ok":
            continue
        assert r.tokens_out == q.out_len
        assert r.completion_time is not None
        assert r.completion_time >= r.first_token_time >= r.arrival
        for k, v in r.decomposition.items():
            assert v >= -1e-12, (r.rid, k, v)
        assert sum(r.decomposition.values()) \
            <= r.completion_latency * (1 + 1e-6) + 1e-9
        if r.tokens_out > 1:
            assert {"kv_transfer", "decode_queue",
                    "decode"} <= r.decomposition.keys()
            assert r.tpot == pytest.approx(
                (r.completion_time - r.first_token_time) / (r.tokens_out - 1))
            assert len(r.token_times) == r.tokens_out
            assert all(b >= a for a, b in
                       zip(r.token_times, r.token_times[1:]))
        else:
            assert r.completion_time == r.first_token_time
            assert r.tpot is None


def _pd(params, cfg, reqs, prompts, colocated=False):
    ex = DisaggregatedExecutor(params, cfg, D=2, E=4, emit_kv=True,
                               device="cpu")
    clock = TraceClock(speed=200.0)
    pre = ExecutorEngine(
        ex, clock=clock, keep_kv=True,
        batcher=LengthAwareBatcher(inflection=48, max_tokens=128,
                                   exclusive_cutoff=1 << 30, max_wait=0.05))
    rt = DecodeExecutor(params, cfg, slots=3, max_len=64, clock=clock.now)
    orch = PDOrchestrator([pre], [ExecDecodeEngine(rt)], hw=H100,
                          colocated=colocated)
    try:
        for q in reqs:
            orch.submit(q, prompts[q.rid])
        results = orch.drain(timeout=300)
    finally:
        orch.close()
    return results, orch, rt


def test_pd_end_to_end_with_teacher_forced_tokens():
    """Prefill executor with emit_kv -> keep_kv engine -> KV handoff ->
    decode runtime: the extended contract, one handoff per request that
    decodes, the step probe at 1, and every token the argmax of the dense
    oracle over the prompt plus the tokens so far (dropless: T <= C)."""
    _, _, cfg, params = smoke_setup(num_experts=8)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, arrival=0.1 * i,
                    length=int(rng.choice([8, 16, 24])),
                    out_len=int(rng.integers(1, 6))) for i in range(6)]
    prompts = {q.rid: rng.integers(0, cfg.vocab_size, q.length)
               for q in reqs}
    results, orch, rt = _pd(params, cfg, reqs, prompts)
    _check_pd_contract(results, reqs)
    assert all(r.status == "ok" for r in results)
    assert orch.kv_log.count == sum(1 for q in reqs if q.out_len > 1)
    assert orch.kv_log.bytes == sum(q.length for q in reqs if q.out_len > 1) \
        * KVSpec.from_config(cfg).token_bytes
    assert rt.trace_counts["decode_step"] == 1
    assert orch.stats().engine == "pd:executor"
    for r in results:
        assert len(r.output_tokens) == r.tokens_out
        seq = list(prompts[r.rid])
        for tok in r.output_tokens:
            logits, _ = lm_forward(params, cfg, torch.tensor([seq]),
                                   moe_mode="dense")
            last = logits[0, -1]
            top2 = torch.topk(last, 2).values
            if float(top2[0] - top2[1]) > 1e-3:
                assert tok == int(torch.argmax(last)), (r.rid, len(seq))
            else:
                assert float(last.max() - last[tok]) <= 1e-4
            seq.append(tok)


def test_pd_colocated_baseline_has_no_handoff():
    _, _, cfg, params = smoke_setup(num_experts=8)
    reqs = [Request(rid=i, arrival=0.1 * i, length=16, out_len=3)
            for i in range(3)]
    prompts = {q.rid: np.arange(16) + q.rid for q in reqs}
    results, orch, _ = _pd(params, cfg, reqs, prompts, colocated=True)
    _check_pd_contract(results, reqs)
    assert all(r.status == "ok" for r in results)
    assert orch.kv_log.count == 0  # colocated: nothing crosses the link
    for r in results:
        assert r.decomposition["kv_transfer"] == 0.0


def test_serve_main_pd_smoke_on_cpu(tmp_path, capsys):
    stats = tmp_path / "pd.json"
    assert serve.main(["--mode", "pd", "--smoke", "--device", "cpu",
                       "--requests", "4", "--time-scale", "50",
                       "--save-stats", str(stats)]) == 0
    out = capsys.readouterr().out
    assert "kv handoffs:" in out and "1 step signature(s)" in out
    import json
    st = json.loads(stats.read_text())
    assert st["completed_ok"] == 4
    assert st["tokens_out"] == st["expected_tokens"]


@pytest.mark.parametrize("argv", [
    ["--out-len-mean", "4"], ["--decode-width", "2"], ["--colocated"],
    ["--mode", "pd", "--out-len-mean", "0.5"],
    ["--mode", "pd", "--decode-width", "0"],
    ["--engine", "sim"]])
def test_serve_pd_flag_validation(argv):
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu"] + argv)
