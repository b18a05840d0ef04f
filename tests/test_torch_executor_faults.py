"""Supervised failover in the port's executor (CPU, kernels' plain versions),
after tests/test_executor_faults.py and tests/test_moe_batching.py: a MoE
device crashed, stalled, delayed or losing a payload mid-wave; the fence,
the exactly-once orphan re-serve and the evacuation through the live
re-placement swap; `apply_placement` without a fault; and the one
deliberate difference from the reference, that a CUDA error panics and is
never failed over.  Every arm's outputs are torch.equal to the fault-free
wave's, whose outputs are within 5e-5 of JAX lm_backbone(moe_mode="dense").
"""
import contextlib
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import smoke_setup
from repro.analysis import lockdep
from repro_torch.analysis import lockdep as port_lockdep
from repro.core.cost_model import Placement as JaxPlacement
from repro.models.lm import lm_backbone as jax_lm_backbone
from repro_torch.core import executor as executor_mod
from repro_torch.core.cost_model import Placement
from repro_torch.core.executor import BatchJob, DisaggregatedExecutor
from repro_torch.core.faults import FaultEvent, FaultPlan, InjectedFault

D, E, L, N_EXPERTS = 2, 4, 2, 8
TIMEOUT = 60.0  # a hang fails the test, well inside the suite's clock


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, port params, 8 token blocks, the
    fault-free round-robin outputs by bid)."""
    jcfg, jparams, cfg, params = smoke_setup(num_layers=L,
                                             num_experts=N_EXPERTS, top_k=2)
    tokens = [np.random.RandomState(100 + i).randint(0, cfg.vocab_size,
                                                     (1, 16))
              for i in range(8)]
    ex = DisaggregatedExecutor(params, cfg, D=D, E=E, device="cpu")
    ref = {j.bid: j.result for j in ex.run(_pinned(tokens), timeout=TIMEOUT)}
    for i, tok in enumerate(tokens):
        want, _ = jax_lm_backbone(jparams, jcfg, jnp.asarray(tok),
                                  moe_mode="dense")
        np.testing.assert_allclose(ref[i].numpy(), np.asarray(want),
                                   rtol=5e-5, atol=5e-5)
    return jcfg, jparams, cfg, params, tokens, ref


def _pinned(tokens):
    return [[BatchJob(tokens=tokens[i], bid=i)
             for i in range(g, len(tokens), D)] for g in range(D)]


def _ex(model, **kw):
    return DisaggregatedExecutor(model[3], model[2], D=D, E=E, device="cpu",
                                 **kw)


def _events(ex, kind):
    with ex._log_lock:
        return [ev for ev in ex.log if ev[0] == kind]


def _run_during(ex, tokens, action, after_combines=1):
    """run() the pinned wave on a thread; once `after_combines` batch-layers
    have combined (the wave is under way), call `action()` here; return the
    wave's jobs."""
    out = {}

    def wave():
        try:
            out["done"] = ex.run(_pinned(tokens), timeout=TIMEOUT)
        except BaseException as exc:  # re-raised on the test thread
            out["error"] = exc

    th = threading.Thread(target=wave)
    th.start()
    deadline = time.monotonic() + TIMEOUT
    while len(_events(ex, "combine")) < after_combines and th.is_alive():
        assert time.monotonic() < deadline, "the wave never started"
        time.sleep(0.001)
    action()
    th.join(TIMEOUT)
    assert not th.is_alive(), "the wave did not finish"
    if "error" in out:
        raise out["error"]
    return out["done"]


def _same(done, ref):
    assert len(done) == len(ref)
    for j in done:
        assert j.failed is None, j.failed
        assert torch.equal(j.result, ref[j.bid]), j.bid


def _crash(ex, device=1):
    ex.arm_faults(FaultPlan([FaultEvent(t=0.0, kind="crash_moe",
                                        device=device)]))


@pytest.mark.parametrize("window,sanitizer", [
    pytest.param(0.0, None, id="0.0-False"),
    pytest.param(0.02, None, id="0.02-False"),
    pytest.param(0.0, lockdep, id="0.0-True"),
    pytest.param(0.02, lockdep, id="0.02-True"),
    pytest.param(0.0, port_lockdep, id="0.0-port"),
    pytest.param(0.02, port_lockdep, id="0.02-port")])
def test_crash_mid_wave_fails_over_exactly_once(model, window, sanitizer):
    """A crash of MoE device 1 once the wave is under way: every pinned job
    completes torch.equal to the fault-free run (per-region and batched),
    with one failover, device 1 dead, the reference's post-failover table,
    and one "failover" migration whose bytes are the 2 experts device 1
    held, over every layer.  With a `sanitizer` (the reference's lockdep,
    or the port's own) it wraps every lock the executor creates."""
    ctx = sanitizer.lockdep_active(raise_on_violation=True) if sanitizer \
        else contextlib.nullcontext()
    for ld in (lockdep, port_lockdep):
        ld.reset()
    with ctx:
        ex = _ex(model, moe_batch_window=window, region_timeout=3.0)
        done = _run_during(ex, model[4], lambda: _crash(ex))
        if sanitizer:
            assert sanitizer.violations() == []
            assert sanitizer.learned_edges()  # it saw the executor's locks
    for ld in (lockdep, port_lockdep):
        ld.reset()
    _same(done, model[5])
    assert ex.failovers == 1 and not ex.errors
    assert ex.placement.dead == (1,)
    fr = JaxPlacement.uniform_fractions(N_EXPERTS)
    assert ex.table == JaxPlacement().fail(1).table(fr, E)
    assert len(ex.dev_experts[1]) == 0 and ex.resident[1] is None
    recs = [r for r in ex.migrations if r["kind"] == "failover"]
    assert len(recs) == 1
    assert recs[0]["bytes"] == 2 * L * ex.expert_copy_bytes
    # the survivors' stacks stop being progressions: gathered copies of
    # whole experts, at least the gained ones
    unit = L * ex.expert_copy_bytes
    assert recs[0]["copy_bytes"] >= recs[0]["bytes"]
    assert recs[0]["copy_bytes"] % unit == 0
    cfg = model[2]
    assert ex.expert_copy_bytes == 3 * cfg.d_model * cfg.expert_d_ff * 4
    assert [ev[1:3] for ev in _events(ex, "failover")] == [(1, "died")]


@pytest.mark.parametrize("window", [0.0, 0.02])
def test_orphans_taken_but_not_combined_are_served_once(model, window,
                                                        monkeypatch):
    """Device 1's worker dies INSIDE its FFN, after the take published the
    region(s): every region it held is re-served by the supervisor exactly
    once, and over the wave device 1 answers each batch-layer exactly once
    (worker serves + supervisor serves == combines)."""
    real = DisaggregatedExecutor._expert_ffn_fused_multi
    held, calls = [], []

    def ffn(self, e, layer, row_lists, eid_list):
        if threading.current_thread().name == "moe-1" and not held:
            calls.append(1)
            if len(calls) == 2:  # mid-wave, with its regions taken
                held.append(tuple(rows[0] for _, rows
                                  in self._moe_current[1]))
                raise InjectedFault("dies inside the Super Kernel call")
        return real(self, e, layer, row_lists, eid_list)

    served = []
    real_serve = DisaggregatedExecutor._serve_region

    def serve_region(self, e, i, rows):
        served.append((e, rows[0]))
        return real_serve(self, e, i, rows)

    monkeypatch.setattr(DisaggregatedExecutor, "_expert_ffn_fused_multi",
                        ffn)
    monkeypatch.setattr(DisaggregatedExecutor, "_serve_region",
                        serve_region)
    ex = _ex(model, moe_batch_window=window, region_timeout=3.0)
    done = ex.run(_pinned(model[4]), timeout=TIMEOUT)
    _same(done, model[5])
    assert ex.failovers == 1 and held and held[0]
    for payload in held[0]:  # each orphan once, on the supervisor's path
        assert sum(p is payload for _, p in served) == 1
    assert {e for e, _ in served} == {1}
    n_worker = sum(1 for ev in _events(ex, "moe") if ev[1] == 1)
    n_sup = len(_events(ex, "moe-failover"))
    assert n_sup == len(served)
    assert n_worker + n_sup == len(_events(ex, "combine"))


def test_stall_escalates_to_failover(model):
    """A wedged (not dead) worker: no heartbeat past stall_timeout while
    work is pending escalates to the same failover; the fenced worker is
    retired and joined at close."""
    ex = _ex(model, stall_timeout=1.0, region_timeout=3.0)
    ex.arm_faults(FaultPlan([FaultEvent(t=0.0, kind="stall_moe", device=0,
                                        duration=1e9)]))
    done = ex.run(_pinned(model[4]), timeout=TIMEOUT)
    _same(done, model[5])
    assert ex.failovers == 1 and ex.placement.dead == (0,)
    assert [ev[1:3] for ev in _events(ex, "failover")] == [(0, "stalled")]
    assert ex._retired == []  # joined by run()'s close


def test_delay_with_heartbeats_is_benign(model):
    """delay_wake keeps heartbeating: the supervisor must NOT fail over."""
    ex = _ex(model, stall_timeout=1.0)
    ex.arm_faults(FaultPlan([FaultEvent(t=0.0, kind="delay_wake", device=0,
                                        duration=1.5)]))
    done = ex.run(_pinned(model[4]), timeout=TIMEOUT)
    _same(done, model[5])
    assert ex.failovers == 0 and ex.placement.dead == ()
    assert [ev.kind for ev in ex.fault_injector.fired_events()] == \
        ["delay_wake"]


@pytest.mark.parametrize("kind", ["drop_dispatch", "drop_combine"])
def test_dropped_payload_replays_idempotently(model, kind):
    """A dropped dispatch/combine: the region times out, the lane is
    scrubbed and the batch replays from layer 0 -- outputs unchanged, one
    result per job, the replay recorded."""
    ex = _ex(model, region_timeout=2.0)
    ex.arm_faults(FaultPlan([FaultEvent(t=0.0, kind=kind, device=0)]))
    done = ex.run(_pinned(model[4]), timeout=TIMEOUT)
    _same(done, model[5])
    assert any(j.retries >= 1 for j in done)
    assert [ev.kind for ev in ex.fault_injector.fired_events()] == [kind]
    assert len(_events(ex, "scrub")) >= 1 and ex.failovers == 0


def test_replay_budget_exhausted_fails_the_job(model):
    """Past max_job_retries a job ends terminally: failed set, result
    None, and the wave still returns."""
    ex = _ex(model, region_timeout=0.5, max_job_retries=0)
    ex.arm_faults(FaultPlan([FaultEvent(t=0.0, kind="drop_combine",
                                        device=0)]))
    done = ex.run(_pinned(model[4]), timeout=TIMEOUT)
    failed = [j for j in done if j.failed is not None]
    assert len(failed) == 1 and failed[0].result is None
    for j in done:
        if j.failed is None:
            assert torch.equal(j.result, model[5][j.bid])


def _expected_record(ex_table, target, fr, copy_bytes):
    """The reference's migration formula on the reference's tables."""
    old, new = ex_table, target.table(fr, E)
    old_dev = [[x for x in range(N_EXPERTS) if d in old[x]]
               for d in range(E)]
    new_dev = [[x for x in range(N_EXPERTS) if d in new[x]]
               for d in range(E)]
    moved = [(x, d) for x, hosts in enumerate(new) for d in hosts
             if d not in old[x]]
    affected = tuple(d for d in range(E) if new_dev[d] != old_dev[d])
    gained = sum(len([x for x in new_dev[d] if x not in old_dev[d]])
                 for d in affected)
    return {"moved_copies": len(moved), "devices": affected,
            "bytes": copy_bytes * L * gained}


def test_apply_placement_between_waves_and_mid_wave(model):
    """Live re-placement without a fault: greedy_balanced (at skewed
    fractions, so the layout moves) and replicated(2) between waves, then
    back to round-robin mid-wave.  Outputs torch.equal to the round-robin
    run, and each record's fields follow the reference's formula."""
    ex = _ex(model)
    skew = tuple(np.linspace(2.0, 1.0, N_EXPERTS) / np.linspace(
        2.0, 1.0, N_EXPERTS).sum())
    _same(ex.run(_pinned(model[4]), timeout=TIMEOUT), model[5])
    steps = [("greedy_balanced", skew), ("replicated(2)", skew)]
    for policy, fr in steps:
        want = _expected_record(ex.table, JaxPlacement.parse(policy), fr,
                                ex.expert_copy_bytes)
        rec = ex.apply_placement(Placement.parse(policy),
                                 expert_fractions=fr)
        assert rec["kind"] == "rebalance"
        assert rec["policy"] == Placement.parse(policy).policy
        assert {k: rec[k] for k in want} == want and rec["moved_copies"] > 0
        assert ex.table == JaxPlacement.parse(policy).table(fr, E)
        _same(ex.run(_pinned(model[4]), timeout=TIMEOUT), model[5])
    assert ex._replicated  # replicated(2) really fans a hot expert out
    recs = []
    done = _run_during(ex, model[4], lambda: recs.append(
        ex.apply_placement(Placement())), after_combines=2)
    _same(done, model[5])
    assert recs[0]["devices"] and ex.placement == Placement()
    assert ex.migrated_bytes == sum(r["bytes"] for r in ex.migrations)


@pytest.mark.parametrize("make", [
    lambda: torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered"),
    lambda: RuntimeError("CUDA error: unspecified launch failure"),
    lambda: InjectedFault("a host-side crash")],
    ids=["accelerator_error", "cuda_runtime_error", "injected"])
def test_cuda_error_panics_host_fault_fails_over(model, monkeypatch, make):
    """The E devices share one CUDA context: a CUDA error in a MoE worker
    panics the executor (errors set, no failover, run raises); a host-side
    fault fails the device over and the wave completes."""
    real = executor_mod.super_moe_ffn
    fired = []

    def ffn(*a, **kw):
        if threading.current_thread().name == "moe-1" and not fired:
            fired.append(1)
            raise make()
        return real(*a, **kw)

    monkeypatch.setattr(executor_mod, "super_moe_ffn", ffn)
    ex = _ex(model, region_timeout=3.0)
    exc = make()
    if isinstance(exc, InjectedFault):
        _same(ex.run(_pinned(model[4]), timeout=TIMEOUT), model[5])
        assert ex.failovers == 1 and not ex.errors
        return
    with pytest.raises(RuntimeError) as ei:
        ex.run(_pinned(model[4]), timeout=TIMEOUT)
    assert type(ei.value.__cause__) is type(exc)
    assert ex.errors and ex.failovers == 0 and ex.placement.dead == ()
    ex.close()


def test_restart_budget_exhausted_panics(model):
    """With no restarts left, a death is no longer served around: the
    supervisor panics with the worker's own failure as the cause."""
    ex = _ex(model, max_worker_restarts=0)
    _crash(ex)
    with pytest.raises(RuntimeError) as ei:
        ex.run(_pinned(model[4]), timeout=TIMEOUT)
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert isinstance(ei.value.__cause__.__cause__, InjectedFault)
    assert ex.failovers == 0
    ex.close()
