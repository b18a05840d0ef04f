"""`correct` comes out true for the unbroken program and false under the
control and under each fault the cells can have, with the cells' own
limits.  The whole harness runs on the CPU at a small size; only the look
for a card is skipped."""
import numpy as np
import pytest

from perfbench import check, weights
from perfbench.tests import smoke

from perfbench import manifest

CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_unbroken_program_is_correct(workload):
    result, checks, rec, _ = smoke.run(workload)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(checks) == list(smoke.small_plan(workload).limits)


def _state_unchanged(monkeypatch):
    """The MoE step returns the hidden state it was given."""
    from repro_torch.core.executor import DisaggregatedExecutor
    orig = DisaggregatedExecutor._combine

    def combine(self, g, slot, h, xf, weights_, shared):
        orig(self, g, slot, h, xf, weights_, shared)
        return h
    monkeypatch.setattr(DisaggregatedExecutor, "_combine", combine)


def _half_left_out(monkeypatch):
    """The second half of each batch's tokens keeps no MoE output."""
    from repro_torch.core.executor import DisaggregatedExecutor
    orig = DisaggregatedExecutor._combine

    def combine(self, g, slot, h, xf, weights_, shared):
        out = orig(self, g, slot, h, xf, weights_, shared)
        flat, hf = out.reshape(-1, out.shape[-1]), h.reshape(-1, h.shape[-1])
        n = flat.shape[0]
        flat[n // 2:] = hf[n // 2:]
        return out
    monkeypatch.setattr(DisaggregatedExecutor, "_combine", combine)


def _exchange_left_out(monkeypatch):
    """One MoE device's answers never reach the combine."""
    from repro_torch.core import async_primitives as ap
    orig = ap.AttnDeviceBuffer.combine_recv

    def recv(self, *a, **k):
        got = orig(self, *a, **k)
        return [p for i, p in enumerate(got) if i != 1]
    monkeypatch.setattr(ap.AttnDeviceBuffer, "combine_recv", recv)


def _token_altered(monkeypatch):
    """The first token is another than the logits' best."""
    from repro_torch.core import engine
    orig = engine.lm_head
    monkeypatch.setattr(engine, "lm_head",
                        lambda p, h, c: orig(p, h, c).roll(1, dims=-1))


FAULTS = {"state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out,
          "exchange_left_out": _exchange_left_out,
          "token_altered": _token_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, checks, _, _ = smoke.run(workload)
    assert not result["correct"], (fault, checks)


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """The reference in float8 in the program's place, on the cell's own
    limits; the reference itself in the program's place is correct."""
    plan = smoke.small_plan(workload)
    m = smoke.small_model(plan)
    params = weights.make_params(m, 9, "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, m["vocab_size"], 32, dtype=np.int32)
               for _ in range(4)]
    ref_rows = check.reference_rows(m, params, prompts, "cpu")
    ok, checks = check.judge(
        check.control_numbers(m, params, prompts, ref_rows, "cpu"),
        plan.limits)
    assert not ok, checks
    best = check.ref.logits(params, ref_rows).argmax(-1).tolist()
    assert check.judge(check.numbers(params, ref_rows, best, ref_rows),
                       plan.limits)[0]
