"""Cross-region continuous batching in the port's executor (CPU, kernels'
plain versions), ported from tests/test_moe_batching.py: the batcher merges
regions of many attention groups into ONE capacity buffer and ONE Super
Kernel launch per distinct layer.  Pinned here: bit-equality with the
per-region path and the JAX dense reference at 5e-5, window 0 being the
per-region path, the row cap, the per-expert counts a merged launch hands
the kernel, no new capacity bucket after prewarm, the engine's telemetry and
serve's flag validation."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import smoke_setup
from repro.models.lm import lm_backbone as jax_lm_backbone
from repro_torch.core import executor as executor_mod
from repro_torch.core.cost_model import Placement
from repro_torch.core.engine import ExecutorEngine
from repro_torch.core.executor import BatchJob, DisaggregatedExecutor
from repro_torch.core.scheduler import LengthAwareBatcher
from repro_torch.core.trace import Request, TraceClock
from repro_torch.launch import serve


def _setup(num_layers=3):
    return smoke_setup(num_layers=num_layers, num_experts=8, top_k=2)


def _jobs(cfg, n, B=1, S=8, seed=0):
    return [BatchJob(tokens=np.random.RandomState(seed + i).randint(
        0, cfg.vocab_size, (B, S)), bid=i) for i in range(n)]


def _fresh(jobs, D):
    return [[BatchJob(tokens=j.tokens, bid=j.bid) for j in jobs[g::D]]
            for g in range(D)]


def _check(done, jparams, jcfg, tol=5e-5):
    for j in done:
        ref, _ = jax_lm_backbone(jparams, jcfg, jnp.asarray(j.tokens),
                                 moe_mode="dense")
        np.testing.assert_allclose(j.result.numpy(), np.asarray(ref),
                                   rtol=tol, atol=tol)


def _ex(params, cfg, **kw):
    return DisaggregatedExecutor(params, cfg, device="cpu", **kw)


def _by_bid(done):
    return sorted(done, key=lambda j: j.bid)


def _launches(ex):
    """(counts, regions) of every logged Super Kernel launch."""
    return [(ev[4], ev[5]) for ev in ex.log if ev[0] == "launch"]


@pytest.mark.parametrize("policy", ["round_robin", "greedy_balanced",
                                    "replicated(2)"])
def test_batched_bitwise_equals_per_region_all_placements(policy):
    """Merging regions into one capacity buffer changes WHERE each row
    sits, never its reduction order: batched == per-region bit for bit,
    replica fan-out included, and both at 5e-5 of the JAX dense model."""
    jcfg, jparams, cfg, params = _setup()
    D, E = 4, 2
    jobs = _jobs(cfg, 8, seed=17)
    pl = Placement.parse(policy)
    ex0 = _ex(params, cfg, D=D, E=E, placement=pl)
    ex1 = _ex(params, cfg, D=D, E=E, placement=pl, moe_batch_window=0.02)
    ex1.prewarm_buckets(D * 8 * cfg.top_k)
    done0, done1 = ex0.run(_fresh(jobs, D)), ex1.run(_fresh(jobs, D))
    for a, b in zip(_by_bid(done0), _by_bid(done1)):
        assert torch.equal(a.result, b.result), (a.bid, policy)
    _check(done0, jparams, jcfg)
    _check(done1, jparams, jcfg)
    # the batcher really merged (else this test pins nothing)
    assert ex1.moe_launch_regions.sum() > ex1.moe_launches.sum()
    assert ex0.moe_launch_regions.sum() == ex0.moe_launches.sum()


def test_window_zero_is_exactly_the_per_region_path():
    """--moe-batch-window 0 is the per-region worker: bit-equal outputs and
    one region per launch."""
    _, _, cfg, params = _setup()
    D, E = 2, 2
    jobs = _jobs(cfg, 4, seed=29)
    exd = _ex(params, cfg, D=D, E=E)
    ex0 = _ex(params, cfg, D=D, E=E, moe_batch_window=0.0)
    dd, d0 = exd.run(_fresh(jobs, D)), ex0.run(_fresh(jobs, D))
    for a, b in zip(_by_bid(dd), _by_bid(d0)):
        assert torch.equal(a.result, b.result)
    assert ex0.moe_launches.sum() == ex0.moe_launch_regions.sum() > 0
    assert all(n == 1 for _, n in _launches(ex0))


@pytest.mark.parametrize("kw,match", [
    (dict(moe_path="eager", moe_batch_window=0.01), "fused"),
    (dict(moe_batch_window=0.01, moe_batch_max_tokens=0), "max_tokens"),
    (dict(moe_batch_window=-0.01), "window")])
def test_constructor_rejects_bad_batching(kw, match):
    _, _, cfg, params = _setup(num_layers=1)
    with pytest.raises(ValueError, match=match):
        _ex(params, cfg, D=1, E=2, **kw)


def test_moe_batch_max_tokens_bounds_each_merge():
    """The row cap closes a drain early: no merged launch of several regions
    exceeds `moe_batch_max_tokens` rows (one region alone may)."""
    jcfg, jparams, cfg, params = _setup()
    D, E, S = 4, 1, 8
    cap = S * cfg.top_k + 1  # one region carries S * top_k rows
    ex = _ex(params, cfg, D=D, E=E, moe_batch_window=0.05,
             moe_batch_max_tokens=cap)
    ex.prewarm_buckets(D * S * cfg.top_k)
    done = ex.run(_fresh(_jobs(cfg, 8, S=S, seed=31), D))
    _check(done, jparams, jcfg)
    launches = _launches(ex)
    assert launches
    for counts, regions in launches:
        assert regions == 1 or sum(counts) <= cap, (counts, regions)
    assert ex.moe_launch_regions.sum() <= 2 * ex.moe_launches.sum()


def test_merged_launch_hands_the_kernel_the_sum_of_its_regions_counts(
        monkeypatch):
    """A merged launch's per-expert counts (device data the kernel skips
    padding by) are the sum of its regions' dispatch counts, not one
    region's; the telemetry logs the same counts."""
    jcfg, jparams, cfg, params = _setup()
    D = 4
    ex = _ex(params, cfg, D=D, E=1, moe_batch_window=0.05)
    n_e = len(ex.dev_experts[0])
    ex.prewarm_buckets(D * 8 * cfg.top_k)
    regions, kernel = [], []  # one MoE worker (E=1): calls in order
    multi = ex._expert_ffn_fused_multi

    def spy_multi(e, layer, row_lists, eid_list):
        regions.append(([rows[0].counts for rows in row_lists],
                        np.bincount(np.concatenate(eid_list),
                                    minlength=n_e)))
        return multi(e, layer, row_lists, eid_list)

    ffn = executor_mod.super_moe_ffn

    def spy_ffn(lid, res, xb, cfg_, counts=None):
        kernel.append(counts.clone())
        return ffn(lid, res, xb, cfg_, counts)

    ex._expert_ffn_fused_multi = spy_multi
    monkeypatch.setattr(executor_mod, "super_moe_ffn", spy_ffn)
    done = ex.run(_fresh(_jobs(cfg, 8, seed=43), D))
    _check(done, jparams, jcfg)
    launches = _launches(ex)
    assert len(regions) == len(kernel) == len(launches) > 0
    assert any(len(per) > 1 for per, _ in regions), "nothing was merged"
    for (per, merged), got, (logged, n) in zip(regions, kernel, launches):
        assert got.dtype == torch.int32 and n == len(per)
        np.testing.assert_array_equal(got.numpy(), np.sum(per, 0))
        np.testing.assert_array_equal(got.numpy(), merged)
        assert tuple(got.tolist()) == logged


def test_no_new_capacity_bucket_after_prewarm_batched():
    """Merged drains reach data-dependent buckets; prewarmed to the merged
    bound (D regions x S tokens x top_k rows), no launch finds a new one."""
    jcfg, jparams, cfg, params = _setup(num_layers=4)
    D, S = 4, 8
    ex = _ex(params, cfg, D=D, E=2, moe_batch_window=0.02)
    ex.prewarm_buckets(D * S * cfg.top_k)
    jobs = _jobs(cfg, 8, S=S, seed=37)
    ex.run(_fresh(jobs, D))
    done = ex.run(_fresh(jobs, D))
    assert ex.bucket_misses.sum() == 0
    assert ex.bucket_hits.sum() == ex.moe_launches.sum() > 0
    _check(done, jparams, jcfg)


def test_engine_stats_expose_batching_telemetry():
    _, _, cfg, params = _setup(num_layers=2)
    ex = _ex(params, cfg, D=2, E=2, moe_batch_window=0.02)
    eng = ExecutorEngine(
        ex, clock=TraceClock(speed=50.0),
        batcher=LengthAwareBatcher(inflection=48, max_tokens=128,
                                   exclusive_cutoff=1 << 30, max_wait=0.05))
    reqs = [Request(rid=i, arrival=i * 0.05, length=8) for i in range(4)]
    eng.submit_all(reqs)
    eng.drain(timeout=300)
    st = eng.stats()
    eng.close()
    assert st.moe_launches > 0
    assert st.moe_batch_regions >= st.moe_launches
    assert st.regions_per_launch() >= 1.0
    assert 0.0 < st.moe_batch_occupancy <= 1.0
    assert st.bucket_hits + st.bucket_misses == st.moe_launches


def test_serve_requests_batched_prewarms_the_merged_bound():
    """serve's batched executor prewarms to the merged bound: every launch
    of the wave lands in a seen bucket."""
    _, _, cfg, params = _setup(num_layers=2)
    assert serve.prewarm_rows(128, 4, 0.0, None) == 64
    assert serve.prewarm_rows(128, 4, 0.01, None) == 4 * 64
    assert serve.prewarm_rows(128, 4, 0.01, 16) == 64
    assert serve.prewarm_rows(128, 4, 0.01, 4096) == 4096
    out = serve.serve_requests(cfg, params, lengths=[8, 16, 24, 32, 40, 48],
                               rps=200.0, time_scale=20.0, device="cpu",
                               D=4, E=2, max_batch_tokens=128,
                               moe_batch_window=0.02)
    st = out["stats"]
    assert len(out["results"]) == 6 and all(r.ok for r in out["results"])
    assert st.moe_launches > 0 and st.bucket_misses == 0


@pytest.mark.parametrize("argv,needle", [
    (["--moe-path", "eager", "--moe-batch-window", "0.01"],
     "--moe-batch-window requires --moe-path fused"),
    (["--moe-batch-max-tokens", "64"], "requires --moe-batch-window > 0"),
    (["--moe-batch-window", "0.01", "--moe-batch-max-tokens", "0"],
     "--moe-batch-max-tokens must be >= 1"),
    (["--moe-batch-window", "-0.5"], "--moe-batch-window must be >= 0"),
    (["--mode", "pd", "--moe-path", "eager"], "not supported with --mode pd"),
    (["--moe-kernel", "ref"], "unrecognized arguments: --moe-kernel")])
def test_serve_cli_rejects_bad_moe_flags(argv, needle, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--device", "cpu", "--smoke"] + argv)
    assert e.value.code == 2
    assert needle in capsys.readouterr().err
