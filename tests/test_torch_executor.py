"""The port's threaded disaggregated executor (CPU, kernels' plain versions)
vs the JAX `lm_backbone(moe_mode="dense")` on the same bridged params:
asynchrony, placement and fusion must not change the math."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import smoke_setup
from repro.models.lm import lm_backbone as jax_lm_backbone
from repro_torch.core.cost_model import Placement
from repro_torch.core.executor import BatchJob, DisaggregatedExecutor
from repro_torch.kernels import _launch
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.super_gmm.super_gmm import super_gmm


def _jobs(cfg, n, B=2, S=8, seed=0):
    return [BatchJob(tokens=np.random.RandomState(seed + i).randint(
        0, cfg.vocab_size, (B, S)), bid=i) for i in range(n)]


def _check(done, jparams, jcfg, tol=5e-5):
    """5e-5 in fp32: the pipeline sums the same products as the dense
    reference in another order (per-expert capacity buffers, top-k combine
    in k order), nothing else differs."""
    for j in done:
        assert isinstance(j.result, torch.Tensor)
        ref, _ = jax_lm_backbone(jparams, jcfg, jnp.asarray(j.tokens),
                                 moe_mode="dense")
        np.testing.assert_allclose(j.result.numpy(), np.asarray(ref),
                                   rtol=tol, atol=tol)


def _ex(params, cfg, **kw):
    return DisaggregatedExecutor(params, cfg, device="cpu", **kw)


def test_async_pipeline_equals_jax_dense_reference():
    jcfg, jparams, cfg, params = smoke_setup()
    jobs = _jobs(cfg, 4)
    done = _ex(params, cfg, D=2, E=4).run([jobs[:2], jobs[2:]])
    _check(done, jparams, jcfg)
    for j in done:
        assert j.t_finished is not None and j.kernel_time > 0


def test_dual_batch_interleaving_off():
    jcfg, jparams, cfg, params = smoke_setup()
    jobs = _jobs(cfg, 2, seed=5)
    done = _ex(params, cfg, D=1, E=2, interleave=False).run([jobs])
    _check(done, jparams, jcfg)


def test_tp_rows_protocol():
    jcfg, jparams, cfg, params = smoke_setup()
    jobs = _jobs(cfg, 2, seed=9)
    done = _ex(params, cfg, D=2, E=2, T=2).run([jobs[:1], jobs[1:]])
    _check(done, jparams, jcfg)


@pytest.mark.parametrize("on_attention", [True, False])
def test_shared_expert(on_attention):
    jcfg, jparams, cfg, params = smoke_setup(shared=1)
    jobs = _jobs(cfg, 2, seed=11)
    ex = _ex(params, cfg, D=1, E=2, shared_on_attention=on_attention)
    if on_attention:
        _check(ex.run([jobs]), jparams, jcfg)
    else:  # the routed experts alone: differs from the full model
        done = ex.run([jobs])
        ref, _ = jax_lm_backbone(jparams, jcfg, jnp.asarray(done[0].tokens),
                                 moe_mode="dense")
        assert np.abs(done[0].result.numpy() - np.asarray(ref)).max() > 1e-3


@pytest.mark.parametrize("policy", ["round_robin", "greedy_balanced",
                                    "replicated(2)"])
def test_fused_hot_path_contract_all_placements(policy):
    """The fused super-kernel path must preserve the dense-reference math
    under every placement policy (replica fan-out included)."""
    jcfg, jparams, cfg, params = smoke_setup(num_experts=8)
    jobs = _jobs(cfg, 2, seed=21)
    ex = _ex(params, cfg, D=2, E=4, placement=Placement.parse(policy))
    done = ex.run([jobs[:1], jobs[1:]])
    _check(done, jparams, jcfg)
    if policy.startswith("replicated"):
        assert ex._replicated, "no expert was replicated"


def test_more_devices_than_experts_launches_nothing_on_empty_devices():
    """A device that hosts no expert keeps no resident stack, only ever sees
    empty regions, and never launches."""
    jcfg, jparams, cfg, params = smoke_setup(num_experts=2, top_k=2)
    jobs = _jobs(cfg, 2, seed=31)
    ex = _ex(params, cfg, D=1, E=4)
    assert [r is None for r in ex.resident] == [False, False, True, True]
    _check(ex.run([jobs]), jparams, jcfg)
    assert ex.moe_launches[2] == ex.moe_launches[3] == 0
    assert ex.moe_launches[0] > 0


def test_launch_counts_and_bucket_hits_after_prewarm():
    jcfg, jparams, cfg, params = smoke_setup(num_experts=8)
    ex = _ex(params, cfg, D=2, E=4)
    ex.prewarm_buckets(64)
    assert all(seen == {8, 16, 32, 64} for seen in ex._seen_buckets)
    jobs = _jobs(cfg, 4, seed=41)
    done = ex.run([jobs[:2], jobs[2:]])
    _check(done, jparams, jcfg)
    # one launch per non-empty (job, layer, device) region, every one of them
    # in a pre-warmed bucket
    nonempty = sum(1 for ev in ex.log if ev[0] == "moe" and ev[5] > 0)
    assert int(ex.moe_launches.sum()) == nonempty > 0
    assert int(ex.moe_launch_regions.sum()) == nonempty
    assert int(ex.bucket_hits.sum()) == nonempty
    assert int(ex.bucket_misses.sum()) == 0
    assert ex.moe_launch_rows.sum() == 4 * cfg.num_layers * 16 * cfg.top_k
    # every batch-layer was dispatched to all E devices and combined once
    combines = [ev for ev in ex.log if ev[0] == "combine"]
    assert len(combines) == 4 * cfg.num_layers


def test_cpu_run_counts_no_kernel_launch_and_no_host_sync():
    """On the CPU the wrappers take their plain versions: the launch counts
    (kernel launches only) and the host-sync count stay untouched."""
    _, _, cfg, params = smoke_setup()
    g0, f0 = super_gmm.launches, flash_attention.launches
    _launch.reset_host_syncs()
    _ex(params, cfg, D=1, E=2).run([_jobs(cfg, 1, seed=51)])
    assert (super_gmm.launches, flash_attention.launches) == (g0, f0)
    assert _launch.reset_host_syncs() == 0


def test_executor_is_restartable_and_reports_worker_failure():
    jcfg, jparams, cfg, params = smoke_setup()
    ex = _ex(params, cfg, D=1, E=2)
    _check(ex.run([_jobs(cfg, 1, seed=61)]), jparams, jcfg)
    _check(ex.run([_jobs(cfg, 1, seed=62)]), jparams, jcfg)  # warm re-run
    bad = BatchJob(tokens=np.full((1, 8), cfg.vocab_size + 7))  # bad token id
    with pytest.raises(RuntimeError, match="executor thread failed"):
        ex.run([[bad]], timeout=30)
    with pytest.raises(RuntimeError, match="reused after a thread failure"):
        ex.ensure_started()
    ex.close()


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    _, _, cfg, params = smoke_setup(num_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DisaggregatedExecutor(params, cfg)  # device defaults to "cuda"


def test_resident_stack_is_a_view_under_round_robin_and_a_copy_otherwise():
    """Round-robin hosts an arithmetic progression of experts per device: the
    resident [L, n_e, ...] stack is a strided view of the model's stacks (the
    kernel takes the strides); any other layout gathers a copy."""
    _, _, cfg, params = smoke_setup(num_experts=8)
    full = params["stages"][0]["ffn"]["experts"]["w_up"]
    ex = _ex(params, cfg, D=1, E=4)
    for e, stack in enumerate(ex.resident):
        w = stack["w_up"]
        assert w.untyped_storage().data_ptr() == \
            full.untyped_storage().data_ptr()
        assert torch.equal(w, full[:, [e, e + 4]])
        assert w.stride(1) == 4 * full.stride(1)
    table = [[0], [0], [1], [0], [1], [1], [0], [1]]  # device 0: 0, 1, 3, 6
    ex = _ex(params, cfg, D=1, E=2, placement=Placement.explicit(table))
    held = ex.dev_experts[0]
    w = ex.resident[0]["w_up"]
    assert torch.equal(w, full[:, list(held)])
    assert w.untyped_storage().data_ptr() != full.untyped_storage().data_ptr()


def test_reset_stats_between_waves_of_one_executor():
    jcfg, jparams, cfg, params = smoke_setup()
    ex = _ex(params, cfg, D=1, E=2)
    _check(ex.run([_jobs(cfg, 1, seed=71)]), jparams, jcfg)
    assert ex.moe_launches.sum() > 0 and ex.log
    seen = [set(s) for s in ex._seen_buckets]
    ex.reset_stats()
    assert ex.moe_launches.sum() == 0 and ex.moe_busy.sum() == 0
    assert not ex.log and ex._t_serving_start is None
    assert ex._seen_buckets == seen  # what was learned stays
    _check(ex.run([_jobs(cfg, 1, seed=72)]), jparams, jcfg)
    assert ex.bucket_misses.sum() == 0  # the second wave found them warm
