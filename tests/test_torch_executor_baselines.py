"""The port's executor baselines and the Super Kernel as `lm_forward`'s gmm
(CPU, kernels' plain versions) against the JAX reference on the same bridged
params: the pre-fusion eager MoE path and the host combine meet the
reference's contracts (tests/test_executor.py), and `lm_forward(gmm=
make_super_kernel_gmm(...))` agrees with the JAX package's (its Pallas
kernel in interpret mode, as tests/test_kernels.py runs it)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, smoke_setup, t
from repro.kernels.super_gmm.ops import \
    make_super_kernel_gmm as jax_make_super_kernel_gmm
from repro.models.lm import lm_backbone as jax_lm_backbone
from repro.models.lm import lm_forward as jax_lm_forward
from repro_torch.core.cost_model import Placement
from repro_torch.core.executor import BatchJob, DisaggregatedExecutor
from repro_torch.kernels.super_gmm.ops import make_super_kernel_gmm
from repro_torch.models.lm import lm_forward


def _jobs(cfg, n, B=2, S=8, seed=0):
    return [BatchJob(tokens=np.random.RandomState(seed + i).randint(
        0, cfg.vocab_size, (B, S)), bid=i) for i in range(n)]


def _check(done, jparams, jcfg, tol=5e-5):
    for j in done:
        ref, _ = jax_lm_backbone(jparams, jcfg, jnp.asarray(j.tokens),
                                 moe_mode="dense")
        np.testing.assert_allclose(j.result.numpy(), np.asarray(ref),
                                   rtol=tol, atol=tol)


def _ex(params, cfg, **kw):
    return DisaggregatedExecutor(params, cfg, device="cpu", **kw)


@pytest.mark.parametrize("policy", ["round_robin", "greedy_balanced",
                                    "replicated(2)"])
def test_eager_contract_all_placements(policy):
    """The pre-fusion baseline (dense attention, E boolean dispatch scans,
    per-expert matmuls) stays correct, placement-routed, and launches no
    Super Kernel."""
    jcfg, jparams, cfg, params = smoke_setup(num_experts=8)
    jobs = _jobs(cfg, 2, seed=23)
    ex = _ex(params, cfg, D=1, E=4, moe_path="eager",
             placement=Placement.parse(policy))
    _check(ex.run([jobs]), jparams, jcfg)
    assert ex.moe_launches.sum() == 0
    assert sum(1 for ev in ex.log if ev[0] == "moe" and ev[5] > 0) > 0


@pytest.mark.parametrize("shared", [0, 1])
def test_host_combine_bitwise_equals_device_combine(shared):
    """The host combine (numpy fp32) does the device combine's write and
    in-order multiply-then-add: the results are equal bit for bit, shared
    expert included."""
    jcfg, jparams, cfg, params = smoke_setup(num_experts=8, shared=shared)
    jobs = _jobs(cfg, 2, seed=41)

    def fresh():
        return [[BatchJob(tokens=j.tokens, bid=j.bid) for j in jobs]]

    done_h = _ex(params, cfg, D=1, E=4, combine_path="host").run(fresh())
    done_d = _ex(params, cfg, D=1, E=4, combine_path="device").run(fresh())
    for a, b in zip(done_h, done_d):
        assert torch.equal(a.result, b.result)
    _check(done_d, jparams, jcfg)


def test_eager_host_combine_contract():
    jcfg, jparams, cfg, params = smoke_setup(num_experts=8, shared=1)
    jobs = _jobs(cfg, 2, seed=47)
    ex = _ex(params, cfg, D=2, E=2, moe_path="eager", combine_path="host")
    _check(ex.run([jobs[:1], jobs[1:]]), jparams, jcfg)


@pytest.mark.parametrize("kw,match", [
    (dict(moe_path="eager", emit_kv=True), "emit_kv"),
    (dict(moe_path="pallas"), "moe_path"),
    (dict(combine_path="segsum"), "combine_path")])
def test_constructor_rejects_bad_paths(kw, match):
    _, _, cfg, params = smoke_setup(num_layers=1)
    with pytest.raises(ValueError, match=match):
        _ex(params, cfg, D=1, E=2, **kw)


def test_eager_has_no_buckets_to_prewarm():
    _, _, cfg, params = smoke_setup(num_layers=1)
    with pytest.raises(ValueError, match="fused"):
        _ex(params, cfg, D=1, E=2, moe_path="eager").prewarm_buckets(8)


def _gmm_setup():
    """tests/test_kernels.py's config for lm_forward on the Super Kernel."""
    jcfg, jparams, cfg, params = smoke_setup(num_layers=3, num_experts=4,
                                             top_k=2, capacity_factor=8.0)
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 16))
    return jcfg, jparams, cfg, params, tokens


def test_lm_forward_on_super_kernel_matches_jax_and_einsum():
    """Port lm_forward(gmm=make_super_kernel_gmm(...)) against the JAX
    package's (Pallas super_gmm in interpret mode) and against the port's
    own einsum path, both at 2e-5 (fp32; the sums differ only in order)."""
    jcfg, jparams, cfg, params, tokens = _gmm_setup()
    jgmm = jax_make_super_kernel_gmm(jparams["stages"][0]["ffn"]["experts"],
                                     jcfg)
    want, _ = jax_lm_forward(jparams, jcfg, jnp.asarray(tokens), gmm=jgmm)
    gmm = make_super_kernel_gmm(params["stages"][0]["ffn"]["experts"], cfg)
    got, aux = lm_forward(params, cfg, t(tokens), gmm=gmm)
    close(got, want, 2e-5)
    einsum, aux_e = lm_forward(params, cfg, t(tokens))
    close(got, einsum, 2e-5)
    assert float(aux.dropped_fraction) == float(aux_e.dropped_fraction) == 0


def test_gmm_gets_the_layer_id_as_a_device_view():
    """The layer id the adapter gets is a one-element int32 view into one
    arange per call: device data, no per-layer tensor made on the host."""
    _, _, cfg, params, tokens = _gmm_setup()
    inner = make_super_kernel_gmm(params["stages"][0]["ffn"]["experts"], cfg)
    seen = []

    def gmm(xb, experts, cfg_, layer_id):
        seen.append(layer_id)
        return inner(xb, experts, cfg_, layer_id)

    lm_forward(params, cfg, t(tokens), gmm=gmm)
    assert len(seen) == cfg.num_layers
    base = seen[0].untyped_storage().data_ptr()
    for l, lid in enumerate(seen):
        assert isinstance(lid, torch.Tensor) and lid.dtype == torch.int32
        assert lid.shape == (1,) and lid._base is not None
        assert lid.untyped_storage().data_ptr() == base
        assert int(lid) == l
    # a gmm that ignores the layer id is a different model: the id matters
    first = make_super_kernel_gmm(params["stages"][0]["ffn"]["experts"], cfg)
    wrong, _ = lm_forward(params, cfg, t(tokens),
                          gmm=lambda xb, ex, c, lid: first(xb, ex, c,
                                                           seen[0]))
    right, _ = lm_forward(params, cfg, t(tokens), gmm=inner)
    assert float((wrong - right).abs().max()) > 1e-3
