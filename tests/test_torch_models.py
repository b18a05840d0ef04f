"""Port model functions vs the JAX functions, same numpy inputs, bridged
params (qwen3 smoke config, fp32, CPU)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, smoke_setup, t
from repro.configs import get_config as jax_get_config
from repro.core.cost_model import Placement as JaxPlacement
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models.lm import lm_backbone as jax_lm_backbone
from repro.models.lm import lm_forward as jax_lm_forward
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.core.cost_model import Placement
from repro_torch.models import attention as attn
from repro_torch.models import common, moe
from repro_torch.models.lm import (init_lm_params, layer_slice, lm_backbone,
                                   lm_forward)


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "dbrx_132b",
                                  "deepseek_v32"])
def test_config_fields_equal_reference_full_and_smoke(arch):
    for mk in (lambda c: c, lambda c: c.smoke()):
        j, p = mk(jax_get_config(arch)), mk(get_config(arch))
        jd, pd = dataclasses.asdict(j), dataclasses.asdict(p)
        assert set(jd) == set(pd)
        for k in jd:
            if k == "dtype":
                assert str(jnp.dtype(jd[k])) == str(pd[k]).replace(
                    "torch.", "")
            else:
                assert jd[k] == pd[k], k
        assert (j.q_dim, j.kv_dim, j.expert_d_ff) == \
            (p.q_dim, p.kv_dim, p.expert_d_ff)


def test_get_config_alias_and_unknown():
    assert get_config("qwen3-moe-235b-a22b").name == "qwen3-moe-235b-a22b"
    with pytest.raises(ValueError):
        get_config("mamba_7b")  # in neither registry


def test_norms_match():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 32).astype(np.float32)
    w = rng.randn(32).astype(np.float32)
    b = rng.randn(32).astype(np.float32)
    close(common.rms_norm(t(x), t(w), 1e-6),
          jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6), 1e-6)
    close(common.rms_norm(t(x), None, 1e-6),
          jcommon.rms_norm(jnp.asarray(x), None, 1e-6), 1e-6)
    close(common.layer_norm(t(x), t(w), t(b), 1e-5),
          jcommon.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             1e-5), 2e-6)
    close(common.layer_norm(t(x), None, None, 1e-5),
          jcommon.layer_norm(jnp.asarray(x), None, None, 1e-5), 2e-6)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu", "gelu_tanh"])
def test_activations_match(name):
    x = np.linspace(-4, 4, 101).astype(np.float32)
    close(common.act_fn(name)(t(x)), jcommon.act_fn(name)(jnp.asarray(x)),
          2e-6)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches(theta):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 4, 32).astype(np.float32)
    pos = np.broadcast_to(np.arange(9), (2, 9)) + 3
    close(common.rope_frequencies(32, theta),
          jcommon.rope_frequencies(32, theta), 1e-6)
    close(common.apply_rope(t(x), t(pos), theta),
          jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), 1e-5)


def _layer0(jparams, params):
    jl = jax.tree.map(lambda a: a[0], jparams["stages"][0])
    return jl, layer_slice(params["stages"][0], 0)


def test_project_qkv_matches_with_qk_norm_and_gqa():
    jcfg, jparams, cfg, params = smoke_setup()
    assert cfg.qk_norm and cfg.num_kv_heads <= cfg.num_heads
    jl, pl = _layer0(jparams, params)
    x = np.random.RandomState(2).randn(2, 12, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12))
    got = attn._project_qkv(pl["attn"], t(x), t(x), cfg, t(pos), t(pos))
    want = jattn._project_qkv(jl["attn"], jnp.asarray(x), jnp.asarray(x),
                              jcfg, jnp.asarray(pos), jnp.asarray(pos))
    for g, w in zip(got, want):
        close(g, w, 2e-5)


@pytest.mark.parametrize("use_dense", [True, False])
@pytest.mark.parametrize("window,softcap", [(None, None), (5, None),
                                            (None, 25.0)])
def test_attention_forward_both_branches(use_dense, window, softcap):
    """The dense oracle branch and the flash branch (on the CPU: the
    kernel's plain version) both equal the reference's dense attention."""
    jcfg, jparams, cfg, params = smoke_setup()
    jcfg = jcfg.replace(logit_softcap=softcap)
    cfg = cfg.replace(logit_softcap=softcap)
    jl, pl = _layer0(jparams, params)
    x = np.random.RandomState(3).randn(2, 24, cfg.d_model).astype(np.float32)
    got = attn.attention_forward(pl["attn"], t(x), cfg, window=window,
                                 use_dense=use_dense)
    want = jattn.attention_forward(jl["attn"], jnp.asarray(x), jcfg,
                                   window=window, use_dense=True)
    close(got, want, 2e-5)


def test_attention_forward_default_follows_attn_chunk():
    jcfg, jparams, cfg, params = smoke_setup()
    jl, pl = _layer0(jparams, params)
    S = cfg.attn_chunk + 16  # longer than the dense threshold -> flash branch
    x = np.random.RandomState(4).randn(1, S, cfg.d_model).astype(np.float32)
    got = attn.attention_forward(pl["attn"], t(x), cfg)
    want = jattn.attention_forward(jl["attn"], jnp.asarray(x), jcfg)
    close(got, want, 2e-5)


def test_router_topk_matches():
    jcfg, jparams, cfg, params = smoke_setup(num_experts=8)
    jl, pl = _layer0(jparams, params)
    x = np.random.RandomState(5).randn(40, cfg.d_model).astype(np.float32)
    w, idx, probs = moe.router_topk(pl["ffn"]["router"], t(x), cfg)
    jw, jidx, jprobs = jmoe.router_topk(jl["ffn"]["router"], jnp.asarray(x),
                                        jcfg)
    assert idx.dtype == torch.int32 and w.dtype == torch.float32
    close(probs, jprobs, 1e-6)
    close(w, jw, 1e-6)
    # ids only where the probabilities are distinct (tie order may differ)
    p = np.sort(np.asarray(jprobs), -1)[:, ::-1]
    distinct = (np.abs(np.diff(p[:, :cfg.top_k + 1], axis=-1)) > 1e-6).all(-1)
    assert distinct.any()
    np.testing.assert_array_equal(idx.numpy()[distinct],
                                  np.asarray(jidx)[distinct])


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_forward_dense_matches(shared):
    jcfg, jparams, cfg, params = smoke_setup(num_experts=8, shared=shared)
    jl, pl = _layer0(jparams, params)
    x = np.random.RandomState(6).randn(24, cfg.d_model).astype(np.float32)
    got, _ = moe.moe_forward_dense(pl["ffn"], t(x), cfg)
    want, _ = jmoe.moe_forward_dense(jl["ffn"], jnp.asarray(x), jcfg)
    close(got, want, 2e-5)


def test_gated_ffn_and_default_gmm_match():
    jcfg, jparams, cfg, params = smoke_setup(num_experts=4)
    jl, pl = _layer0(jparams, params)
    xb = np.random.RandomState(7).randn(4, 8, cfg.d_model).astype(np.float32)
    close(moe.default_gmm(t(xb), pl["ffn"]["experts"], cfg),
          jmoe.default_gmm(jnp.asarray(xb), jl["ffn"]["experts"], jcfg), 2e-5)
    ex, jex = pl["ffn"]["experts"], jl["ffn"]["experts"]
    close(moe.gated_ffn(t(xb[0]), ex["w_gate"][0], ex["w_up"][0],
                        ex["w_down"][0], common.act_fn("silu")),
          jmoe.gated_ffn(jnp.asarray(xb[0]), jex["w_gate"][0], jex["w_up"][0],
                         jex["w_down"][0], jcommon.act_fn("silu")), 2e-5)


@pytest.mark.parametrize("shared", [0, 1])
def test_lm_backbone_dense_matches(shared):
    jcfg, jparams, cfg, params = smoke_setup(num_layers=3, num_experts=4,
                                             shared=shared)
    tokens = np.random.RandomState(8).randint(0, cfg.vocab_size, (2, 16))
    got, _ = lm_backbone(params, cfg, t(tokens), moe_mode="dense")
    want, _ = jax_lm_backbone(jparams, jcfg, jnp.asarray(tokens),
                              moe_mode="dense")
    close(got, want, 5e-5)
    logits, _ = lm_forward(params, cfg, t(tokens), moe_mode="dense")
    jlogits, _ = jax_lm_forward(jparams, jcfg, jnp.asarray(tokens),
                                moe_mode="dense")
    close(logits, jlogits, 1e-4)


def test_lm_backbone_rejects_capacity_mode():
    """The capacity mode is ported, and since the SPMD slice so are the
    reference's sharding hints of it (`moe_shard_constraints`): nothing is
    rejected any more, and the hints change no output."""
    _, _, cfg, params = smoke_setup(num_layers=1)
    tokens = torch.randint(0, cfg.vocab_size, (1, 4),
                           generator=torch.Generator().manual_seed(4))
    on, _ = lm_backbone(params, cfg.replace(moe_shard_constraints=True),
                        tokens, moe_mode="capacity")
    off, _ = lm_backbone(params, cfg, tokens, moe_mode="capacity")
    assert torch.equal(on, off)


def test_bridge_round_trip_and_dtypes():
    jcfg, jparams, cfg, params = smoke_setup(num_layers=2, shared=1)
    np_tree = jax.tree.map(np.asarray, jparams)
    back = params_to_numpy(params)
    flat_a = jax.tree.leaves(np_tree)
    flat_b = jax.tree.leaves(back)
    assert len(flat_a) == len(flat_b) > 10
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    # bf16 config: float leaves become bf16, the router stays fp32, and the
    # stacked [L, ...] layer axis is kept
    bf = params_from_numpy(np_tree, cfg.replace(dtype=torch.bfloat16), "cpu")
    st = bf["stages"][0]
    assert st["attn"]["wq"].dtype == torch.bfloat16
    assert st["ffn"]["router"].dtype == torch.float32
    assert st["ffn"]["experts"]["w_up"].shape[:2] == (2, cfg.num_experts)
    assert params_to_numpy(bf)["embed"].dtype == np.float32


def test_init_lm_params_shapes_match_reference_and_are_seeded():
    jcfg, jparams, cfg, _ = smoke_setup(num_layers=2, shared=1)
    gen = torch.Generator(device="cpu").manual_seed(3)
    params = init_lm_params(gen, cfg, "cpu")
    ja = jax.tree.map(lambda a: tuple(a.shape), jparams)
    pa = jax.tree.map(lambda a: tuple(a.shape), params_to_numpy(params))
    assert jax.tree.structure(ja) == jax.tree.structure(pa)
    assert jax.tree.leaves(ja) == jax.tree.leaves(pa)
    again = init_lm_params(torch.Generator(device="cpu").manual_seed(3), cfg)
    assert torch.equal(params["embed"], again["embed"])
    h, _ = lm_backbone(params, cfg, torch.zeros((1, 8), dtype=torch.long))
    assert torch.isfinite(h).all()


@pytest.mark.parametrize("spec", ["round_robin", "greedy_balanced",
                                  "replicated(2)", "replicated"])
@pytest.mark.parametrize("ep", [2, 4])
def test_placement_tables_equal_reference(spec, ep):
    rng = np.random.RandomState(9)
    for fr in (Placement.uniform_fractions(8),
               tuple(float(x) for x in rng.dirichlet(np.ones(8) * 0.3))):
        p, j = Placement.parse(spec), JaxPlacement.parse(spec)
        assert p.table(fr, ep) == j.table(fr, ep)
        assert p.device_experts(fr, ep) == j.device_experts(fr, ep)
        np.testing.assert_array_equal(p.device_fractions(fr, ep),
                                      j.device_fractions(fr, ep))
    assert Placement.uniform_fractions(8) == JaxPlacement.uniform_fractions(8)
