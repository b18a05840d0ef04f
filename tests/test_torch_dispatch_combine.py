"""The port's dispatch/combine kernels (plain versions on the CPU), their
wiring into the capacity-mode MoE layer, and the capacity layer itself,
against the JAX functions on the same numpy inputs (Pallas kernels in
interpret mode, as tests/test_kernels.py runs them)."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, smoke_setup, t
from repro.kernels.dispatch_combine import ops as jops
from repro.kernels.dispatch_combine.dispatch_combine import \
    combine_gather as jax_combine_gather
from repro.kernels.dispatch_combine.dispatch_combine import \
    dispatch_scatter as jax_dispatch_scatter
from repro.kernels.dispatch_combine.ref import (combine_gather_ref,
                                                dispatch_scatter_ref)
from repro.models import moe as jmoe
from repro.models.common import ModelConfig as JaxModelConfig
from repro.models.lm import lm_forward as jax_lm_forward
from repro_torch.kernels.dispatch_combine import ops
from repro_torch.kernels.dispatch_combine.dispatch_combine import (
    combine_gather, dispatch_scatter)
from repro_torch.models import blocks, lm, moe
from repro_torch.models.common import ModelConfig

CASES = [(64, 8, 2, None), (128, 4, 4, None), (32, 16, 1, None),
         (64, 8, 2, 8)]  # the last: capacity below the hottest expert's count


def _cfgs(E, K, d=16):
    kw = dict(name="k", family="moe", num_layers=1, d_model=d, num_heads=2,
              num_kv_heads=2, head_dim=8, d_ff=32, vocab_size=64,
              num_experts=E, top_k=K)
    return (JaxModelConfig(dtype=jnp.float32, **kw),
            ModelConfig(dtype=torch.float32, **kw))


def _routing(T, E, K, d=16, seed=0):
    """x [T, d], router weights [T, K], expert ids [T, K] from the JAX
    router on numpy inputs (no ties)."""
    jcfg, cfg = _cfgs(E, K, d)
    rng = np.random.RandomState(seed)
    x = rng.randn(T, d).astype(np.float32)
    router = rng.randn(d, E).astype(np.float32)
    w, idx, _ = jmoe.router_topk(jnp.asarray(router), jnp.asarray(x), jcfg)
    return jcfg, cfg, x, np.asarray(w), np.asarray(idx)


@pytest.mark.parametrize("T,E,K,cap", CASES)
def test_plain_kernels_equal_jax_pallas_kernels(T, E, K, cap):
    """The plain versions against the Pallas kernels (and their jnp oracles)
    on the slots of a real routing.  Row E*C is the trash row: the
    reference writes dropped pairs there and its callers ignore it; the port
    leaves it zero."""
    jcfg, cfg, x, _, idx = _routing(T, E, K)
    C = cap or moe.expert_capacity(T, cfg)
    perm, slot, valid, _ = moe.dispatch_slots(t(idx), E, C)
    token_of = (perm // K).to(torch.int32)
    slot = slot.to(torch.int32)
    rows = E * C + 1
    got = dispatch_scatter(token_of, slot, t(x), rows_out=rows)
    want = jax_dispatch_scatter(jnp.asarray(token_of.numpy()),
                                jnp.asarray(slot.numpy()), jnp.asarray(x),
                                rows_out=rows, interpret=True)
    np.testing.assert_array_equal(got.numpy()[:-1], np.asarray(want)[:-1])
    np.testing.assert_array_equal(
        got.numpy()[:-1],
        np.asarray(dispatch_scatter_ref(jnp.asarray(token_of.numpy()),
                                        jnp.asarray(slot.numpy()),
                                        jnp.asarray(x), rows))[:-1])
    assert not got[-1].any()
    assert (cap is not None) == bool((~valid).any())
    yb = np.random.RandomState(1).randn(rows, x.shape[1]).astype(np.float32)
    yb[-1] = 0
    got = combine_gather(slot, t(yb))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_combine_gather(
            jnp.asarray(slot.numpy()), jnp.asarray(yb), interpret=True)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(combine_gather_ref(
            jnp.asarray(slot.numpy()), jnp.asarray(yb))))


@pytest.mark.parametrize("T,E,K,cap", CASES)
def test_kernel_moe_dispatch_combine_vs_jax(T, E, K, cap):
    """kernel_moe_dispatch bit for bit against JAX kernel_moe_dispatch AND
    moe_dispatch (buffer and every info field); kernel_moe_combine at 1e-6,
    both un-permute variants."""
    jcfg, cfg, x, w, idx = _routing(T, E, K, seed=T + E)
    xb, info = ops.kernel_moe_dispatch(t(x), t(idx), cfg, cap)
    jxb, jinfo = jops.kernel_moe_dispatch(jnp.asarray(x), jnp.asarray(idx),
                                          jcfg, cap, interpret=True)
    pxb, pinfo = jmoe.moe_dispatch(jnp.asarray(x), jnp.asarray(idx), jcfg, cap)
    np.testing.assert_array_equal(xb.numpy(), np.asarray(jxb))
    np.testing.assert_array_equal(xb.numpy(), np.asarray(pxb))
    for k in ("perm", "slot", "valid", "group_sizes"):
        np.testing.assert_array_equal(info[k].numpy(), np.asarray(jinfo[k]))
    assert info["capacity"] == jinfo["capacity"]
    oxb, oinfo = moe.moe_dispatch(t(x), t(idx), cfg, cap)  # the port's oracle
    assert torch.equal(oxb, xb)
    yb = np.asarray(pxb) * 3.0
    want = jops.kernel_moe_combine(jnp.asarray(yb), jinfo, jnp.asarray(w), T,
                                   interpret=True)
    for via_gather in (False, True):
        got = ops.kernel_moe_combine(t(yb), info, t(w), T,
                                     via_gather=via_gather)
        close(got, want, 1e-6)
        close(moe.moe_combine(t(yb), oinfo, t(w), T, via_gather=via_gather),
              jmoe.moe_combine(jnp.asarray(yb), pinfo, jnp.asarray(w), T,
                               via_gather=via_gather), 1e-6)


def test_wrappers_on_cpu_launch_nothing_and_check_their_indices():
    s0, g0 = dispatch_scatter.launches, combine_gather.launches
    x = torch.randn(4, 8)
    idx = torch.tensor([0, 3], dtype=torch.int32)
    slot = torch.tensor([2, 5], dtype=torch.int32)  # 5: the trash row
    out = dispatch_scatter(idx, slot, x, rows_out=6)
    assert torch.equal(out[2], x[0]) and not out[5].any()
    assert torch.equal(combine_gather(slot, out)[0], x[0])
    assert torch.equal(combine_gather(torch.tensor([9], dtype=torch.int32),
                                      out), torch.zeros(1, 8))
    assert (dispatch_scatter.launches, combine_gather.launches) == (s0, g0)
    with pytest.raises(ValueError):
        dispatch_scatter(idx.long(), slot, x, rows_out=6)
    with pytest.raises(ValueError):
        combine_gather(slot[:1, None], out)


def _layer0(jparams, params):
    return (jax.tree.map(lambda a: a[0], jparams["stages"][0]),
            lm.layer_slice(params["stages"][0], 0))


def _close_aux(aux, jaux, tol=1e-6):
    for a, b in zip(aux, jaux):
        close(a, b, tol)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("via_gather", [False, True])
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_forward_capacity_matches_jax(groups, via_gather, shared):
    jcfg, jparams, cfg, params = smoke_setup(num_experts=8, shared=shared)
    kw = dict(dispatch_groups=groups, combine_via_gather=via_gather,
              capacity_factor=0.5)
    jcfg, cfg = jcfg.replace(**kw), cfg.replace(**kw)
    jl, pl = _layer0(jparams, params)
    x = np.random.RandomState(12).randn(48, cfg.d_model).astype(np.float32)
    y, aux = moe.moe_forward_capacity(pl["ffn"], t(x), cfg)
    jy, jaux = jmoe.moe_forward_capacity(jl["ffn"], jnp.asarray(x), jcfg)
    close(y, jy, 1e-5)
    _close_aux(aux, jaux)
    if groups == 1:  # 96 pairs over 8 experts at C=8: some drop
        assert float(aux.dropped_fraction) > 0


def test_moe_forward_dense_aux_matches_jax():
    jcfg, jparams, cfg, params = smoke_setup(num_experts=8)
    jl, pl = _layer0(jparams, params)
    x = np.random.RandomState(13).randn(24, cfg.d_model).astype(np.float32)
    y, aux = moe.moe_forward(pl["ffn"], t(x), cfg, mode="dense")
    jy, jaux = jmoe.moe_forward(jl["ffn"], jnp.asarray(x), jcfg, mode="dense")
    close(y, jy, 2e-5)
    _close_aux(aux, jaux)
    assert float(aux.dropped_fraction) == 0.0


def test_moe_mode_defaults_are_the_references():
    """The defaults pinned: capacity everywhere, as in the reference; and
    called with defaults, both packages compute the same thing where the
    capacity mode drops pairs (which the dense mode never does)."""
    for fn in (lm.lm_backbone, lm.lm_forward, blocks.decoder_block_forward,
               moe.moe_forward):
        assert inspect.signature(fn).parameters[
            "moe_mode" if fn is not moe.moe_forward else "mode"].default \
            == "capacity", fn.__name__
    jcfg, jparams, cfg, params = smoke_setup(num_experts=8)
    jcfg, cfg = (c.replace(capacity_factor=0.5) for c in (jcfg, cfg))
    tokens = np.random.RandomState(14).randint(0, cfg.vocab_size, (2, 16))
    logits, aux = lm.lm_forward(params, cfg, t(tokens))
    jlogits, jaux = jax_lm_forward(jparams, jcfg, jnp.asarray(tokens))
    close(logits, jlogits, 1e-4)
    _close_aux(aux, jaux)
    assert float(aux.dropped_fraction) > 0
    dense, _ = lm.lm_forward(params, cfg, t(tokens), moe_mode="dense")
    assert float((dense - logits).abs().max()) > 1e-3


def test_moe_shard_constraints_not_ported():
    _, _, cfg, params = smoke_setup(num_layers=1)
    with pytest.raises(NotImplementedError):
        moe.moe_forward(lm.layer_slice(params["stages"][0], 0)["ffn"],
                        torch.zeros(4, cfg.d_model),
                        cfg.replace(moe_shard_constraints=True))
