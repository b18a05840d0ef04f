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
    combine_gather, combine_weighted, dispatch_scatter, dispatch_whole)
from repro_torch.kernels.dispatch_combine.ref import (RANK_CHUNK,
                                                      combine_weighted_ref)
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


def _pair_slot(info):
    """moe_dispatch's slots in pair order: the combine's view of the info."""
    return torch.empty_like(info["slot"]).scatter_(0, info["perm"],
                                                   info["slot"])


# (T, E, K, capacity, how the ids are made): the routing cases of the
# whole dispatch beyond CASES -- one token, every pair to one expert (most
# dropped), N at the rank chunk's edges, deepseek_v32's 256 experts
WHOLE_CASES = [(1, 128, 8, None, "router"), (64, 16, 4, 8, "one expert"),
               (RANK_CHUNK - 1, 16, 1, None, "router"),
               (RANK_CHUNK, 16, 1, None, "router"),
               (RANK_CHUNK + 1, 16, 1, None, "router"),
               (64, 256, 8, None, "router")]


def _whole_routing(T, E, K, how, seed):
    jcfg, cfg, x, w, idx = _routing(T, E, K, seed=seed)
    if how == "one expert":
        idx = np.full_like(idx, 5)
    return jcfg, cfg, x, w, idx


@pytest.mark.parametrize("T,E,K,cap,how",
                         [c + ("router",) for c in CASES] + WHOLE_CASES)
def test_whole_dispatch_equals_jax_bit_for_bit(T, E, K, cap, how):
    """dispatch_whole (its plain version, on the CPU) against the JAX
    moe_dispatch and the JAX kernel_moe_dispatch with Pallas in interpret
    mode: every output bit for bit, and pair_slot equal to the reference's
    slots put back in pair order."""
    jcfg, cfg, x, _, idx = _whole_routing(T, E, K, how, seed=T + E + K)
    C = cap or moe.expert_capacity(T, cfg)
    xb, perm, slot, valid, group_sizes, pair_slot = dispatch_whole(
        t(x), t(idx), E, C)
    got = dict(perm=perm, slot=slot, valid=valid, group_sizes=group_sizes)
    jxb, jinfo = jmoe.moe_dispatch(jnp.asarray(x), jnp.asarray(idx), jcfg, C)
    kxb, kinfo = jops.kernel_moe_dispatch(jnp.asarray(x), jnp.asarray(idx),
                                          jcfg, C, interpret=True)
    for want_xb, want in ((jxb, jinfo), (kxb, kinfo)):
        np.testing.assert_array_equal(xb.reshape(E, C, -1).numpy(),
                                      np.asarray(want_xb))
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
    assert pair_slot.dtype == perm.dtype == slot.dtype == torch.long
    assert valid.dtype == torch.bool
    assert torch.equal(pair_slot, _pair_slot(
        {k: torch.from_numpy(np.asarray(jinfo[k]).astype(np.int64))
         for k in ("perm", "slot")}))
    if how == "one expert":
        assert int((~valid).sum()) == T * K - C


@pytest.mark.parametrize("T,E,K,cap,hot", [(640, 128, 8, None, None),
                                           (640, 16, 8, 2000, (3, 11))])
def test_whole_dispatch_large_n_equals_jax_moe_dispatch(T, E, K, cap, hot):
    """N = 5120 > 4096 pairs, one design for every N: against the JAX
    moe_dispatch; the second case puts 2560 pairs on each of two experts at
    C = 2000 (the kernel's rows blocks fill 1024 capacity rows a pass)."""
    jcfg, cfg, x, _, idx = _routing(T, E, K, d=8, seed=3)
    if hot is not None:
        idx = np.asarray(hot, np.int32)[np.arange(T * K) % 2].reshape(T, K)
    C = cap or moe.expert_capacity(T, cfg)
    xb, perm, slot, valid, group_sizes, pair_slot = dispatch_whole(
        t(x), t(idx), E, C)
    jxb, jinfo = jmoe.moe_dispatch(jnp.asarray(x), jnp.asarray(idx), jcfg, C)
    np.testing.assert_array_equal(xb.reshape(E, C, -1).numpy(),
                                  np.asarray(jxb))
    for k, v in dict(perm=perm, slot=slot, valid=valid,
                     group_sizes=group_sizes).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jinfo[k]))


@pytest.mark.parametrize("via_gather", [False, True])
@pytest.mark.parametrize("source", ["kernel_moe_dispatch", "moe_dispatch"])
@pytest.mark.parametrize("T,E,K,cap,how", [(64, 8, 2, 8, "router"),
                                           (1, 128, 8, None, "router"),
                                           (64, 16, 4, 8, "one expert"),
                                           (64, 256, 8, None, "router")])
def test_weighted_combine_matches_jax_moe_combine(T, E, K, cap, how,
                                                  source, via_gather):
    """kernel_moe_combine (the weighted route's plain version) against the
    JAX moe_combine at 1e-6 in fp32, for both via_gather values, given an
    info from either of the port's dispatches (moe_dispatch's has no
    pair_slot: the wrapper derives it)."""
    jcfg, cfg, x, w, idx = _whole_routing(T, E, K, how, seed=7 * T + E)
    C = cap or moe.expert_capacity(T, cfg)
    dispatch = ops.kernel_moe_dispatch if source == "kernel_moe_dispatch" \
        else moe.moe_dispatch
    _, info = dispatch(t(x), t(idx), cfg, C)
    assert ("pair_slot" in info) == (source == "kernel_moe_dispatch")
    _, jinfo = jmoe.moe_dispatch(jnp.asarray(x), jnp.asarray(idx), jcfg, C)
    yb = np.random.RandomState(T + K).randn(E, C, x.shape[1]) \
        .astype(np.float32)
    got = ops.kernel_moe_combine(t(yb), info, t(w), T, via_gather=via_gather)
    close(got, jmoe.moe_combine(jnp.asarray(yb), jinfo, jnp.asarray(w), T,
                                via_gather=via_gather), 1e-6)


def test_weighted_combine_sums_k_in_order_and_skips_dropped_pairs():
    """(1 + 1e8) - 1e8 is 0 in fp32 only in the order k = 0, 1, 2; a
    pair_slot outside yb adds nothing, even where the row it would name
    holds NaN; each weight is rounded to the payload's type first."""
    yb = torch.tensor([[1.0] * 4, [1e8] * 4, [-1e8] * 4, [np.nan] * 4])
    got = combine_weighted(yb[:3], torch.tensor([0, 1, 2, 3, -1, 7]),
                           torch.ones((2, 3)))
    assert torch.equal(got, torch.tensor([[0.0] * 4, [0.0] * 4]))
    ybf = torch.randn(3, 8).bfloat16()
    w = torch.tensor([[0.3, 0.3001, 0.4]])
    want = sum(w[0, k].bfloat16().float() * ybf[k].float()
               for k in range(3)).bfloat16()
    assert torch.equal(combine_weighted_ref(ybf, torch.arange(3), w)[0],
                       want)


def test_new_routes_on_cpu_launch_nothing_and_check_their_inputs():
    counts = (dispatch_scatter.launches, combine_gather.launches,
              dict(dispatch_scatter.launches_by_route),
              dict(combine_gather.launches_by_route))
    jcfg, cfg, x, w, idx = _routing(16, 8, 2)
    xb, info = ops.kernel_moe_dispatch(t(x), t(idx), cfg)
    ops.kernel_moe_combine(xb, info, t(w), 16)
    dispatch_whole(t(x), t(idx).long(), 8, 8)
    assert counts == (dispatch_scatter.launches, combine_gather.launches,
                      dispatch_scatter.launches_by_route,
                      combine_gather.launches_by_route)
    with pytest.raises(ValueError):
        dispatch_whole(t(x), t(idx)[:4], 8, 8)  # T differs
    with pytest.raises(ValueError):
        combine_weighted(xb.reshape(64, -1), info["pair_slot"].int(), t(w))
    with pytest.raises(ValueError):
        combine_weighted(xb.reshape(64, -1), info["pair_slot"][:-1], t(w))


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
    """The flag once raised here; its hints are ported now (`pshard`) and,
    as hints, change no output: off a mesh they return their input."""
    _, _, cfg, params = smoke_setup(num_layers=1)
    p = lm.layer_slice(params["stages"][0], 0)["ffn"]
    x = torch.randn(4, cfg.d_model, generator=torch.Generator().manual_seed(3))
    on, _ = moe.moe_forward(p, x, cfg.replace(moe_shard_constraints=True))
    off, _ = moe.moe_forward(p, x, cfg)
    assert torch.equal(on, off)


def _cu_whole_max_experts() -> int:
    """WHOLE_MAX_EXPERTS as csrc/dispatch_combine.cu computes it."""
    import os
    import re
    path = os.path.join(os.path.dirname(__file__), "..", "src",
                        "repro_torch", "csrc", "dispatch_combine.cu")
    src = open(path).read()
    threads = int(re.search(r"constexpr int WHOLE_THREADS = (\d+);",
                            src).group(1))
    assert re.search(r"constexpr int WHOLE_WARPS = WHOLE_THREADS / 32;", src)
    kb, extra = re.search(
        r"constexpr int WHOLE_MAX_EXPERTS =\s*(\d+) \* 1024 / "
        r"\(static_cast<int>\(sizeof\(int\)\) \* \((\d+) \+ WHOLE_WARPS\)\) "
        r"- 1;", src).groups()
    return int(kb) * 1024 // (4 * (int(extra) + threads // 32)) - 1


def test_dispatch_route_is_a_function_of_the_expert_count():
    """kernel_moe_dispatch takes "whole" up to the kernel's own bound (read
    out of the .cu, so the two cannot drift) and the unbounded "scatter"
    route beyond it."""
    from repro_torch.kernels.dispatch_combine.dispatch_combine import \
        WHOLE_MAX_EXPERTS
    bound = _cu_whole_max_experts()
    assert WHOLE_MAX_EXPERTS == bound == 1116
    assert ops.dispatch_route(1) == ops.dispatch_route(bound) == "whole"
    assert ops.dispatch_route(bound + 1) == ops.dispatch_route(4096) \
        == "scatter"


@pytest.mark.parametrize("E", [1116, 1117])
def test_kernel_moe_dispatch_serves_any_expert_count(E):
    """On either side of the bound ("whole" at 1116, "scatter" at 1117)
    kernel_moe_dispatch gives the JAX moe_dispatch's and the JAX
    kernel_moe_dispatch's (Pallas in interpret mode) outputs bit for bit
    (the reference has no bound on E), its pair_slot is the reference's
    slots in pair order, and the combine over its info matches the JAX
    kernel_moe_combine and moe_combine at 1e-6."""
    T, K, d = 40, 2, 8
    jcfg, cfg = _cfgs(E, K, d)
    rng = np.random.RandomState(E)
    x = rng.randn(T, d).astype(np.float32)
    idx = np.stack([rng.choice(8, K, replace=False) * 139 % E
                    for _ in range(T)]).astype(np.int32)
    w = rng.rand(T, K).astype(np.float32)
    jx, jidx, jw = jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w)
    for cap in (None, T, 2):  # the config's, dropless, most pairs dropped
        xb, info = ops.kernel_moe_dispatch(t(x), t(idx), cfg, cap)
        pxb, pinfo = jmoe.moe_dispatch(jx, jidx, jcfg, cap)
        kxb, kinfo = jops.kernel_moe_dispatch(jx, jidx, jcfg, cap,
                                              interpret=True)
        assert info["capacity"] == pinfo["capacity"] == kinfo["capacity"]
        for want_xb, want in ((pxb, pinfo), (kxb, kinfo)):
            np.testing.assert_array_equal(xb.numpy(), np.asarray(want_xb))
            for k in ("perm", "slot", "valid", "group_sizes"):
                np.testing.assert_array_equal(info[k].numpy(),
                                              np.asarray(want[k]))
        assert torch.equal(info["pair_slot"], _pair_slot(
            {k: torch.from_numpy(np.asarray(pinfo[k]).astype(np.int64))
             for k in ("perm", "slot")}))
        if cap is not None:
            assert bool((~info["valid"]).any()) == (cap == 2)
        yb = np.asarray(pxb) * 3.0
        got = ops.kernel_moe_combine(t(yb), info, t(w), T)
        close(got, jops.kernel_moe_combine(jnp.asarray(yb), kinfo, jw, T,
                                           interpret=True), 1e-6)
        close(got, jmoe.moe_combine(jnp.asarray(yb), pinfo, jw, T), 1e-6)
