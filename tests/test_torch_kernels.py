"""Port kernels' wrappers (plain versions, on the CPU) vs the JAX package's
Pallas kernels (interpret mode) and oracles, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ops import mha_flash as jax_mha_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.super_gmm import ops as jax_ops
from repro.kernels.super_gmm.ref import super_gmm_ref as jax_super_gmm_ref
from repro.kernels.super_gmm.super_gmm import super_gmm as jax_super_gmm
from repro.models.common import ModelConfig as JaxModelConfig
from repro_torch.kernels.flash_attention.flash_attention import (
    attention_ref, flash_attention)
from repro_torch.kernels.flash_attention.ops import mha_flash
from repro_torch.kernels.super_gmm import ops
from repro_torch.kernels.super_gmm.ref import super_gmm_ref, super_moe_ffn_ref
from repro_torch.kernels.super_gmm.super_gmm import super_gmm
from repro_torch.models.common import ModelConfig, act_fn


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------- super gmm

@pytest.mark.parametrize("L,E,C,K,N", [(3, 4, 192, 128, 64), (2, 2, 8, 128, 64),
                                       (4, 3, 24, 48, 96)])
def test_super_gmm_matches_jax_kernel_and_ref_every_layer(L, E, C, K, N):
    """fp32, every layer id, C=192 and C=8 at the smoke widths: 1e-5 (same
    products, fp32 sums in another order)."""
    rng = np.random.RandomState(0)
    w = rng.randn(L, E, K, N).astype(np.float32)
    x = rng.randn(E, C, K).astype(np.float32)
    outs = []
    for lid in range(L):
        got = super_gmm(torch.tensor([lid], dtype=torch.int32), _t(w), _t(x))
        assert got.dtype == torch.float32 and got.shape == (E, C, N)
        _close(got, jax_super_gmm(jnp.array([lid], jnp.int32), jnp.asarray(w),
                                  jnp.asarray(x)), 1e-5)
        _close(got, jax_super_gmm_ref(jnp.array(lid), jnp.asarray(w),
                                      jnp.asarray(x)), 1e-5)
        _close(got, super_gmm_ref(torch.tensor([lid], dtype=torch.int32),
                                  _t(w), _t(x)), 1e-6)
        outs.append(got)
    if L > 1:  # the weights are really indexed by the layer id
        assert (outs[0] - outs[1]).abs().max() > 1e-3


def test_super_gmm_bf16_inputs_accumulate_in_fp32():
    rng = np.random.RandomState(1)
    w = rng.randn(2, 2, 64, 32).astype(np.float32)
    x = rng.randn(2, 16, 64).astype(np.float32)
    got = super_gmm(torch.tensor([1], dtype=torch.int32),
                    _t(w).bfloat16(), _t(x).bfloat16())
    want = jax_super_gmm_ref(jnp.array(1), jnp.asarray(w, jnp.bfloat16),
                             jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.float32
    _close(got, want, 1e-4)  # identical bf16 inputs, fp32 sums reordered


def test_super_gmm_counts_mark_padding_rows():
    """Rows at or beyond counts[e] are padding: zeros out whatever x holds
    there; the rows that exist equal the product without counts."""
    rng = np.random.RandomState(5)
    w = _t(rng.randn(2, 4, 32, 24).astype(np.float32))
    x = _t(rng.randn(4, 20, 32).astype(np.float32))
    lid = torch.tensor([1], dtype=torch.int32)
    counts = torch.tensor([0, 7, 20, 99], dtype=torch.int32)
    got = super_gmm(lid, w, x, counts)
    full = super_gmm(lid, w, x)
    assert got[0].abs().max() == 0 and got[1, 7:].abs().max() == 0
    assert torch.equal(got[1, :7], full[1, :7])
    assert torch.equal(got[2:], full[2:])
    with pytest.raises(ValueError):
        super_gmm(lid, w, x, counts.long())  # int32 only
    # on packed buffers (padding already zero) the counts change nothing
    experts, xb, kw = _ffn_setup()
    cfg = ModelConfig(dtype=torch.float32, **kw)
    tex = {k: _t(v) for k, v in experts.items()}
    tokens, eids = _t(xb.reshape(-1, 32)), _t(rng.randint(0, 4, 64))
    pk, order, slots, C = ops.pack_capacity(tokens, eids, 4)
    cnt = torch.bincount(eids, minlength=4).to(torch.int32)
    assert torch.equal(ops.super_moe_ffn(lid, tex, pk, cfg, cnt),
                       ops.super_moe_ffn(lid, tex, pk, cfg))


def test_super_gmm_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        super_gmm(torch.tensor([0], dtype=torch.int32),
                  torch.zeros(1, 2, 8, 4), torch.zeros(3, 5, 8))


def _ffn_setup(seed=2, L=3, E=4, d=32, f=48, C=16):
    rng = np.random.RandomState(seed)
    experts = {"w_gate": rng.randn(L, E, d, f).astype(np.float32),
               "w_up": rng.randn(L, E, d, f).astype(np.float32),
               "w_down": rng.randn(L, E, f, d).astype(np.float32)}
    xb = rng.randn(E, C, d).astype(np.float32)
    kw = dict(name="k", family="moe", num_layers=L, d_model=d, num_heads=2,
              num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64,
              num_experts=E, top_k=2, moe_d_ff=f)
    return experts, xb, kw


def test_super_moe_ffn_matches_jax():
    experts, xb, kw = _ffn_setup()
    cfg = ModelConfig(dtype=torch.float32, **kw)
    jcfg = JaxModelConfig(dtype=jnp.float32, **kw)
    tex = {k: _t(v) for k, v in experts.items()}
    jex = {k: jnp.asarray(v) for k, v in experts.items()}
    for lid in range(kw["num_layers"]):
        tl = torch.tensor([lid], dtype=torch.int32)
        got = ops.super_moe_ffn(tl, tex, _t(xb), cfg)
        want = jax_ops.super_moe_ffn(jnp.array([lid], jnp.int32), jex,
                                     jnp.asarray(xb), jcfg)
        _close(got, want, 2e-4)
        _close(got, super_moe_ffn_ref(tl, tex, _t(xb), act_fn(cfg.act)), 1e-6)


# ------------------------------------------------------- capacity packing

def test_round_capacity_equals_reference():
    for n in (0, 1, 7, 8, 9, 100, 128, 129, 5000):
        assert ops.round_capacity(n) == jax_ops.round_capacity(n)


@pytest.mark.parametrize("n,n_experts", [(1, 1), (7, 3), (64, 4), (129, 8)])
def test_pack_unpack_equal_reference_numpy(n, n_experts):
    rng = np.random.RandomState(0)
    tokens = rng.randn(n, 16).astype(np.float32)
    eids = rng.randint(0, n_experts, n)
    xb, order, slots, C = ops.pack_capacity(_t(tokens), _t(eids), n_experts)
    rxb, rorder, rslots, rC = jax_ops.pack_capacity(tokens, eids, n_experts)
    assert C == rC
    np.testing.assert_array_equal(xb.numpy(), rxb)
    np.testing.assert_array_equal(order.numpy(), rorder)
    np.testing.assert_array_equal(slots.numpy(), rslots)
    yb = rng.randn(n_experts, C, 16).astype(np.float32)
    np.testing.assert_array_equal(
        ops.unpack_capacity(_t(yb), order, slots, n).numpy(),
        jax_ops.unpack_capacity(yb, rorder, rslots, n))
    np.testing.assert_array_equal(
        ops.unpack_capacity(xb, order, slots, n).numpy(), tokens)


def test_pack_capacity_rejects_dropping_capacity():
    with pytest.raises(ValueError):
        ops.pack_capacity(torch.ones(10, 4), torch.zeros(10, dtype=torch.long),
                          1, capacity=8)  # 10 rows won't fit


def test_pack_multi_equals_reference_and_merged_is_bitwise_per_region():
    """Merging regions into one capacity buffer changes WHERE a row sits,
    never its reduction order: merged == per-region, bit for bit, through a
    real expert FFN; and the packing equals the reference's numpy packing."""
    experts, _, kw = _ffn_setup(seed=7, L=2, E=4, d=16, f=32)
    cfg = ModelConfig(dtype=torch.float32, **kw)
    tex = {k: _t(v) for k, v in experts.items()}
    lid = torch.tensor([1], dtype=torch.int32)
    rng = np.random.RandomState(7)
    sizes = [5, 1, 12, 3]
    token_list = [rng.randn(n, 16).astype(np.float32) for n in sizes]
    eid_list = [rng.randint(0, 4, n) for n in sizes]

    def ffn(xb):
        return ops.super_moe_ffn(lid, tex, xb, cfg)

    xb, order, slots, C, bounds = ops.pack_capacity_multi(
        [_t(t) for t in token_list], [_t(e) for e in eid_list], 4)
    rxb, rorder, rslots, rC, rbounds = jax_ops.pack_capacity_multi(
        token_list, eid_list, 4)
    assert C == rC and list(bounds) == list(rbounds)
    np.testing.assert_array_equal(xb.numpy(), rxb)
    np.testing.assert_array_equal(order.numpy(), rorder)
    np.testing.assert_array_equal(slots.numpy(), rslots)
    outs = ops.unpack_capacity_multi(ffn(xb), order, slots, bounds)
    routs = jax_ops.unpack_capacity_multi(ffn(xb).numpy(), rorder, rslots,
                                          rbounds)
    for o, r in zip(outs, routs):
        np.testing.assert_array_equal(o.numpy(), r)
    for r, (tokens, eids) in enumerate(zip(token_list, eid_list)):
        for cap in (C, None):
            xb1, o1, s1, _ = ops.pack_capacity(_t(tokens), _t(eids), 4,
                                               capacity=cap)
            one = ops.unpack_capacity(ffn(xb1), o1, s1, len(tokens))
            assert torch.equal(outs[r], one)
    with pytest.raises(ValueError):
        ops.pack_capacity_multi([], [], 4)


# ---------------------------------------------------------- flash attention

_CASES = [dict(causal=True), dict(causal=True, window=24),
          dict(causal=True, softcap=30.0),
          dict(causal=True, window=16, softcap=20.0), dict(causal=False)]


@pytest.mark.parametrize("kw", _CASES, ids=lambda k: "-".join(
    f"{a}{b}" for a, b in k.items()))
@pytest.mark.parametrize("S,dh", [(192, 32), (64, 16)])
def test_flash_attention_matches_jax_kernel_and_ref(kw, S, dh):
    """fp32 at 2e-5 (softmax sums in another order), incl. S=192."""
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(3, S, dh).astype(np.float32) for _ in range(3))
    got = flash_attention(_t(q), _t(k), _t(v), **kw)
    _close(got, jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), **kw), 2e-5)
    _close(got, jax_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw), 2e-5)
    _close(got, attention_ref(_t(q), _t(k), _t(v), **kw), 1e-6)


@pytest.mark.parametrize("H,KVH", [(4, 4), (4, 2), (8, 1)])
def test_mha_flash_gqa_matches_jax(H, KVH):
    rng = np.random.RandomState(4)
    q = rng.randn(2, 48, H, 32).astype(np.float32)
    k = rng.randn(2, 48, KVH, 32).astype(np.float32)
    v = rng.randn(2, 48, KVH, 32).astype(np.float32)
    got = mha_flash(_t(q), _t(k), _t(v), window=20)
    want = jax_mha_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         window=20)
    assert got.shape == (2, 48, H, 32)
    _close(got, want, 2e-5)


def test_cuda_tensors_never_take_the_plain_version():
    """On a CUDA tensor a wrapper launches its kernel or raises; only a CPU
    tensor takes the plain version.  Without a card the CUDA branch cannot
    run here, so check its guards: inputs split across devices raise."""
    meta = torch.zeros(2, 8, 16, device="meta")
    with pytest.raises(ValueError):
        super_gmm(torch.tensor([0], dtype=torch.int32),
                  torch.zeros(1, 2, 16, 4, device="meta"), meta)
    with pytest.raises(ValueError):
        flash_attention(meta, meta, meta)
