"""The recurrent (rwkv6) and hybrid (zamba2: Mamba2 + shared attention)
families behind the model API against the JAX package, on the same bridged
params and numpy inputs, fp32 on the CPU: the chunked WKV and SSD scans
(against the reference's and the port's own sequential oracles, at
tests/test_ssm.py's tolerances), the rwkv, mamba and shared-attention
blocks (forward, prefill, decode), the whole models at the `.smoke()`
configs (`lm_forward`, `lm_prefill` + decode steps, `init_caches`,
`lm_loss`, `build_api`; at S > attn_chunk zamba's attention takes the
flash wrapper's plain path), the fp32 leaves of the bridge and the decode's
in-place state."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (close, close_trees, family_setup, jit, t,
                         tree_leaves)
from repro.models import api as japi
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import mamba2 as jmamba
from repro.models import rwkv6 as jrwkv
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.models import api, blocks, common, lm, mamba2, rwkv6

ARCHS = ["rwkv6_7b", "zamba2_1p2b"]
LOGIT_TOL, CACHE_TOL = 1e-4, 5e-5
WKV_TOL, SSD_TOL = 3e-4, 2e-4  # tests/test_ssm.py's
DECODE_VS_FORWARD_TOL = 2e-3  # tests/test_ssm.py's


@pytest.fixture(autouse=True)
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S))


def _bridge(jp, cfg):
    return params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")


# ------------------------------------------------------------- scans --

SCAN_CASES = [(16, 8), (37, 8), (37, 16), (64, 16)]


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("S,chunk", SCAN_CASES)
def test_wkv_chunked_matches_jax_and_sequential(S, chunk, carry):
    """Chunked against the reference's chunked and the port's sequential
    oracle (the sequential path meets the reference's in the block tests).
    S=37 pads a tail to the chunk; `carry` starts from a random state."""
    B, H, P = 2, 3, 8
    r, k, v = (_rand(i, B, S, H, P) for i in (1, 2, 3))
    logw = -np.abs(_rand(4, B, S, H, P)) * 0.5 - 0.01
    u = _rand(5, H, P, scale=0.5)
    s0 = _rand(6, B, H, P, P) if carry else None
    ts0 = None if s0 is None else t(s0)
    y, s = rwkv6.wkv_chunked(t(r), t(k), t(v), t(logw), t(u), chunk, ts0)
    jy, js = jit(jrwkv.wkv_chunked, chunk=chunk)(
        *map(jnp.asarray, (r, k, v, logw, u)),
        initial_state=None if s0 is None else jnp.asarray(s0))
    close(y, jy, WKV_TOL)
    close(s, js, WKV_TOL)
    ys, ss = rwkv6.wkv_sequential(t(r), t(k), t(v), t(logw), t(u), ts0)
    close(y, ys, WKV_TOL)
    close(s, ss, WKV_TOL)


def test_wkv_strong_decay_stable():
    """The clamped factorization stays finite under strong decay (logw near
    the clip bound), and equals the reference's there."""
    B, S, H, P = 1, 64, 2, 8
    r, k, v = (_rand(i, B, S, H, P) for i in (7, 8, 9))
    logw = np.full((B, S, H, P), -7.5, np.float32)
    u = np.zeros((H, P), np.float32)
    y, s = rwkv6.wkv_chunked(t(r), t(k), t(v), t(logw), t(u), 32)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    jy, js = jit(jrwkv.wkv_chunked, chunk=32)(
        *map(jnp.asarray, (r, k, v, logw, u)))
    close(y, jy, WKV_TOL)
    close(s, js, WKV_TOL)


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("S,chunk", SCAN_CASES)
def test_ssd_chunked_matches_jax_and_sequential(S, chunk, carry):
    """As the WKV test, for the SSD scan."""
    b, H, P, N = 2, 3, 4, 5
    x = _rand(10, b, S, H, P)
    a_log = -np.abs(_rand(11, b, S, H)) * 0.3
    Bm, Cm = _rand(12, b, S, N), _rand(13, b, S, N)
    s0 = _rand(14, b, H, P, N) if carry else None
    ts0 = None if s0 is None else t(s0)
    js0 = None if s0 is None else jnp.asarray(s0)
    y, s = mamba2.ssd_chunked(t(x), t(a_log), t(Bm), t(Cm), chunk, ts0)
    jy, js = jit(jmamba.ssd_chunked, chunk=chunk)(
        *map(jnp.asarray, (x, a_log, Bm, Cm)), initial_state=js0)
    close(y, jy, SSD_TOL)
    close(s, js, SSD_TOL)
    ys, ss = mamba2.ssd_sequential(t(x), t(a_log), t(Bm), t(Cm), ts0)
    close(y, ys, SSD_TOL)
    close(s, ss, SSD_TOL)


def test_causal_conv_and_segsum_match_jax():
    x, w, b = _rand(15, 2, 9, 6), _rand(16, 4, 6), _rand(17, 6)
    close(mamba2._causal_conv(t(x), t(w), t(b)),
          jmamba._causal_conv(*map(jnp.asarray, (x, w, b))), 1e-6)
    a = -np.abs(_rand(18, 2, 3, 7))
    close(torch.exp(mamba2._segsum(t(a))),
          jnp.exp(jmamba._segsum(jnp.asarray(a))), 1e-6)


# ------------------------------------------------------------ blocks --

def _rwkv_cfgs():
    jcfg, _, cfg, _ = family_setup("rwkv6_7b")
    return jcfg, cfg


@pytest.mark.parametrize("S", [37])
def test_rwkv_block_matches_jax(S):
    """Forward (chunked and sequential), prefill (h and RWKVState; S=37
    pads the last chunk), then 4 one-token decodes continuing from the
    prefill: each h and state == the reference's; the state comes back as
    the same tensors."""
    jcfg, cfg = _rwkv_cfgs()
    jp = jblocks.init_rwkv_block_params(jax.random.PRNGKey(20), jcfg)
    p = _bridge(jp, cfg)
    B, steps = 2, 4
    h = _rand(21, B, S + steps, cfg.d_model, scale=0.5)
    for seq in (False, True):
        close(blocks.rwkv_block_forward(p, t(h[:, :S]), cfg, sequential=seq),
              jit(jblocks.rwkv_block_forward, cfg=jcfg, sequential=seq)(
                  jp, jnp.asarray(h[:, :S])), LOGIT_TOL)
    y, st = blocks.rwkv_block_prefill(p, t(h[:, :S]), cfg)
    jy, jst = jit(jblocks.rwkv_block_prefill, cfg=jcfg)(
        jp, jnp.asarray(h[:, :S]))
    jdec = jit(jblocks.rwkv_block_decode, cfg=jcfg)
    close(y, jy, LOGIT_TOL)
    close_trees(st, jst, CACHE_TOL)
    ptrs = [a.data_ptr() for a in st]
    for i in range(S, S + steps):
        y, st2 = blocks.rwkv_block_decode(p, t(h[:, i:i + 1]), st, cfg)
        jy, jst = jdec(jp, jnp.asarray(h[:, i:i + 1]), jst)
        assert st2 is st and [a.data_ptr() for a in st] == ptrs
        close(y, jy, LOGIT_TOL)
        close_trees(st, jst, CACHE_TOL)


def test_rwkv_block_decode_matches_forward():
    """tests/test_ssm.py's check on the port: 16 decodes from a zero state
    == the sequential forward at 2e-3."""
    jcfg, cfg = _rwkv_cfgs()
    p = _bridge(jblocks.init_rwkv_block_params(jax.random.PRNGKey(22), jcfg),
                cfg)
    B, S = 2, 16
    h = t(_rand(23, B, S, cfg.d_model, scale=0.5))
    full = blocks.rwkv_block_forward(p, h, cfg, sequential=True)
    st = rwkv6.init_rwkv_state(cfg, B, "cpu")
    outs = [blocks.rwkv_block_decode(p, h[:, i:i + 1], st, cfg)[0][:, 0]
            for i in range(S)]
    close(torch.stack(outs, 1), full, DECODE_VS_FORWARD_TOL)


def _zamba_cfgs():
    jcfg, _, cfg, _ = family_setup("zamba2_1p2b")
    return jcfg, cfg


@pytest.mark.parametrize("S", [2, 37])
def test_mamba_block_matches_jax(S):
    """Forward (chunked and sequential), prefill (S=2 < W-1 pads the conv
    ring on the left), then 4 one-token decodes: each h and MambaState ==
    the reference's, the state written in place."""
    jcfg, cfg = _zamba_cfgs()
    jp = jblocks.init_mamba_block_params(jax.random.PRNGKey(24), jcfg)
    p = _bridge(jp, cfg)
    B, steps = 2, 4
    h = _rand(25, B, S + steps, cfg.d_model, scale=0.5)
    for seq in (False, True):
        close(blocks.mamba_block_forward(p, t(h[:, :S]), cfg,
                                         sequential=seq),
              jit(jblocks.mamba_block_forward, cfg=jcfg, sequential=seq)(
                  jp, jnp.asarray(h[:, :S])), LOGIT_TOL)
    y, st = blocks.mamba_block_prefill(p, t(h[:, :S]), cfg)
    jy, jst = jit(jblocks.mamba_block_prefill, cfg=jcfg)(
        jp, jnp.asarray(h[:, :S]))
    jdec = jit(jblocks.mamba_block_decode, cfg=jcfg)
    close(y, jy, LOGIT_TOL)
    close_trees(st, jst, CACHE_TOL)
    ptrs = [a.data_ptr() for a in st]
    for i in range(S, S + steps):
        y, st2 = blocks.mamba_block_decode(p, t(h[:, i:i + 1]), st, cfg)
        jy, jst = jdec(jp, jnp.asarray(h[:, i:i + 1]), jst)
        assert st2 is st and [a.data_ptr() for a in st] == ptrs
        close(y, jy, LOGIT_TOL)
        close_trees(st, jst, CACHE_TOL)


def test_mamba_decode_matches_forward_and_prefill_state_continues():
    """tests/test_ssm.py's two checks on the port, at 2e-3: 12 decodes from
    a zero state == the sequential forward; a decode from the prefill's
    state == the forward's next position."""
    jcfg, cfg = _zamba_cfgs()
    p = _bridge(jmamba.init_mamba_params(jax.random.PRNGKey(26), jcfg), cfg)
    B, S = 2, 12
    u = t(_rand(27, B, S + 1, cfg.d_model, scale=0.5))
    full = mamba2.mamba_forward(p, u[:, :S], cfg, sequential=True)
    st = mamba2.init_mamba_state(cfg, B, "cpu")
    outs = [mamba2.mamba_decode(p, u[:, i:i + 1], st, cfg)[0][:, 0]
            for i in range(S)]
    close(torch.stack(outs, 1), full, DECODE_VS_FORWARD_TOL)
    nxt = mamba2.mamba_forward(p, u, cfg)[:, S]
    _, st = mamba2.mamba_forward(p, u[:, :S], cfg, return_state=True)
    y, _ = mamba2.mamba_decode(p, u[:, S:S + 1], st, cfg)
    close(y[:, 0], nxt, DECODE_VS_FORWARD_TOL)


@pytest.mark.parametrize("S", [16, 48])
def test_shared_attn_block_matches_jax(S):
    """Zamba's shared block on concat(h, emb): forward (S=48 > attn_chunk
    through the flash wrapper's plain version against the reference's
    chunked path), prefill and 3 decodes with the KV cache in place."""
    jcfg, cfg = _zamba_cfgs()
    jp = jblocks.init_shared_attn_params(jax.random.PRNGKey(28), jcfg)
    p = _bridge(jp, cfg)
    B, steps = 2, 3
    h = _rand(29, B, S + steps, cfg.d_model, scale=0.5)
    emb = _rand(30, B, S + steps, cfg.d_model, scale=0.5)
    close(blocks.shared_attn_forward(p, t(h[:, :S]), t(emb[:, :S]), cfg),
          jit(jblocks.shared_attn_forward, cfg=jcfg)(
              jp, jnp.asarray(h[:, :S]), jnp.asarray(emb[:, :S])),
          LOGIT_TOL)
    y, cache = blocks.shared_attn_prefill(p, t(h[:, :S]), t(emb[:, :S]), cfg,
                                          max_len=S + steps)
    jy, jcache = jit(jblocks.shared_attn_prefill, cfg=jcfg,
                     max_len=S + steps)(jp, jnp.asarray(h[:, :S]),
                                        jnp.asarray(emb[:, :S]))
    jdec = jit(jblocks.shared_attn_decode, cfg=jcfg)
    close(y, jy, LOGIT_TOL)
    close_trees(cache, jcache, CACHE_TOL)
    for i in range(S, S + steps):
        y, c2 = blocks.shared_attn_decode(p, t(h[:, i:i + 1]),
                                          t(emb[:, i:i + 1]), cache, cfg)
        jy, jcache = jdec(jp, jnp.asarray(h[:, i:i + 1]),
                          jnp.asarray(emb[:, i:i + 1]), jcache)
        assert c2 is cache
        close(y, jy, LOGIT_TOL)
        close_trees(cache, jcache, CACHE_TOL)


# ------------------------------------------------------ whole models --

@pytest.mark.parametrize("S", [16, 48])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_matches_jax(arch, S):
    """S=48 > attn_chunk (32): zamba's shared attention takes the flash
    wrapper's plain path against the reference's chunked path."""
    jcfg, jparams, cfg, params = family_setup(arch)
    tokens = _tokens(cfg, 2, S, 40)
    got, aux = lm.lm_forward(params, cfg, t(tokens))
    want, jaux = jit(jlm.lm_forward, cfg=jcfg)(jparams,
                                               tokens=jnp.asarray(tokens))
    assert got.shape == (2, S, cfg.vocab_size)
    close(got, want, LOGIT_TOL)
    close(aux.load_balance_loss, jaux.load_balance_loss, 1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_jax(arch):
    """lm_prefill of 40 tokens (> attn_chunk: zamba's attention on the flash
    plain path), then 6 greedy lm_decode_steps: logits at every step within
    1e-4, every cache leaf (KV, WKV and SSM states, shift tokens, conv
    rings, lengths) within 5e-5 of the reference's."""
    jcfg, jparams, cfg, params = family_setup(arch)
    S, steps = 40, 6
    tokens = _tokens(cfg, 2, S, 41)
    logits, caches = lm.lm_prefill(params, cfg, t(tokens), max_len=S + steps)
    jlogits, jcaches = jit(jlm.lm_prefill, cfg=jcfg, max_len=S + steps)(
        jparams, tokens=jnp.asarray(tokens))
    close(logits, jlogits, LOGIT_TOL)
    close_trees(caches, jcaches, CACHE_TOL)
    jdec = jit(jlm.lm_decode_step, cfg=jcfg)
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jlogits, -1), np.int32)
        logits, caches = lm.lm_decode_step(params, cfg, caches, t(tok))
        jlogits, jcaches = jdec(jparams, caches=jcaches,
                                token=jnp.asarray(tok))
        close(logits, jlogits, LOGIT_TOL)
        close_trees(caches, jcaches, CACHE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port alone: each greedy step's logits == lm_forward's last
    position over the prompt plus the tokens so far, at 2e-3."""
    _, _, cfg, params = family_setup(arch)
    seq = t(_tokens(cfg, 2, 40, 42))
    logits, caches = lm.lm_prefill(params, cfg, seq, max_len=46)
    for _ in range(6):
        tok = torch.argmax(logits, -1)
        seq = torch.cat([seq, tok[:, None]], 1)
        logits, caches = lm.lm_decode_step(params, cfg, caches, tok)
        close(logits, lm.lm_forward(params, cfg, seq)[0][:, -1],
              DECODE_VS_FORWARD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_consumes_state_in_place(arch):
    """The step writes every recurrent state (and zamba's KV caches) through
    layer views: the same objects come back, no leaf is reallocated
    (data_ptr unchanged), and every float leaf changed."""
    _, _, cfg, params = family_setup(arch)
    _, caches = lm.lm_prefill(params, cfg, t(_tokens(cfg, 2, 20, 43)),
                              max_len=24)
    leaves = tree_leaves(caches)
    ptrs = [x.data_ptr() for x in leaves]
    before = [x.clone() for x in leaves]
    _, new = lm.lm_decode_step(params, cfg, caches,
                               torch.tensor([1, 2], dtype=torch.int32))
    assert new is caches
    now = tree_leaves(new)
    assert all(a is b for a, b in zip(now, leaves))
    assert [x.data_ptr() for x in now] == ptrs
    for was, x in zip(before, now):
        if x.dtype == torch.int32:
            assert torch.equal(x, was + 1)
        else:
            assert not torch.equal(x, was)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_match_jax_and_prefill(arch):
    """Shapes and dtypes == the reference's init_caches and == lm_prefill's
    caches; zeros, every length the prefilled count."""
    jcfg, _, cfg, params = family_setup(arch)
    B, S, max_len = 2, 20, 40
    got = lm.init_caches(cfg, B, max_len, prefilled=S, device="cpu")
    want = jlm.init_caches(jcfg, B, max_len, prefilled=S)
    _, pre = lm.lm_prefill(params, cfg, t(_tokens(cfg, B, S, 44)),
                           max_len=max_len)
    g, w, p = tree_leaves(got), tree_leaves(want), tree_leaves(pre)
    assert len(g) == len(w) == len(p)
    for a, b, c in zip(g, w, p):
        assert tuple(a.shape) == tuple(b.shape) == tuple(c.shape)
        name = str(a.dtype).replace("torch.", "")
        assert name == jnp.dtype(b.dtype).name == str(c.dtype).replace(
            "torch.", "")
        if a.dtype == torch.int32:
            assert torch.equal(a, torch.full_like(a, S))
        else:
            assert not a.any()


@pytest.mark.parametrize("ce_block", [16, 512])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_jax(arch, ce_block):
    jcfg, jparams, cfg, params = family_setup(arch)
    tokens, labels = _tokens(cfg, 2, 48, 45), _tokens(cfg, 2, 48, 46)
    loss, m = lm.lm_loss(params, cfg, t(tokens), t(labels),
                         ce_block=ce_block)
    jloss, jm = jit(jlm.lm_loss, cfg=jcfg, ce_block=ce_block)(
        jparams, tokens=jnp.asarray(tokens), labels=jnp.asarray(labels))
    close(loss, jloss, 1e-5)
    assert sorted(m) == sorted(jm)
    for k in m:
        close(m[k], jm[k], 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_init_match_jax(arch):
    """param_count / active_param_count == the reference's; the port's own
    init gives the reference's tree, shapes and dtypes leaf for leaf (the
    fp32 leaves fp32), and is seeded."""
    jcfg, jparams, cfg, params = family_setup(arch)
    assert common.param_count(params) == jcommon.param_count(jparams)
    assert common.active_param_count(params, cfg) \
        == jcommon.active_param_count(jparams, jcfg)
    mine = lm.init_lm_params(torch.Generator().manual_seed(3), cfg)
    ja = jax.tree.map(lambda a: (tuple(a.shape), jnp.dtype(a.dtype).name),
                      jparams)
    pa = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                      params_to_numpy(mine))
    assert jax.tree.structure(ja) == jax.tree.structure(pa)
    assert jax.tree.leaves(ja) == jax.tree.leaves(pa)
    again = lm.init_lm_params(torch.Generator().manual_seed(3), cfg)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(mine),
                                                 tree_leaves(again)))


# The leaves the reference keeps fp32 under any cfg.dtype, per family
FP32 = {"rwkv6_7b": [("time_mix", "w_base"), ("time_mix", "u")],
        "zamba2_1p2b": [("mamba", "A_log"), ("mamba", "dt_bias"),
                        ("mamba", "D")]}


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_and_init_keep_fp32_leaves_under_bf16(arch):
    """Under a bf16 config the bridge and the port's init keep the
    reference's fp32 leaves fp32 (values exact) and round the rest;
    bf16 init is the reference's dtype tree leaf for leaf."""
    jcfg, jparams, cfg, _ = family_setup(arch)
    bf = cfg.replace(dtype=torch.bfloat16)
    np_tree = jax.tree.map(np.asarray, jparams)
    got = params_from_numpy(np_tree, bf, "cpu")
    blk = got["stages"][0]
    for parent, key in FP32[arch]:
        leaf = blk[parent][key]
        assert leaf.dtype == torch.float32, (parent, key)
        np.testing.assert_array_equal(
            leaf.numpy(), np_tree["stages"][0][parent][key])
    assert got["embed"].dtype == torch.bfloat16
    if arch == "rwkv6_7b":
        assert blk["time_mix"]["wr"].dtype == torch.bfloat16
        assert blk["ln_tm"].dtype == torch.bfloat16
    else:
        assert blk["mamba"]["in_proj"].dtype == torch.bfloat16
        assert got["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16
    jbf = jax.eval_shape(functools.partial(
        jlm.init_lm_params, cfg=jcfg.replace(dtype=jnp.bfloat16)),
        jax.random.PRNGKey(0))
    mine = lm.init_lm_params(torch.Generator().manual_seed(0), bf)
    assert [str(a.dtype).replace("torch.", "") for a in tree_leaves(mine)] \
        == [jnp.dtype(a.dtype).name for a in tree_leaves(jbf)]


@pytest.mark.parametrize("arch", ARCHS)
def test_build_api_equals_direct_calls_and_jax(arch):
    """prefill / decode / forward / loss through the API == the direct
    calls (torch.equal, the direct calls held against JAX above); prefill
    and decode within the tolerances above of the JAX API; make_caches has
    prefill's shapes."""
    jcfg, jparams, cfg, params = family_setup(arch)
    a, ja = api.build_api(cfg), japi.build_api(jcfg)
    tokens, labels = _tokens(cfg, 2, 40, 47), _tokens(cfg, 2, 40, 48)
    batch = {"tokens": t(tokens), "labels": t(labels), "max_len": 44}
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    logits, _ = a.forward(params, batch)
    assert torch.equal(logits, lm.lm_forward(params, cfg, t(tokens))[0])
    loss, _ = a.loss(params, batch)
    assert torch.equal(loss, lm.lm_loss(params, cfg, t(tokens),
                                        t(labels))[0])
    last, caches = a.prefill(params, batch)
    dlast, dcaches = lm.lm_prefill(params, cfg, t(tokens), max_len=44)
    assert torch.equal(last, dlast)
    jlast, jcaches = jax.jit(lambda p, b: ja.prefill(p, {**b, "max_len": 44}))(
        jparams, jbatch)
    close(last, jlast, LOGIT_TOL)
    jdec = jax.jit(ja.decode)
    for _ in range(3):
        tok = torch.argmax(last, -1)
        last, caches = a.decode(params, caches, {"token": tok})
        dlast, dcaches = lm.lm_decode_step(params, cfg, dcaches, tok)
        jlast, jcaches = jdec(jparams, jcaches,
                              {"token": jnp.asarray(tok.numpy())})
        assert torch.equal(last, dlast)
        close(last, jlast, LOGIT_TOL)
    close_trees(caches, jcaches, CACHE_TOL)
    made = a.make_caches(2, 44, 40, device="cpu")
    assert [x.shape for x in tree_leaves(made)] \
        == [x.shape for x in tree_leaves(caches)]

