"""The encoder-decoder family (seamless_m4t_large_v2) behind the model API
against the JAX package, on the same bridged params and numpy inputs, at
its `.smoke()` config in fp32 on the CPU: the encoder block (its q-block
and dense branches), cross attention, the decoder block with `memory=`
(forward, prefill, decode), `encode`, `encdec_forward` / `_prefill` /
`_decode_step` / `_loss` (the decoder's self attention at S > attn_chunk
on the flash wrapper's plain path), `init_encdec_caches`, the parameter
counts and `build_api`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (close, close_trees, family_setup, jit, t,
                         tree_leaves)
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import encdec as jed
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.models import api, attention, blocks, common
from repro_torch.models import encdec as ed

ARCH = "seamless_m4t_large_v2"
LOGIT_TOL, CACHE_TOL = 1e-4, 5e-5
DECODE_VS_FORWARD_TOL = 2e-3


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


def _setup():
    return family_setup(ARCH)


def _block(init, seed, **kw):
    jcfg, _, cfg, _ = _setup()
    jp = init(jax.random.PRNGKey(seed), jcfg, **kw)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                            "cpu")


# ------------------------------------------------------------ blocks --

@pytest.mark.parametrize("S", [32, 40, 64])
def test_encoder_block_matches_jax(S):
    """attn_chunk is 32: S=64 runs the query blocks, S=32 (not longer than a
    block) and S=40 (not a multiple) the dense branch."""
    jcfg, cfg, jp, p = _block(jblocks.init_encoder_block_params, 50)
    h = _rand(51, 2, S, cfg.d_model, scale=0.5)
    close(blocks.encoder_block_forward(p, t(h), cfg),
          jit(jblocks.encoder_block_forward, cfg=jcfg)(jp, jnp.asarray(h)),
          LOGIT_TOL)


def test_cross_attention_matches_jax():
    jcfg, cfg, jp, p = _block(jattn.init_attention_params, 52, cross=True)
    x = _rand(53, 2, 9, cfg.d_model)
    mem = _rand(54, 2, 23, cfg.d_model)
    close(attention.cross_attention_forward(p, t(x), t(mem), cfg),
          jit(jattn.cross_attention_forward, cfg=jcfg)(
              jp, jnp.asarray(x), jnp.asarray(mem)), 2e-5)


@pytest.mark.parametrize("S", [16, 48])
def test_decoder_block_with_memory_matches_jax(S):
    """Forward and prefill over S tokens attending to a 40-frame memory
    (S=48 > attn_chunk: the flash plain path), then 3 decodes: h and the
    KV cache == the reference's, the cache written in place."""
    jcfg, cfg, jp, p = _block(jblocks.init_decoder_block_params, 55,
                              cross=True)
    B, steps = 2, 3
    h = _rand(56, B, S + steps, cfg.d_model, scale=0.5)
    mem = _rand(57, B, 40, cfg.d_model, scale=0.5)
    got, _ = blocks.decoder_block_forward(p, t(h[:, :S]), cfg, memory=t(mem))
    want, _ = jit(jblocks.decoder_block_forward, cfg=jcfg)(
        jp, jnp.asarray(h[:, :S]), memory=jnp.asarray(mem))
    close(got, want, LOGIT_TOL)
    y, cache = blocks.decoder_block_prefill(p, t(h[:, :S]), cfg,
                                            max_len=S + steps, memory=t(mem))
    jy, jcache = jit(jblocks.decoder_block_prefill, cfg=jcfg,
                     max_len=S + steps)(jp, jnp.asarray(h[:, :S]),
                                        memory=jnp.asarray(mem))
    close(y, jy, LOGIT_TOL)
    close_trees(cache, jcache, CACHE_TOL)
    jdec = jit(jblocks.decoder_block_decode, cfg=jcfg)
    for i in range(S, S + steps):
        y, c2 = blocks.decoder_block_decode(p, t(h[:, i:i + 1]), cache, cfg,
                                            memory=t(mem))
        jy, jcache = jdec(jp, jnp.asarray(h[:, i:i + 1]), jcache,
                          memory=jnp.asarray(mem))
        assert c2 is cache
        close(y, jy, LOGIT_TOL)
        close_trees(cache, jcache, CACHE_TOL)


# ------------------------------------------------------- whole model --

@pytest.mark.parametrize("S_enc", [40, 64])
def test_encode_matches_jax(S_enc):
    """Both encoder branches through the whole stack and its final norm."""
    jcfg, jparams, cfg, params = _setup()
    emb = _rand(58, 2, S_enc, cfg.d_model, scale=0.02)
    close(ed.encode(params, t(emb), cfg),
          jit(jed.encode, cfg=jcfg)(jparams, jnp.asarray(emb)), LOGIT_TOL)


@pytest.mark.parametrize("S_dec", [16, 48])
def test_encdec_forward_matches_jax(S_dec):
    """S_dec=48 > attn_chunk: the decoder's self attention on the flash
    wrapper's plain path against the reference's chunked path."""
    jcfg, jparams, cfg, params = _setup()
    emb = _rand(59, 2, 64, cfg.d_model, scale=0.02)
    dec = _tokens(cfg, 2, S_dec, 60)
    got = ed.encdec_forward(params, t(emb), t(dec), cfg)
    want = jit(jed.encdec_forward, cfg=jcfg)(jparams, jnp.asarray(emb),
                                             jnp.asarray(dec))
    assert got.shape == (2, S_dec, cfg.vocab_size)
    close(got, want, LOGIT_TOL)
    dense = ed.encdec_forward(params, t(emb), t(dec), cfg, use_dense=True)
    close(dense, got, LOGIT_TOL)


def test_prefill_then_decode_matches_jax():
    """encdec_prefill of 40 decoder tokens over 64 frames (decoder on the
    flash plain path), then 6 greedy encdec_decode_steps: logits within
    1e-4 and memory and caches within 5e-5 of the reference's at every
    step; the step hands back the same state."""
    jcfg, jparams, cfg, params = _setup()
    S, steps = 40, 6
    emb = _rand(61, 2, 64, cfg.d_model, scale=0.02)
    dec = _tokens(cfg, 2, S, 62)
    logits, state = ed.encdec_prefill(params, t(emb), t(dec), cfg,
                                      max_len=S + steps)
    jlogits, jstate = jit(jed.encdec_prefill, cfg=jcfg, max_len=S + steps)(
        jparams, jnp.asarray(emb), jnp.asarray(dec))
    close(logits, jlogits, LOGIT_TOL)
    close_trees(state, jstate, CACHE_TOL)
    jdec = jit(jed.encdec_decode_step, cfg=jcfg)
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jlogits, -1), np.int32)
        logits, state2 = ed.encdec_decode_step(params, cfg, state, t(tok))
        jlogits, jstate = jdec(jparams, state=jstate, token=jnp.asarray(tok))
        assert state2 is state
        close(logits, jlogits, LOGIT_TOL)
        close_trees(state, jstate, CACHE_TOL)
    assert [int(x) for x in state[1].length] == [S + steps] * len(
        state[1].length)


def test_decode_matches_forward_and_consumes_caches_in_place():
    """The port alone: each greedy step's logits == encdec_forward's last
    position over the decoder tokens so far, at 2e-3; the step writes k/v
    and lengths in place (data_ptr unchanged) and leaves the memory as
    it was."""
    _, _, cfg, params = _setup()
    emb = t(_rand(63, 2, 64, cfg.d_model, scale=0.02))
    seq = t(_tokens(cfg, 2, 40, 64))
    logits, state = ed.encdec_prefill(params, emb, seq, cfg, max_len=46)
    leaves = tree_leaves(state)
    ptrs = [x.data_ptr() for x in leaves]
    memory = state[0].clone()
    for _ in range(6):
        tok = torch.argmax(logits, -1)
        seq = torch.cat([seq, tok[:, None]], 1)
        logits, state = ed.encdec_decode_step(params, cfg, state, tok)
        close(logits, ed.encdec_forward(params, emb, seq, cfg)[:, -1],
              DECODE_VS_FORWARD_TOL)
    assert [x.data_ptr() for x in tree_leaves(state)] == ptrs
    assert torch.equal(state[0], memory)


@pytest.mark.parametrize("ce_block", [16, 512])
def test_encdec_loss_matches_jax(ce_block):
    """Three CE blocks of 16 over 48 decoder tokens, or one."""
    jcfg, jparams, cfg, params = _setup()
    emb = _rand(65, 2, 64, cfg.d_model, scale=0.02)
    dec, labels = _tokens(cfg, 2, 48, 66), _tokens(cfg, 2, 48, 67)
    ce, m = ed.encdec_loss(params, cfg, t(emb), t(dec), t(labels),
                           ce_block=ce_block)
    jce, jm = jit(jed.encdec_loss, cfg=jcfg, ce_block=ce_block)(
        jparams, enc_embeddings=jnp.asarray(emb), dec_tokens=jnp.asarray(dec),
        labels=jnp.asarray(labels))
    close(ce, jce, 1e-5)
    assert sorted(m) == sorted(jm) == ["ce"]
    close(m["ce"], jm["ce"], 1e-5)


def test_init_encdec_caches_match_jax_and_prefill():
    """Shapes and dtypes == the reference's init_encdec_caches and ==
    encdec_prefill's state; zeros; every length the prefilled count."""
    jcfg, _, cfg, params = _setup()
    B, S, S_enc, max_len = 2, 20, 64, 40
    got = ed.init_encdec_caches(cfg, B, max_len, S_enc, prefilled=S,
                                device="cpu")
    want = jed.init_encdec_caches(jcfg, B, max_len, S_enc, prefilled=S)
    _, pre = ed.encdec_prefill(
        params, t(_rand(68, B, S_enc, cfg.d_model, scale=0.02)),
        t(_tokens(cfg, B, S, 69)), cfg, max_len=max_len)
    g, w, p = tree_leaves(got), tree_leaves(want), tree_leaves(pre)
    assert len(g) == len(w) == len(p) == 4
    for a, b, c in zip(g, w, p):
        assert tuple(a.shape) == tuple(b.shape) == tuple(c.shape)
        assert a.dtype == c.dtype
        assert str(a.dtype).replace("torch.", "") == jnp.dtype(b.dtype).name
        if a.dtype == torch.int32:
            assert torch.equal(a, torch.full_like(a, S))
        else:
            assert not a.any()


def test_param_counts_and_init_match_jax():
    """param_count / active_param_count == the reference's; the port's own
    init gives the reference's tree, shapes and dtypes, seeded."""
    jcfg, jparams, cfg, params = _setup()
    assert common.param_count(params) == jcommon.param_count(jparams)
    assert common.active_param_count(params, cfg) \
        == jcommon.active_param_count(jparams, jcfg)
    mine = ed.init_encdec_params(torch.Generator().manual_seed(3), cfg)
    ja = jax.tree.map(lambda a: (tuple(a.shape), jnp.dtype(a.dtype).name),
                      jparams)
    pa = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                      params_to_numpy(mine))
    assert jax.tree.structure(ja) == jax.tree.structure(pa)
    assert jax.tree.leaves(ja) == jax.tree.leaves(pa)
    again = ed.init_encdec_params(torch.Generator().manual_seed(3), cfg)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(mine),
                                                 tree_leaves(again)))


def test_decoder_len_matches_reference():
    for s in (1, 40, 511, 512, 1000, 16384):
        assert ed.decoder_len(s) == jed.decoder_len(s)
    assert ed.decoder_len(16384) == 2048


def test_build_api_equals_direct_calls_and_jax():
    """make_batch's shapes; forward / loss / prefill / decode through the
    API == the direct calls (torch.equal) and within the tolerances above
    of the JAX API; make_caches has prefill's shapes."""
    jcfg, jparams, cfg, params = _setup()
    a, ja = api.build_api(cfg), japi.build_api(jcfg)
    gen = torch.Generator().manual_seed(1)
    b = a.make_batch(gen, 64, 2, "train", device="cpu")
    assert sorted(b) == ["dec_tokens", "enc_embeddings", "labels"]
    assert b["enc_embeddings"].shape == (2, 64, cfg.d_model)
    assert b["enc_embeddings"].dtype == cfg.dtype
    assert b["dec_tokens"].shape == b["labels"].shape == (2, 64)
    assert sorted(a.make_batch(gen, 64, 2, "prefill", device="cpu")) \
        == ["dec_tokens", "enc_embeddings"]
    assert a.make_batch(gen, 64, 2, "decode", device="cpu")["token"].shape \
        == (2,)
    b["max_len"] = 70
    jb = {k: jnp.asarray(v.numpy()) for k, v in b.items() if k != "max_len"}
    enc, dec = b["enc_embeddings"], b["dec_tokens"]
    logits, aux = a.forward(params, b)
    assert aux is None
    assert torch.equal(logits, ed.encdec_forward(params, enc, dec, cfg))
    close(logits, jax.jit(ja.forward)(jparams, jb)[0], LOGIT_TOL)
    loss, _ = a.loss(params, b)
    assert torch.equal(loss, ed.encdec_loss(params, cfg, enc, dec,
                                            b["labels"])[0])
    close(loss, jax.jit(ja.loss)(jparams, jb)[0], 1e-5)
    last, state = a.prefill(params, b)
    dlast, dstate = ed.encdec_prefill(params, enc, dec, cfg, max_len=70)
    assert torch.equal(last, dlast)
    jlast, jstate = jax.jit(lambda p, x: ja.prefill(p, {**x, "max_len": 70}))(
        jparams, jb)
    close(last, jlast, LOGIT_TOL)
    jdec = jax.jit(ja.decode)
    for _ in range(3):
        tok = torch.argmax(last, -1)
        last, state = a.decode(params, state, {"token": tok})
        dlast, dstate = ed.encdec_decode_step(params, cfg, dstate, tok)
        jlast, jstate = jdec(jparams, jstate,
                             {"token": jnp.asarray(tok.numpy())})
        assert torch.equal(last, dlast)
        close(last, jlast, LOGIT_TOL)
    close_trees(state, jstate, CACHE_TOL)
    made = a.make_caches(2, 70, 64, enc_len=64, device="cpu")
    assert [x.shape for x in tree_leaves(made)] \
        == [x.shape for x in tree_leaves(state)]
