"""The attention pieces the dense decoder families add to the port, against
the JAX package on the same numpy inputs (fp32, CPU): the scalar-length
`attention_decode` (appending and ring-buffer layers), the blocked
online-softmax oracle `chunked_causal_attention` / `_grouped_chunked_
attention`, and the flash attention wrapper's plain version at head dims
192 and 256 against the reference's Pallas kernel in interpret mode; the
head dims the wrapper offers against those the .cu instantiates."""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, t
from repro.kernels.flash_attention.flash_attention import \
    flash_attention as jax_flash_attention
from repro.models import attention as jattn
from repro.models.common import ModelConfig as JaxModelConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models.common import ModelConfig

# tests/test_attention.py's config, in both packages
_KW = dict(name="t", family="dense", num_layers=1, d_model=64, num_heads=4,
           num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
           attn_chunk=16)
JCFG = JaxModelConfig(dtype=jnp.float32, **_KW)
CFG = ModelConfig(dtype=torch.float32, **_KW)


def _attn_params(seed):
    jp = jattn.init_attention_params(jax.random.PRNGKey(seed), JCFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), CFG, "cpu")


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------ attention_decode --

@pytest.mark.parametrize("window", [None, 8])
def test_prefill_then_decode_matches_forward_and_jax(window):
    """Forward over S+1 tokens == prefill(S) + decode(1 token), as
    tests/test_attention.py holds the reference; and the decode's output
    and cache == the reference's attention_decode on the same cache."""
    jp, p = _attn_params(2)
    B, S = 2, 24
    x = _x(3, B, S + 1, CFG.d_model)
    full = attn.attention_forward(p, t(x), CFG, window=window,
                                  use_dense=True)
    _, cache = attn.attention_prefill(p, t(x[:, :S]), CFG, window=window,
                                      max_len=S + 1, use_dense=True)
    _, jcache = jattn.attention_prefill(jp, jnp.asarray(x[:, :S]), JCFG,
                                        window=window, max_len=S + 1,
                                        use_dense=True)
    dec, cache2 = attn.attention_decode(p, t(x[:, S:]), cache, CFG,
                                        window=window)
    jdec, jcache2 = jattn.attention_decode(jp, jnp.asarray(x[:, S:]), jcache,
                                           JCFG, window=window)
    close(dec[:, 0], full[:, S], 2e-4)
    close(dec, jdec, 2e-5)
    close(cache2.k, jcache2.k, 2e-5)
    close(cache2.v, jcache2.v, 2e-5)
    assert cache2 is cache  # written and advanced in place
    assert int(cache2.length) == int(jcache2.length) == S + 1


def test_decode_ring_buffer_wraps():
    """3 windows of one-token decodes from an empty ring (window 8): the
    last window's outputs == the windowed forward's, every step's output
    and cache == the reference's."""
    jp, p = _attn_params(4)
    B, W = 1, 8
    x = _x(5, B, 3 * W, CFG.d_model)
    full = attn.attention_forward(p, t(x), CFG, window=W, use_dense=True)
    cache = attn.init_kv_cache(CFG, B, max_len=3 * W, window=W)
    jcache = jattn.init_kv_cache(JCFG, B, max_len=3 * W, window=W)
    outs = []
    for i in range(3 * W):
        o, cache = attn.attention_decode(p, t(x[:, i:i + 1]), cache, CFG,
                                         window=W)
        jo, jcache = jattn.attention_decode(jp, jnp.asarray(x[:, i:i + 1]),
                                            jcache, JCFG, window=W)
        close(o, jo, 2e-5)
        close(cache.k, jcache.k, 2e-5)
        outs.append(o[:, 0])
    close(torch.stack(outs, 1)[:, -W:], full[:, -W:], 2e-4)
    assert int(cache.length) == 3 * W


def test_full_layer_at_capacity_keeps_the_last_slot():
    """A full (appending) layer whose cache is full writes its last slot
    again and attends over every slot, as the reference does."""
    jp, p = _attn_params(6)
    size = 6
    k = _x(7, 1, size, CFG.num_kv_heads, CFG.head_dim)
    v = _x(8, 1, size, CFG.num_kv_heads, CFG.head_dim)
    x = _x(9, 1, 1, CFG.d_model)
    cache = attn.KVCache(t(k), t(v), torch.tensor(size + 2,
                                                  dtype=torch.int32))
    jcache = jattn.KVCache(jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(size + 2, jnp.int32))
    o, cache = attn.attention_decode(p, t(x), cache, CFG)
    jo, jcache = jattn.attention_decode(jp, jnp.asarray(x), jcache, JCFG)
    close(o, jo, 2e-5)
    close(cache.k, jcache.k, 2e-5)


def test_decoder_block_decode_refuses_cross_attention():
    """decoder_block_decode takes memory= now: a cross-attention block
    (GQA 4/2 heads) prefilled over 12 tokens, then 3 one-token decodes
    attending to a 20-frame memory -- outputs and caches == the reference's
    decoder_block_prefill / decoder_block_decode at 2e-5, the cache written
    in place."""
    from repro.models import blocks as jblocks
    jp = jblocks.init_decoder_block_params(jax.random.PRNGKey(11), JCFG,
                                           cross=True)
    p = params_from_numpy(jax.tree.map(np.asarray, jp), CFG, "cpu")
    B, S, steps = 2, 12, 3
    x = _x(12, B, S + steps, CFG.d_model)
    mem = _x(13, B, 20, CFG.d_model)
    h, cache = blocks.decoder_block_prefill(p, t(x[:, :S]), CFG,
                                            max_len=S + steps,
                                            memory=t(mem))
    jh, jcache = jblocks.decoder_block_prefill(jp, jnp.asarray(x[:, :S]),
                                               JCFG, max_len=S + steps,
                                               memory=jnp.asarray(mem))
    close(h, jh, 2e-5)
    for i in range(S, S + steps):
        h, c2 = blocks.decoder_block_decode(p, t(x[:, i:i + 1]), cache, CFG,
                                            memory=t(mem))
        jh, jcache = jblocks.decoder_block_decode(
            jp, jnp.asarray(x[:, i:i + 1]), jcache, JCFG,
            memory=jnp.asarray(mem))
        assert c2 is cache
        close(h, jh, 2e-5)
        close(cache.k, jcache.k, 2e-5)
        close(cache.v, jcache.v, 2e-5)
    assert int(cache.length) == int(jcache.length) == S + steps


# ------------------------------------------------- chunked (blocked) oracle --

@pytest.mark.parametrize("mode", ["expanded", "grouped", "block_skip"])
@pytest.mark.parametrize("softcap", [None, 10.0])
@pytest.mark.parametrize("S,chunk,window", [(64, 16, None), (64, 16, 24),
                                            (48, 16, None), (33, 16, None),
                                            (128, 32, 40)])
def test_chunked_attention_matches_jax(S, chunk, window, softcap, mode):
    """tests/test_attention.py's (S, chunk, window) cases plus softcap,
    through the head-expanded path, the grouped-GQA path
    (cfg.gqa_grouped) and the causal block skip, against the reference's
    same path, 2e-5; and against the port's dense oracle."""
    kw = {"logit_softcap": softcap, "gqa_grouped": mode == "grouped",
          "causal_block_skip": mode == "block_skip"}
    cfg, jcfg = CFG.replace(**kw), JCFG.replace(**kw)
    rng = np.random.RandomState(S + chunk)
    q = rng.randn(2, S, cfg.num_heads, cfg.head_dim).astype(np.float32)
    k = rng.randn(2, S, cfg.num_kv_heads, cfg.head_dim).astype(np.float32)
    v = rng.randn(2, S, cfg.num_kv_heads, cfg.head_dim).astype(np.float32)
    got = attn.chunked_causal_attention(t(q), t(k), t(v), cfg, window, chunk)
    want = jattn.chunked_causal_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), jcfg, window, chunk)
    assert got.shape == (2, S, cfg.num_heads, cfg.head_dim)
    close(got, want, 2e-5)
    close(got, attn.dense_causal_attention(t(q), t(k), t(v), cfg, window),
          2e-5)


# --------------------------------------------- flash at head dims 192, 256 --

_CASES = [dict(causal=True), dict(causal=True, window=24),
          dict(causal=True, softcap=30.0),
          dict(causal=True, window=16, softcap=20.0)]


@pytest.mark.parametrize("kw", _CASES, ids=lambda k: "-".join(
    f"{a}{b}" for a, b in k.items()))
@pytest.mark.parametrize("dh", [192, 256])
def test_flash_plain_version_at_wide_heads_matches_jax_kernel(dh, kw):
    """The wrapper's plain version (a CPU tensor) at deepseek_v32's and
    gemma3's head dims, S=192, fp32, against the reference's Pallas kernel
    in interpret mode: 2e-5."""
    rng = np.random.RandomState(dh)
    q, k, v = (rng.randn(3, 192, dh).astype(np.float32) for _ in range(3))
    got = fa.flash_attention(t(q), t(k), t(v), **kw)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), interpret=True, **kw)
    close(got, want, 2e-5)


def _cu_head_dims():
    """Head dims flash_attention_launch instantiates, by route, read out of
    the .cu."""
    path = os.path.join(os.path.dirname(__file__), "..", "src",
                        "repro_torch", "csrc", "flash_attention.cu")
    src = open(path).read()
    body = src[src.index('extern "C" int flash_attention_launch('):]

    def dims(pattern):
        return tuple(int(a) for a, b in re.findall(pattern, body)
                     if a == b)

    return {"fma": dims(r"if \(dh == (\d+)\) return launch<float, (\d+), "
                        r"32, 32>"),
            "wmma": dims(r"if \(dh == (\d+)\) return launch<bf16, (\d+), "
                         r"64, 64>"),
            "wgmma": dims(r"if \(dh == (\d+)\) return wg::launch<(\d+)>")}


def test_head_dims_match_the_cu():
    """HEAD_DIMS == what the fma and wmma routes instantiate,
    WGMMA_HEAD_DIMS == what the forward's wgmma route does (192 and 256 on
    the wide-head kernel): the two cannot drift."""
    cu = _cu_head_dims()
    assert cu["fma"] == cu["wmma"] == fa.HEAD_DIMS == (32, 64, 128, 192, 256)
    assert cu["wgmma"] == fa.WGMMA_HEAD_DIMS == (64, 128, 192, 256)


@pytest.mark.parametrize("arch,want", [("deepseek_v32", "wgmma"),
                                       ("gemma3_1b", "wgmma"),
                                       ("qwen2_1p5b", "wgmma"),
                                       ("deepseek_coder_33b", "wgmma")])
def test_flash_route_of_the_zoo_shapes(arch, want):
    """The model layout at each config's heads, bf16: every head dim here
    (192 and 256 on the wide-head kernel, 128) takes wgmma, as TMA can
    describe them; fp32 takes fma."""
    cfg = get_config(arch)
    B, S = 2, 2048
    q = torch.empty((B, S, cfg.q_dim), device="meta").reshape(
        B, S, cfg.num_heads, cfg.head_dim)
    k = torch.empty((B, S, cfg.kv_dim), device="meta").reshape(
        B, S, cfg.num_kv_heads, cfg.head_dim)
    strides = [x.stride()[:3] for x in (q, k, k)]
    assert fa.route(torch.bfloat16, cfg.head_dim, (0, 0, 0), strides) == want
    assert fa.route(torch.float32, cfg.head_dim, (0, 0, 0), strides) == "fma"
