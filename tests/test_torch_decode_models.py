"""The port's prefill/decode model functions against the JAX functions on the
same numpy inputs and bridged params (qwen3 smoke config, fp32, CPU):
`attention_prefill` (cache and output), `attention_decode_ragged`,
`decoder_block_decode_ragged` with the capacity MoE, `lm_prefill`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, smoke_setup, t
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models.lm import lm_prefill as jax_lm_prefill
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models.lm import layer_slice, lm_prefill

TOL = 2e-4  # as tests/test_pd.py holds the reference's decode path


def _layer0(jparams, params):
    return (jax.tree.map(lambda a: a[0], jparams["stages"][0]),
            layer_slice(params["stages"][0], 0))


@pytest.mark.parametrize("use_dense", [True, False])
@pytest.mark.parametrize("window,max_len", [(None, None), (None, 40),
                                            (8, None), (32, None)])
def test_attention_prefill_matches_jax(use_dense, window, max_len):
    """Output and cache (ring buffer when S >= window, padding to max_len
    or window otherwise); the flash branch's plain version and the dense
    oracle both against the reference's dense path."""
    jcfg, jparams, cfg, params = smoke_setup()
    jl, pl = _layer0(jparams, params)
    x = np.random.RandomState(20).randn(2, 24, cfg.d_model).astype(np.float32)
    out, cache = attn.attention_prefill(pl["attn"], t(x), cfg, window=window,
                                        max_len=max_len, use_dense=use_dense)
    jout, jcache = jattn.attention_prefill(jl["attn"], jnp.asarray(x), jcfg,
                                           window=window, max_len=max_len,
                                           use_dense=True)
    close(out, jout, TOL)
    assert cache.k.shape == jcache.k.shape
    close(cache.k, jcache.k, TOL)
    close(cache.v, jcache.v, TOL)
    assert int(cache.length) == int(jcache.length) == 24


def test_init_kv_cache_matches_jax():
    jcfg, _, cfg, _ = smoke_setup()
    for window in (None, 8, 100):
        c = attn.init_kv_cache(cfg, 3, 40, window)
        j = jattn.init_kv_cache(jcfg, 3, 40, window)
        assert c.k.shape == j.k.shape and c.v.shape == j.v.shape
        assert not c.k.any() and int(c.length) == 0


def _ragged_inputs(cfg, lens, size, seed):
    rng = np.random.RandomState(seed)
    shape = (len(lens), size, cfg.num_kv_heads, cfg.head_dim)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    for i, n in enumerate(lens):  # slots past each row's length are empty
        k[i, n:] = 0
        v[i, n:] = 0
    x = rng.randn(len(lens), 1, cfg.d_model).astype(np.float32)
    return x, k, v, np.asarray(lens, np.int32)


@pytest.mark.parametrize("softcap", [None, 20.0])
def test_attention_decode_ragged_matches_jax(softcap):
    """Rows at different lengths (one at the last slot): output and the
    appended caches, written in place."""
    jcfg, jparams, cfg, params = smoke_setup()
    jcfg, cfg = (c.replace(logit_softcap=softcap) for c in (jcfg, cfg))
    jl, pl = _layer0(jparams, params)
    x, k, v, lens = _ragged_inputs(cfg, [5, 9, 11], 12, 21)
    ck, cv = t(k.copy()), t(v.copy())
    out, nk, nv = attn.attention_decode_ragged(pl["attn"], t(x), ck, cv,
                                               t(lens), cfg)
    jout, jk, jv = jattn.attention_decode_ragged(
        jl["attn"], jnp.asarray(x), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lens), jcfg)
    close(out, jout, TOL)
    assert nk is ck and nv is cv  # in place
    close(nk, jk, TOL)
    close(nv, jv, TOL)


def test_decode_after_prefill_reproduces_the_last_position():
    """Appending one token through the ragged decode path gives the
    prefill's last-position output, per row, at different cache lengths
    (the port alone, as tests/test_pd.py holds the reference)."""
    _, _, cfg, params = smoke_setup()
    p = layer_slice(params["stages"][0], 0)["attn"]
    rng = np.random.RandomState(22)
    lens, size = [5, 9], 12
    xs = [t(rng.randn(1, n, cfg.d_model).astype(np.float32)) for n in lens]
    caches = [attn.attention_prefill(p, x, cfg, max_len=size)[1] for x in xs]
    k = torch.cat([c.k for c in caches])
    v = torch.cat([c.v for c in caches])
    x1 = t(rng.randn(2, 1, cfg.d_model).astype(np.float32))
    out, ck, _ = attn.attention_decode_ragged(
        p, x1, k, v, torch.tensor(lens, dtype=torch.int32), cfg)
    for i, n in enumerate(lens):
        ref, _ = attn.attention_prefill(
            p, torch.cat([xs[i], x1[i:i + 1]], 1), cfg)
        close(out[i], ref[0, -1:], TOL)
        assert ck[i, n].abs().max() > 0 and not ck[i, n + 1:].any()


def test_decoder_block_decode_ragged_moe_matches_jax():
    jcfg, jparams, cfg, params = smoke_setup(num_experts=8)
    jl, pl = _layer0(jparams, params)
    x, k, v, lens = _ragged_inputs(cfg, [3, 7, 12, 1], 16, 23)
    h, nk, nv = blocks.decoder_block_decode_ragged(
        pl, t(x), t(k.copy()), t(v.copy()), t(lens), cfg, moe=True)
    jh, jk, jv = jblocks.decoder_block_decode_ragged(
        jl, jnp.asarray(x), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        jcfg, moe=True)
    close(h, jh, TOL)
    close(nk, jk, TOL)
    close(nv, jv, TOL)


@pytest.mark.parametrize("max_len", [None, 24])
def test_lm_prefill_matches_jax(max_len):
    """Last-position logits and every layer's cache, MoE in capacity mode."""
    jcfg, jparams, cfg, params = smoke_setup(num_experts=8)
    tokens = np.random.RandomState(24).randint(0, cfg.vocab_size, (2, 16))
    logits, caches = lm_prefill(params, cfg, t(tokens), max_len=max_len)
    jlogits, jcaches = jax_lm_prefill(jparams, jcfg, jnp.asarray(tokens),
                                      max_len=max_len)
    close(logits, jlogits, 1e-4)
    assert len(caches) == len(jcaches) == 1
    c, j = caches[0], jcaches[0]
    assert c.k.shape == j.k.shape == (cfg.num_layers, 2, max_len or 16,
                                      cfg.num_kv_heads, cfg.head_dim)
    close(c.k, j.k, 5e-5)
    close(c.v, j.v, 5e-5)
    np.testing.assert_array_equal(c.length.numpy(), np.asarray(j.length))
