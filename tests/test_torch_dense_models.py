"""The dense decoder families behind the model API (gemma3, qwen2, olmo,
deepseek-coder, chameleon) against the JAX package, on the same bridged
params and numpy inputs, at each family's `.smoke()` config in fp32 on the
CPU: the registry, `lm_forward` (at S <= and > attn_chunk, so the port's
flash plain path meets the reference's chunked path), `lm_prefill` followed
by scalar-length `lm_decode_step`s past the smoke window (gemma's rings
wrap), `init_caches`, `lm_loss`, the parameter counts and `build_api`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (close, close_trees, family_setup, t,
                         tree_leaves)
from repro.configs import get_config as jax_get_config
from repro.models import api as japi
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.models import api, common, lm
from repro_torch.models.attention import KVCache

DENSE = ["gemma3_1b", "qwen2_1p5b", "olmo_1b", "deepseek_coder_33b",
         "chameleon_34b"]
MOE = "qwen3_moe_235b_a22b"
MOE_KW = dict(num_layers=3, num_experts=8, top_k=2)  # as smoke_setup cuts it
ALIASES = {"gemma3-1b": "gemma3_1b", "qwen2-1.5b": "qwen2_1p5b",
           "olmo-1b": "olmo_1b", "deepseek-coder-33b": "deepseek_coder_33b",
           "chameleon-34b": "chameleon_34b"}
LOGIT_TOL, CACHE_TOL = 1e-4, 5e-5


@pytest.fixture(autouse=True)
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _setup(arch):
    return family_setup(arch, **(MOE_KW if arch == MOE else {}))


def _tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S))


def _close_caches(got, want, tol=CACHE_TOL):
    close_trees(got, want, tol)


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


# ------------------------------------------------------------- registry --

@pytest.mark.parametrize("arch", DENSE + list(ALIASES))
def test_config_matches_reference_field_for_field(arch):
    """Full size and smoke: every field the reference's, dtype by name."""
    for mk in (lambda c: c, lambda c: c.smoke()):
        got = dataclasses.asdict(mk(get_config(arch)))
        want = dataclasses.asdict(mk(jax_get_config(arch)))
        assert str(got.pop("dtype")).replace("torch.", "") \
            == jnp.dtype(want.pop("dtype")).name
        assert got == want
    assert get_config(arch).name == get_config(ALIASES.get(arch, arch)).name


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_1p2b",
                                  "seamless_m4t_large_v2", "rwkv6-7b"])
def test_unported_architectures_raise(arch):
    """The architectures the port once refused are served now: each name,
    the alias too, gives the reference's config field for field (full and
    smoke); a name neither registry knows still raises."""
    for mk in (lambda c: c, lambda c: c.smoke()):
        got = dataclasses.asdict(mk(get_config(arch)))
        want = dataclasses.asdict(mk(jax_get_config(arch)))
        assert str(got.pop("dtype")).replace("torch.", "") \
            == jnp.dtype(want.pop("dtype")).name
        assert got == want
    with pytest.raises(ValueError):
        get_config(arch + "_unknown")


def test_registry_equals_reference_and_every_arch_builds():
    """ARCHS, EXTRA_ARCHS and the aliases are the reference's, in its
    order; build_api serves every one of the 11 architectures (a forward
    at the smoke config gives [B, S, V] logits)."""
    from repro import configs as jconfigs
    from repro_torch import configs
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.EXTRA_ARCHS == jconfigs.EXTRA_ARCHS
    assert configs._ALIASES == jconfigs._ALIASES
    gen = torch.Generator().manual_seed(0)
    for arch in configs.ARCHS + configs.EXTRA_ARCHS:
        cfg = get_config(arch).smoke()
        a = api.build_api(cfg)
        logits, _ = a.forward(a.init(gen),
                              a.make_batch(gen, 8, 1, "prefill",
                                           device="cpu"))
        assert logits.shape[0] == 1 and logits.shape[-1] == cfg.vocab_size
        assert torch.isfinite(logits).all(), arch


def test_gemma_stages_match_reference():
    """26 layers, lpg 5: 4 superblocks + a 2-layer windowed tail; smoke (7
    layers, lpg 2): 2 superblocks + a 1-layer windowed tail."""
    for mk in (lambda c: c, lambda c: c.smoke()):
        cfg, jcfg = mk(get_config("gemma3_1b")), mk(jax_get_config(
            "gemma3_1b"))
        assert lm.lm_stages(cfg) == jlm.lm_stages(jcfg)
    assert lm.lm_stages(get_config("gemma3_1b")) == [
        ("gemma", 4, {"lpg": 5}), ("decoder", 2, {"moe": False,
                                                  "window": 512})]


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_unported_stage_kinds_raise(family):
    """The stage kinds once refused: rwkv6's 32 rwkv layers, zamba2's 6
    superblocks of 6 mamba layers + a 2-layer mamba tail; smoke configs
    too; all == the reference's lm_stages."""
    arch = {"ssm": "rwkv6_7b", "hybrid": "zamba2_1p2b"}[family]
    for mk in (lambda c: c, lambda c: c.smoke()):
        cfg, jcfg = mk(get_config(arch)), mk(jax_get_config(arch))
        assert cfg.family == family
        assert lm.lm_stages(cfg) == jlm.lm_stages(jcfg)
    assert lm.lm_stages(get_config(arch)) == {
        "ssm": [("rwkv", 32, {})],
        "hybrid": [("zamba", 6, {"every": 6}), ("mamba", 2, {})]}[family]


# ------------------------------------------------------------- forward --

@pytest.mark.parametrize("S", [16, 48])
@pytest.mark.parametrize("arch", DENSE)
def test_lm_forward_matches_jax(arch, S):
    """S=16 takes both packages' dense oracle; S=48 > attn_chunk (32) the
    port's flash wrapper (its plain version here) against the reference's
    chunked path."""
    jcfg, jparams, cfg, params = family_setup(arch)
    tokens = _tokens(cfg, 2, S, 30)
    got, aux = lm.lm_forward(params, cfg, t(tokens))
    want, jaux = jlm.lm_forward(jparams, jcfg, jnp.asarray(tokens))
    assert got.shape == (2, S, cfg.vocab_size)
    close(got, want, LOGIT_TOL)
    close(aux.load_balance_loss, jaux.load_balance_loss, 1e-6)


# ------------------------------------------------------ prefill, decode --

@pytest.mark.parametrize("S,steps", [(12, 22), (40, 20)])
@pytest.mark.parametrize("arch", DENSE + [MOE])
def test_prefill_then_decode_matches_jax(arch, S, steps):
    """lm_prefill, then greedy scalar-length lm_decode_steps past the smoke
    window (16): logits at every step within 1e-4 and every cache field
    within 5e-5.  S=12 < window pads gemma's rings and wraps them during
    decode; S=40 > attn_chunk fills them at prefill (through the flash
    path).  The MoE config holds the decode's capacity MoE."""
    jcfg, jparams, cfg, params = _setup(arch)
    tokens = _tokens(cfg, 2, S, 31)
    max_len = S + steps
    logits, caches = lm.lm_prefill(params, cfg, t(tokens), max_len=max_len)
    jlogits, jcaches = jlm.lm_prefill(jparams, jcfg, jnp.asarray(tokens),
                                      max_len=max_len)
    close(logits, jlogits, LOGIT_TOL)
    _close_caches(caches, jcaches)
    jdec = jax.jit(lambda p, c, tok: jlm.lm_decode_step(p, jcfg, c, tok))
    for step in range(steps):
        tok = np.asarray(jnp.argmax(jlogits, -1), np.int32)
        logits, caches = lm.lm_decode_step(params, cfg, caches, t(tok))
        jlogits, jcaches = jdec(jparams, jcaches, jnp.asarray(tok))
        close(logits, jlogits, LOGIT_TOL)
        _close_caches(caches, jcaches)
    lens = [int(x) for x in tree_leaves(caches) if x.dtype == torch.int32
            for x in x.flatten()]
    assert set(lens) == {S + steps}


def test_decode_writes_the_cache_in_place_without_new_tensors():
    """The step consumes its caches: it writes the stage's k/v and advances
    its lengths through layer views, and returns the same objects."""
    _, _, cfg, params = family_setup("gemma3_1b")
    _, caches = lm.lm_prefill(params, cfg, t(_tokens(cfg, 2, 20, 32)),
                              max_len=24)
    before = [c.clone() for c in tree_leaves(caches)]
    _, new = lm.lm_decode_step(params, cfg, caches,
                               torch.tensor([1, 2], dtype=torch.int32))
    assert new is caches
    for old, was, now in zip(tree_leaves(caches), before, tree_leaves(new)):
        assert now is old
        if old.dtype == torch.int32:
            assert torch.equal(now, was + 1)
        else:
            assert not torch.equal(now, was)


@pytest.mark.parametrize("arch", DENSE + [MOE])
def test_init_caches_match_jax_and_prefill(arch):
    """Shapes and dtypes == the reference's init_caches, and == the shapes
    of lm_prefill's caches; every length the prefilled count."""
    jcfg, _, cfg, params = _setup(arch)
    B, S, max_len = 2, 20, 40
    got = lm.init_caches(cfg, B, max_len, prefilled=S, device="cpu")
    want = jlm.init_caches(jcfg, B, max_len, prefilled=S)
    _, pre = lm.lm_prefill(params, cfg, t(_tokens(cfg, B, S, 33)),
                           max_len=max_len)
    g, w, p = tree_leaves(got), tree_leaves(want), tree_leaves(pre)
    assert len(g) == len(w) == len(p)
    for a, b, c in zip(g, w, p):
        assert tuple(a.shape) == tuple(b.shape) == tuple(c.shape)
        assert _dtype_name(a) == jnp.dtype(b.dtype).name == _dtype_name(c)
        if a.dtype == torch.int32:
            assert torch.equal(a, torch.full_like(a, S))
        else:
            assert not a.any()


# ------------------------------------------------------- loss, counting --

@pytest.mark.parametrize("ce_block", [16, 512])
@pytest.mark.parametrize("arch", DENSE + [MOE])
def test_lm_loss_matches_jax(arch, ce_block):
    """Loss and metrics at 1e-5: three CE blocks, or one."""
    jcfg, jparams, cfg, params = _setup(arch)
    tokens, labels = _tokens(cfg, 2, 48, 34), _tokens(cfg, 2, 48, 35)
    loss, m = lm.lm_loss(params, cfg, t(tokens), t(labels),
                         ce_block=ce_block)
    jloss, jm = jlm.lm_loss(jparams, jcfg, jnp.asarray(tokens),
                            jnp.asarray(labels), ce_block=ce_block)
    close(loss, jloss, 1e-5)
    assert sorted(m) == sorted(jm)
    for k in m:
        close(m[k], jm[k], 1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss_matches_jax(masked):
    rng = np.random.RandomState(36)
    logits = rng.randn(3, 5, 40).astype(np.float32)
    labels = rng.randint(0, 40, (3, 5)).astype(np.int32)
    mask = (rng.rand(3, 5) > 0.4).astype(np.float32) if masked else None
    got = common.cross_entropy_loss(t(logits), t(labels),
                                    None if mask is None else t(mask))
    want = jcommon.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    close(got, want, 1e-6)


@pytest.mark.parametrize("arch", DENSE + [MOE])
def test_param_counts_match_jax(arch):
    jcfg, jparams, cfg, params = _setup(arch)
    assert common.param_count(params) == jcommon.param_count(jparams)
    assert common.active_param_count(params, cfg) \
        == jcommon.active_param_count(jparams, jcfg)


# ---------------------------------------------------------------- api --

def test_make_batch_shapes():
    cfg = get_config("qwen2_1p5b").smoke()
    a = api.build_api(cfg)
    gen = torch.Generator().manual_seed(0)
    b = a.make_batch(gen, 24, 3, "train", device="cpu")
    assert sorted(b) == ["labels", "tokens"]
    assert b["tokens"].shape == b["labels"].shape == (3, 24)
    assert int(b["tokens"].max()) < cfg.vocab_size
    assert sorted(a.make_batch(gen, 24, 3, "prefill", device="cpu")) \
        == ["tokens"]
    d = a.make_batch(gen, 24, 3, "decode", device="cpu")
    assert d["token"].shape == (3,)
    audio = api.build_api(cfg.replace(frontend="audio"))
    e = audio.make_batch(gen, 24, 3, "train", device="cpu")["embeddings"]
    assert e.shape == (3, 24, cfg.d_model) and e.dtype == cfg.dtype


def test_build_api_refuses_encdec():
    """The encoder-decoder API is built now: its batch, caches and a
    forward at the smoke config have the reference's shapes."""
    cfg = get_config("seamless_m4t_large_v2").smoke()
    a = api.build_api(cfg)
    gen = torch.Generator().manual_seed(0)
    b = a.make_batch(gen, 40, 2, "train", device="cpu")
    assert sorted(b) == ["dec_tokens", "enc_embeddings", "labels"]
    assert b["enc_embeddings"].shape == (2, 40, cfg.d_model)
    assert b["dec_tokens"].shape == b["labels"].shape == (2, 64)
    logits, aux = a.forward(a.init(gen), b)
    assert logits.shape == (2, 64, cfg.vocab_size) and aux is None
    memory, caches = a.make_caches(2, 70, 0, enc_len=40, device="cpu")
    assert memory.shape == (2, 40, cfg.d_model)
    assert caches.k.shape == (cfg.decoder_layers, 2, 70, cfg.num_kv_heads,
                              cfg.head_dim)


@pytest.mark.parametrize("arch", ["gemma3_1b", "qwen2_1p5b"])
def test_build_api_equals_direct_calls_and_jax(arch):
    """prefill / decode / forward / loss through the API == the direct
    calls (torch.equal), and within the tolerances above of the JAX API."""
    jcfg, jparams, cfg, params = family_setup(arch)
    a, ja = api.build_api(cfg), japi.build_api(jcfg)
    tokens, labels = _tokens(cfg, 2, 40, 37), _tokens(cfg, 2, 40, 38)
    batch = {"tokens": t(tokens), "labels": t(labels), "max_len": 48}
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
              "max_len": 48}
    logits, aux = a.forward(params, batch)
    assert torch.equal(logits, lm.lm_forward(params, cfg, t(tokens))[0])
    close(logits, ja.forward(jparams, jbatch)[0], LOGIT_TOL)
    loss, _ = a.loss(params, batch)
    assert torch.equal(loss, lm.lm_loss(params, cfg, t(tokens),
                                        t(labels))[0])
    close(loss, ja.loss(jparams, jbatch)[0], 1e-5)
    last, caches = a.prefill(params, batch)
    dlast, dcaches = lm.lm_prefill(params, cfg, t(tokens), max_len=48)
    assert torch.equal(last, dlast)
    jlast, jcaches = ja.prefill(jparams, jbatch)
    close(last, jlast, LOGIT_TOL)
    for _ in range(3):
        tok = torch.argmax(last, -1)
        last, caches = a.decode(params, caches, {"token": tok})
        dlast, dcaches = lm.lm_decode_step(params, cfg, dcaches, tok)
        jlast, jcaches = ja.decode(jparams, jcaches,
                                   {"token": jnp.asarray(tok.numpy())})
        assert torch.equal(last, dlast)
        close(last, jlast, LOGIT_TOL)
    _close_caches(caches, jcaches)
    made = a.make_caches(2, 48, 40, device="cpu")
    assert [x.shape for x in tree_leaves(made)] \
        == [x.shape for x in tree_leaves(caches)]
    assert all(isinstance(c, (KVCache, dict)) for c in made)
