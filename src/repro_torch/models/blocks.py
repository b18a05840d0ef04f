"""Transformer / SSM block definitions assembled from attention, MoE/FFN,
mamba2 and rwkv6: decoder blocks (with optional cross attention), the
encoder block, the RWKV block, the Mamba block and Zamba2's shared attention
block.

Params are stored *stacked* on a leading layer axis by the LM core (lm.py);
a block receives one layer's slice.  Decode CONSUMES its state: a layer's
KV cache, RWKV state or Mamba state is written in place and the same object
comes back (see `attention_decode`, `rwkv_block_decode`, `mamba_decode`).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels.flash_attention.ops import _expand_kv
from repro_torch.models.attention import (KVCache, _kv_for_heads,
                                          _out_proj, _project_qkv,
                                          attention_decode,
                                          attention_decode_ragged,
                                          attention_forward, attention_prefill,
                                          cross_attention_forward,
                                          init_attention_params,
                                          unmasked_attention)
from repro_torch.models.common import (ModelConfig, act_fn, apply_norm,
                                       dense_init, layer_norm,
                                       make_norm_params)
from repro_torch.models.mamba2 import (MambaState, init_mamba_params,
                                       mamba_decode, mamba_forward)
from repro_torch.models.moe import (gated_ffn, init_moe_params,
                                   moe_forward)
from repro_torch.models.rwkv6 import (RWKVState, channel_mix_forward,
                                      init_rwkv_params, time_mix_forward)

# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------


def init_ffn_params(gen: torch.Generator, cfg: ModelConfig,
                    stack: tuple = ()):
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": dense_init(gen, stack + (d, f), d, cfg.dtype),
            "w_up": dense_init(gen, stack + (d, f), d, cfg.dtype),
            "w_down": dense_init(gen, stack + (f, d), f, cfg.dtype)}


def ffn_forward(p, x, cfg: ModelConfig):
    """The gated FFN; inside a tensor-parallel step the leaves may hold this
    rank's hidden columns (gate / up) and rows (down): column-parallel in,
    row-parallel out, the partial outputs added over "model"."""
    return gated_ffn(x, p["w_gate"], p["w_up"], p["w_down"], act_fn(cfg.act),
                     cfg.d_ff)


# ---------------------------------------------------------------------------
# Decoder blocks (pre-norm residual)
# ---------------------------------------------------------------------------


def init_decoder_block_params(gen: torch.Generator, cfg: ModelConfig, *,
                              moe: bool = False, cross: bool = False,
                              stack: tuple = ()):
    p = {
        "ln_attn": make_norm_params(cfg, gen.device, stack),
        "attn": init_attention_params(gen, cfg, stack),
        "ln_ffn": make_norm_params(cfg, gen.device, stack),
        "ffn": init_moe_params(gen, cfg, stack) if moe
        else init_ffn_params(gen, cfg, stack),
    }
    if cross:
        p["ln_cross"] = make_norm_params(cfg, gen.device, stack)
        p["cross"] = init_attention_params(gen, cfg, stack, cross=True)
    return p


def _cross(p, h, memory, cfg: ModelConfig):
    """The cross-attention residual of a decoder block (none without
    `memory`)."""
    if memory is None:
        return h
    return h + cross_attention_forward(p["cross"],
                                       apply_norm(h, p["ln_cross"], cfg),
                                       memory, cfg)


def decoder_block_forward(p, h, cfg: ModelConfig, *,
                          window: Optional[int] = None, moe: bool = False,
                          moe_mode: str = "capacity",
                          use_dense: Optional[bool] = None,
                          gmm: Optional[Callable] = None,
                          layer_id: Optional[torch.Tensor] = None,
                          memory: Optional[torch.Tensor] = None):
    """h: [B, S, d] -> (h, MoEAux or None).  `gmm(xb, experts, cfg,
    layer_id)` replaces the capacity mode's expert matmul; it is handed this
    layer's `layer_id` (`make_super_kernel_gmm` resolves the layer from it).
    `memory` [B, S_enc, d]: the encoder's output, attended to after the
    self attention (encoder-decoder)."""
    B, S, d = h.shape
    h = h + attention_forward(p["attn"], apply_norm(h, p["ln_attn"], cfg), cfg,
                              window=window, use_dense=use_dense)
    h = _cross(p, h, memory, cfg)
    x = apply_norm(h, p["ln_ffn"], cfg)
    if moe:
        gmm_l = (lambda xb, ex, c: gmm(xb, ex, c, layer_id)) if gmm else None
        y, aux = moe_forward(p["ffn"], x.reshape(B * S, d), cfg,
                             mode=moe_mode, gmm=gmm_l)
        return h + y.reshape(B, S, d), aux
    return h + ffn_forward(p["ffn"], x, cfg), None


def decoder_block_prefill(p, h, cfg: ModelConfig, *,
                          window: Optional[int] = None, moe: bool = False,
                          max_len: Optional[int] = None,
                          use_dense: Optional[bool] = None,
                          memory: Optional[torch.Tensor] = None):
    """Full-sequence forward that also emits the layer's KV cache:
    (h, KVCache).  The MoE runs in capacity mode, as in the reference;
    `memory` as in `decoder_block_forward`."""
    B, S, d = h.shape
    a, cache = attention_prefill(p["attn"], apply_norm(h, p["ln_attn"], cfg),
                                 cfg, window=window, max_len=max_len,
                                 use_dense=use_dense)
    h = _cross(p, h + a, memory, cfg)
    x = apply_norm(h, p["ln_ffn"], cfg)
    if moe:
        y, _ = moe_forward(p["ffn"], x.reshape(B * S, d), cfg,
                           mode="capacity")
        return h + y.reshape(B, S, d), cache
    return h + ffn_forward(p["ffn"], x, cfg), cache


def decoder_block_decode(p, h, cache: KVCache, cfg: ModelConfig, *,
                         window: Optional[int] = None, moe: bool = False,
                         memory: Optional[torch.Tensor] = None):
    """One-token decode at one scalar cache length. h: [B, 1, d]; cache: the
    layer's KVCache, consumed: written and advanced in place (see
    `attention_decode`).  Returns (h, the same KVCache).  The MoE runs in
    capacity mode, as in the reference; `memory` as in
    `decoder_block_forward` (the cross attention reads it, nothing is
    cached)."""
    B = h.shape[0]
    a, cache = attention_decode(p["attn"], apply_norm(h, p["ln_attn"], cfg),
                                cache, cfg, window=window)
    h = _cross(p, h + a, memory, cfg)
    x = apply_norm(h, p["ln_ffn"], cfg)
    if moe:
        y, _ = moe_forward(p["ffn"], x.reshape(B, -1), cfg, mode="capacity")
        return h + y.reshape(B, 1, -1), cache
    return h + ffn_forward(p["ffn"], x, cfg), cache


def decoder_block_decode_ragged(p, h, k_cache, v_cache, lengths,
                                cfg: ModelConfig, *, moe: bool = False):
    """One-token decode over a ragged continuous batch.  h: [B, 1, d];
    k_cache/v_cache: [B, S_max, kvh, hd] (written in place, see
    `attention_decode_ragged`); lengths: [B] int32 per-row cache lengths.
    Returns (h, k_cache, v_cache); the caller advances `lengths`."""
    B = h.shape[0]
    a, ck, cv = attention_decode_ragged(
        p["attn"], apply_norm(h, p["ln_attn"], cfg), k_cache, v_cache,
        lengths, cfg)
    h = h + a
    x = apply_norm(h, p["ln_ffn"], cfg)
    if moe:
        y, _ = moe_forward(p["ffn"], x.reshape(B, -1), cfg, mode="capacity")
        return h + y.reshape(B, 1, -1), ck, cv
    return h + ffn_forward(p["ffn"], x, cfg), ck, cv


# ---------------------------------------------------------------------------
# Encoder block (bidirectional self-attention)
# ---------------------------------------------------------------------------


def init_encoder_block_params(gen: torch.Generator, cfg: ModelConfig,
                              stack: tuple = ()):
    return init_decoder_block_params(gen, cfg, stack=stack)


def encoder_block_forward(p, h, cfg: ModelConfig):
    """Bidirectional attention, dense without a mask (the reference runs no
    kernel here): over query blocks of `attn_chunk` rows when the sequence
    is a multiple of it and longer, to bound the scores' memory, else all
    at once -- the reference's rule.  On the heads `wq` holds (the rank's,
    inside a tensor-parallel step: `wo`'s rows then sum over "model")."""
    B, S, d = h.shape
    x = apply_norm(h, p["ln_attn"], cfg)
    pos = torch.arange(S, device=h.device).expand(B, S)
    q, k, v = _project_qkv(p["attn"], x, x, cfg, pos, pos)
    H = q.shape[2]
    k, v = _kv_for_heads(k, v, H, cfg)
    k = _expand_kv(k, H).float()
    v = _expand_kv(v, H)
    C = min(cfg.attn_chunk, S)
    if S % C == 0 and S > C:
        o = torch.cat([unmasked_attention(q[:, i:i + C], k, v, cfg)
                       for i in range(0, S, C)], dim=1)
    else:
        o = unmasked_attention(q, k, v, cfg)
    h = h + _out_proj(o, p["attn"]["wo"], cfg)
    return h + ffn_forward(p["ffn"], apply_norm(h, p["ln_ffn"], cfg), cfg)


# ---------------------------------------------------------------------------
# RWKV block
# ---------------------------------------------------------------------------


def init_rwkv_block_params(gen: torch.Generator, cfg: ModelConfig,
                           stack: tuple = ()):
    p = init_rwkv_params(gen, cfg, stack)
    shape, dev = stack + (cfg.d_model,), gen.device
    p["ln_tm"] = torch.ones(shape, dtype=cfg.dtype, device=dev)
    p["ln_tm_b"] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    p["ln_cm"] = torch.ones(shape, dtype=cfg.dtype, device=dev)
    p["ln_cm_b"] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    return p


def rwkv_block_forward(p, h, cfg: ModelConfig, *, sequential: bool = False):
    x = layer_norm(h, p["ln_tm"], p["ln_tm_b"], cfg.norm_eps)
    y, _ = time_mix_forward(p["time_mix"], x, cfg, sequential=sequential)
    h = h + y
    x = layer_norm(h, p["ln_cm"], p["ln_cm_b"], cfg.norm_eps)
    return h + channel_mix_forward(p["channel_mix"], x, cfg)


def rwkv_block_prefill(p, h, cfg: ModelConfig):
    """Full-sequence forward that also emits the layer's RWKVState: the
    final WKV state and the last post-norm token of each mix."""
    x = layer_norm(h, p["ln_tm"], p["ln_tm_b"], cfg.norm_eps)
    y, wkv = time_mix_forward(p["time_mix"], x, cfg)
    h = h + y
    x2 = layer_norm(h, p["ln_cm"], p["ln_cm_b"], cfg.norm_eps)
    h = h + channel_mix_forward(p["channel_mix"], x2, cfg)
    return h, RWKVState(wkv, x[:, -1].clone(), x2[:, -1].clone())


def rwkv_block_decode(p, h, state: RWKVState, cfg: ModelConfig):
    """One token. h: [B, 1, d].  CONSUMES `state`: the new WKV state and
    both shift tokens are written into it IN PLACE (after every read of the
    old ones), and the same RWKVState comes back: (h, state)."""
    x = layer_norm(h, p["ln_tm"], p["ln_tm_b"], cfg.norm_eps)
    y, wkv = time_mix_forward(p["time_mix"], x, cfg, sequential=True,
                              last=state.shift_tm, state=state.wkv)
    h = h + y
    x2 = layer_norm(h, p["ln_cm"], p["ln_cm_b"], cfg.norm_eps)
    h = h + channel_mix_forward(p["channel_mix"], x2, cfg,
                                last=state.shift_cm)
    state.wkv.copy_(wkv)
    state.shift_tm.copy_(x[:, -1])
    state.shift_cm.copy_(x2[:, -1])
    return h, state


# ---------------------------------------------------------------------------
# Mamba block (norm + mamba2 mixer)
# ---------------------------------------------------------------------------


def init_mamba_block_params(gen: torch.Generator, cfg: ModelConfig,
                            stack: tuple = ()):
    return {"ln": make_norm_params(cfg, gen.device, stack),
            "mamba": init_mamba_params(gen, cfg, stack)}


def mamba_block_forward(p, h, cfg: ModelConfig, *, sequential: bool = False):
    return h + mamba_forward(p["mamba"], apply_norm(h, p["ln"], cfg), cfg,
                             sequential=sequential)


def mamba_block_prefill(p, h, cfg: ModelConfig):
    y, state = mamba_forward(p["mamba"], apply_norm(h, p["ln"], cfg), cfg,
                             return_state=True)
    return h + y, state


def mamba_block_decode(p, h, state: MambaState, cfg: ModelConfig):
    """One token; consumes `state` (see `mamba_decode`)."""
    y, state = mamba_decode(p["mamba"], apply_norm(h, p["ln"], cfg), state,
                            cfg)
    return h + y, state


# ---------------------------------------------------------------------------
# Zamba2 shared attention block (applied periodically, params shared)
# ---------------------------------------------------------------------------


def init_shared_attn_params(gen: torch.Generator, cfg: ModelConfig):
    """Zamba-style: input is concat(h, original_embedding) -> project to d."""
    d, dev = cfg.d_model, gen.device
    return {
        "in_proj": dense_init(gen, (2 * d, d), 2 * d, cfg.dtype),
        "ln": make_norm_params(cfg, dev),
        "attn": init_attention_params(gen, cfg),
        "ln_ffn": make_norm_params(cfg, dev),
        "ffn": init_ffn_params(gen, cfg),
    }


def _shared_ffn(p, h, x, cfg: ModelConfig):
    x = x + ffn_forward(p["ffn"], apply_norm(x, p["ln_ffn"], cfg), cfg)
    return h + x


def shared_attn_forward(p, h, emb, cfg: ModelConfig, *,
                        use_dense: Optional[bool] = None):
    """Causal attention on concat(h, emb) @ in_proj: through the flash
    kernel when S > attn_chunk (`use_dense` as in `attention_forward`)."""
    x = torch.cat([h, emb], dim=-1) @ p["in_proj"]
    x = x + attention_forward(p["attn"], apply_norm(x, p["ln"], cfg), cfg,
                              use_dense=use_dense)
    return _shared_ffn(p, h, x, cfg)


def shared_attn_prefill(p, h, emb, cfg: ModelConfig, max_len=None, *,
                        use_dense: Optional[bool] = None):
    """The cache as `attention_prefill` keeps it (the rank's shard inside a
    mesh serving step)."""
    x = torch.cat([h, emb], dim=-1) @ p["in_proj"]
    a, cache = attention_prefill(p["attn"], apply_norm(x, p["ln"], cfg), cfg,
                                 max_len=max_len, use_dense=use_dense)
    return _shared_ffn(p, h, x + a, cfg), cache


def shared_attn_decode(p, h, emb, cache: KVCache, cfg: ModelConfig):
    """One token; consumes `cache` (see `attention_decode`)."""
    x = torch.cat([h, emb], dim=-1) @ p["in_proj"]
    a, cache = attention_decode(p["attn"], apply_norm(x, p["ln"], cfg), cache,
                                cfg)
    return _shared_ffn(p, h, x + a, cfg), cache
