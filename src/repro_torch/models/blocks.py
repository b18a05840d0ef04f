"""Decoder block (pre-norm residual) assembled from attention and MoE/FFN.

Params are stored *stacked* on a leading layer axis by the LM core (lm.py);
a block receives one layer's slice.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.attention import (KVCache, attention_decode,
                                          attention_decode_ragged,
                                          attention_forward, attention_prefill,
                                          init_attention_params)
from repro_torch.models.common import (ModelConfig, act_fn, apply_norm,
                                       dense_init, make_norm_params)
from repro_torch.models.moe import init_moe_params, moe_forward

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
    act = act_fn(cfg.act)
    return (act(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------
# Decoder blocks (pre-norm residual)
# ---------------------------------------------------------------------------


def init_decoder_block_params(gen: torch.Generator, cfg: ModelConfig, *,
                              moe: bool = False, stack: tuple = ()):
    return {
        "ln_attn": make_norm_params(cfg, gen.device, stack),
        "attn": init_attention_params(gen, cfg, stack),
        "ln_ffn": make_norm_params(cfg, gen.device, stack),
        "ffn": init_moe_params(gen, cfg, stack) if moe
        else init_ffn_params(gen, cfg, stack),
    }


def decoder_block_forward(p, h, cfg: ModelConfig, *,
                          window: Optional[int] = None, moe: bool = False,
                          moe_mode: str = "capacity",
                          use_dense: Optional[bool] = None,
                          gmm: Optional[Callable] = None,
                          layer_id: Optional[torch.Tensor] = None):
    """h: [B, S, d] -> (h, MoEAux or None).  `gmm(xb, experts, cfg,
    layer_id)` replaces the capacity mode's expert matmul; it is handed this
    layer's `layer_id` (`make_super_kernel_gmm` resolves the layer from it)."""
    B, S, d = h.shape
    h = h + attention_forward(p["attn"], apply_norm(h, p["ln_attn"], cfg), cfg,
                              window=window, use_dense=use_dense)
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
                          use_dense: Optional[bool] = None):
    """Full-sequence forward that also emits the layer's KV cache:
    (h, KVCache).  The MoE runs in capacity mode, as in the reference."""
    B, S, d = h.shape
    a, cache = attention_prefill(p["attn"], apply_norm(h, p["ln_attn"], cfg),
                                 cfg, window=window, max_len=max_len,
                                 use_dense=use_dense)
    h = h + a
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
    `attention_decode`).  Returns (h, the same KVCache).  The MoE runs in capacity mode, as in the
    reference.  `memory` (the encoder-decoder's cross attention) is not
    ported yet."""
    if memory is not None:
        raise NotImplementedError("decoder_block_decode: cross attention "
                                  "(memory=) comes with the encoder-decoder "
                                  "family")
    B = h.shape[0]
    a, cache = attention_decode(p["attn"], apply_norm(h, p["ln_attn"], cfg),
                                cache, cfg, window=window)
    h = h + a
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
