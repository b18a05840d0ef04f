"""Encoder-decoder backbone (Seamless-M4T style, modality frontend stubbed).

Encoder: bidirectional self-attention blocks over precomputed frame
embeddings (the audio frontend is a stub: callers supply [B, S_enc, d_model]
embeddings, `frontends.synthetic_embeddings` makes random ones).  Decoder:
causal self-attention (the flash kernel when S_dec > attn_chunk) + cross
attention over the encoder memory + dense FFN.  Decoder token convention:
S_dec = max(S_enc // 8, 64) (speech-to-text ratio).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.models import blocks as B
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (ModelConfig, apply_norm, embed_init,
                                       make_norm_params)
from repro_torch.models.lm import (_cache_at, _stack, blocked_ce,
                                   layer_slice)


def decoder_len(seq_len: int) -> int:
    return max(seq_len // 8, 64)


def init_encdec_params(gen: torch.Generator, cfg: ModelConfig):
    """Random parameters from a seeded generator, on its device; the
    reference's tree (encoder and decoder stacked on a layer axis)."""
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.dtype),
        "encoder": B.init_encoder_block_params(gen, cfg,
                                               stack=(cfg.encoder_layers,)),
        "enc_norm": make_norm_params(cfg, gen.device),
        "decoder": B.init_decoder_block_params(gen, cfg, cross=True,
                                               stack=(cfg.decoder_layers,)),
        "final_norm": make_norm_params(cfg, gen.device),
    }


def encode(params, enc_embeddings: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    h = enc_embeddings.to(cfg.dtype)
    for l in range(cfg.encoder_layers):
        h = B.encoder_block_forward(layer_slice(params["encoder"], l), h, cfg)
    return apply_norm(h, params["enc_norm"], cfg)


def decode_train(params, memory, dec_tokens, cfg: ModelConfig, *,
                 use_dense: Optional[bool] = None, remat: bool = False):
    """The decoder over whole token sequences: final-normed h [B, S, d].
    `remat`: each decoder layer recomputed in the backward (the reference's
    plain `jax.checkpoint`: nothing saved)."""
    block = B.decoder_block_forward
    if remat:
        block = functools.partial(torch.utils.checkpoint.checkpoint, block,
                                  use_reentrant=False)
    h = params["embed"][dec_tokens.long()]
    for l in range(cfg.decoder_layers):
        h, _ = block(layer_slice(params["decoder"], l), h, cfg,
                     memory=memory, use_dense=use_dense)
    return apply_norm(h, params["final_norm"], cfg)


def encdec_forward(params, enc_embeddings, dec_tokens, cfg: ModelConfig, *,
                   use_dense: Optional[bool] = None):
    """Full logits [B, S_dec, V]; `use_dense` as in `attention_forward`."""
    memory = encode(params, enc_embeddings, cfg)
    h = decode_train(params, memory, dec_tokens, cfg, use_dense=use_dense)
    return h @ params["embed"].T


def encdec_loss(params, cfg: ModelConfig, enc_embeddings, dec_tokens, labels,
                remat: bool = True, ce_block: int = 512):
    """(ce, {"ce": ce}): mean token CE over `ce_block`-position blocks, as
    the reference computes it; differentiable, the decoder recomputed per
    layer in the backward under `remat` (the reference's default)."""
    memory = encode(params, enc_embeddings, cfg)
    h = decode_train(params, memory, dec_tokens, cfg, remat=remat)
    ce = blocked_ce(h, params["embed"].T, labels, ce_block)
    return ce, {"ce": ce}


def encdec_prefill(params, enc_embeddings, dec_tokens, cfg: ModelConfig,
                   max_len: Optional[int] = None, *,
                   use_dense: Optional[bool] = None):
    """Returns (last logits [B, V], (memory, self-attention KVCache stacked
    [L, ...] over the decoder layers)); `use_dense` as in
    `attention_forward`."""
    memory = encode(params, enc_embeddings, cfg)
    h = params["embed"][dec_tokens.long()]
    caches = []
    for l in range(cfg.decoder_layers):
        h, cache = B.decoder_block_prefill(
            layer_slice(params["decoder"], l), h, cfg, memory=memory,
            max_len=max_len, use_dense=use_dense)
        caches.append(cache)
    h = apply_norm(h, params["final_norm"], cfg)
    logits = (h[:, -1:] @ params["embed"].T)[:, 0]
    return logits, (memory, _stack(caches))


def encdec_decode_step(params, cfg: ModelConfig, state, token):
    """state = (memory, caches); token [B] int.  Returns (logits [B, V],
    state).  CONSUMES the caches as `lm_decode_step` does: each layer's k/v
    is written and its length advanced in place, and the same state comes
    back."""
    memory, caches = state
    h = params["embed"][token.long()[:, None]]
    for l in range(cfg.decoder_layers):
        h, _ = B.decoder_block_decode(layer_slice(params["decoder"], l), h,
                                      _cache_at(caches, l), cfg,
                                      memory=memory)
    h = apply_norm(h, params["final_norm"], cfg)
    return (h @ params["embed"].T)[:, 0], state


def init_encdec_caches(cfg: ModelConfig, batch: int, max_len: int,
                       enc_len: int, prefilled: int = 0, device="cuda"):
    """(memory zeros [B, enc_len, d], KVCache zeros [L, B, max_len, kvh, hd]
    with every length `prefilled`), on the card unless `device` says
    otherwise."""
    n = cfg.decoder_layers
    shape = (n, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    caches = KVCache(torch.zeros(shape, dtype=cfg.dtype, device=device),
                     torch.zeros(shape, dtype=cfg.dtype, device=device),
                     torch.full((n,), prefilled, dtype=torch.int32,
                                device=device))
    memory = torch.zeros((batch, enc_len, cfg.d_model), dtype=cfg.dtype,
                         device=device)
    return (memory, caches)
