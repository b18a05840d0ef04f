"""Encoder-decoder backbone (Seamless-M4T style, modality frontend stubbed).

Encoder: bidirectional self-attention blocks over precomputed frame
embeddings (the audio frontend is a stub: callers supply [B, S_enc, d_model]
embeddings, `frontends.synthetic_embeddings` makes random ones).  Decoder:
causal self-attention (the flash kernel when S_dec > attn_chunk) + cross
attention over the encoder memory + dense FFN.  Decoder token convention:
S_dec = max(S_enc // 8, 64) (speech-to-text ratio).

Inside a mesh step the encoder's and decoder's layers are gathered one at a
time as they run (`pshard.stage_gathers()`: {"encoder": ..., "decoder":
...}) and computed over "model" on the rank's heads and FFN columns, and
the tied embedding may hold the rank's vocab rows.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.models import blocks as B
from repro_torch.models import pshard
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (ModelConfig, apply_norm, embed_init,
                                       make_norm_params)
from repro_torch.models.lm import (_cache_at, _gathered, _head_weight,
                                   _stack, _vocab_start, blocked_ce,
                                   embed_tokens, layer_slice, lm_head)


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


def _plan(name: str):
    """The LeafGathers of the "encoder" or "decoder" stack inside a mesh
    step that gathers per layer (`pshard.stage_gathers()`, a dict here),
    else None."""
    plans = pshard.stage_gathers()
    return plans[name] if plans else None


def _decoder_seq():
    """The decoder's KV caches' SeqShard inside a mesh serving step (the
    caches' tree `(memory, KVCache)` of them), else None."""
    seqs = pshard.stage_sequences()
    return seqs[1] if seqs else None


def encode(params, enc_embeddings: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """The encoder memory [B, S_enc, d]; each layer gathered just before it
    runs inside a mesh step."""
    h = enc_embeddings.to(cfg.dtype)
    plan = _plan("encoder")
    block = _gathered(B.encoder_block_forward)
    for l in range(cfg.encoder_layers):
        h = block(layer_slice(params["encoder"], l), layer_slice(plan, l), h,
                  cfg)
    return apply_norm(h, params["enc_norm"], cfg)


def decode_train(params, memory, dec_tokens, cfg: ModelConfig, *,
                 use_dense: Optional[bool] = None, remat: bool = False):
    """The decoder over whole token sequences: final-normed h [B, S, d].
    `remat`: each decoder layer recomputed in the backward (the reference's
    plain `jax.checkpoint`: nothing saved), its gathers too."""
    block = _gathered(B.decoder_block_forward)
    if remat:
        block = functools.partial(torch.utils.checkpoint.checkpoint, block,
                                  use_reentrant=False)
    plan = _plan("decoder")
    h = embed_tokens(params, dec_tokens, None, cfg)
    for l in range(cfg.decoder_layers):
        h, _ = block(layer_slice(params["decoder"], l), layer_slice(plan, l),
                     h, cfg, memory=memory, use_dense=use_dense)
    return apply_norm(h, params["final_norm"], cfg)


def encdec_forward(params, enc_embeddings, dec_tokens, cfg: ModelConfig, *,
                   use_dense: Optional[bool] = None):
    """Full logits [B, S_dec, V]; `use_dense` as in `attention_forward`."""
    memory = encode(params, enc_embeddings, cfg)
    h = decode_train(params, memory, dec_tokens, cfg, use_dense=use_dense)
    return lm_head(params, h, cfg)


def encdec_loss(params, cfg: ModelConfig, enc_embeddings, dec_tokens, labels,
                remat: bool = True, ce_block: int = 512):
    """(ce, {"ce": ce}): mean token CE over `ce_block`-position blocks, as
    the reference computes it; differentiable, the decoder recomputed per
    layer in the backward under `remat` (the reference's default).  The
    tied embedding may hold the rank's vocab rows (`lm.blocked_ce`)."""
    memory = encode(params, enc_embeddings, cfg)
    h = decode_train(params, memory, dec_tokens, cfg, remat=remat)
    w = _head_weight(params, cfg)
    ce = blocked_ce(h, w, labels, ce_block, _vocab_start(w.shape[-1], cfg))
    return ce, {"ce": ce}


def encdec_prefill(params, enc_embeddings, dec_tokens, cfg: ModelConfig,
                   max_len: Optional[int] = None, *,
                   use_dense: Optional[bool] = None):
    """Returns (last logits [B, V], (memory, self-attention KVCache stacked
    [L, ...] over the decoder layers)); `use_dense` as in
    `attention_forward`.  Inside a mesh serving step each layer is
    gathered as it runs and the KV cache is the rank's shard."""
    memory = encode(params, enc_embeddings, cfg)
    h = embed_tokens(params, dec_tokens, None, cfg)
    plan, seq = _plan("decoder"), _decoder_seq()
    caches = []
    for l in range(cfg.decoder_layers):
        with pshard.sequence_parallel(seq):
            h, cache = B.decoder_block_prefill(
                pshard.gather_tree(layer_slice(params["decoder"], l),
                                   layer_slice(plan, l)), h, cfg,
                memory=memory, max_len=max_len, use_dense=use_dense)
        caches.append(cache)
    h = apply_norm(h, params["final_norm"], cfg)
    logits = lm_head(params, h[:, -1:], cfg)[:, 0]
    return logits, (memory, _stack(caches))


def encdec_decode_step(params, cfg: ModelConfig, state, token):
    """state = (memory, caches); token [B] int.  Returns (logits [B, V],
    state).  CONSUMES the caches as `lm_decode_step` does: each layer's k/v
    is written and its length advanced in place, and the same state comes
    back."""
    memory, caches = state
    h = embed_tokens(params, token[:, None], None, cfg)
    plan, seq = _plan("decoder"), _decoder_seq()
    for l in range(cfg.decoder_layers):
        with pshard.sequence_parallel(seq):
            h, _ = B.decoder_block_decode(
                pshard.gather_tree(layer_slice(params["decoder"], l),
                                   layer_slice(plan, l)), h,
                _cache_at(caches, l), cfg, memory=memory)
    h = apply_norm(h, params["final_norm"], cfg)
    return lm_head(params, h, cfg)[:, 0], state


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
