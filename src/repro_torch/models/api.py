"""Unified per-family model API.

    api = build_api(cfg)
    params = api.init(gen)                           # a torch.Generator
    loss, metrics = api.loss(params, batch)          # batch: dict
    logits, aux = api.forward(params, batch)
    logits, caches = api.prefill(params, batch)
    logits, caches = api.decode(params, caches, batch)  # consumes caches
    caches = api.make_caches(batch_size, cache_len, prefilled)
    batch = api.make_batch(gen, seq_len, batch_size, kind)

Unlike the reference's functional API, `decode` CONSUMES its caches: their
k/v are written and their lengths advanced in place, the recurrent states
(RWKV, Mamba) overwritten in place, and the same objects come back (see
`lm_decode_step`).  Clone them to keep a state to retry or branch from.

Batch dicts:
  decoder-only: {"tokens": [B,S], "labels": [B,S]} or
                {"embeddings": [B,S,d], ...}
  encdec:       {"enc_embeddings": [B,S_enc,d], "dec_tokens": [B,S_dec],
                 "labels": [B,S_dec]}
  prefill may add "max_len"; decode: {"token": [B]} (the encdec caches
  carry the encoder memory).

Every family of the reference's registry is served.  Everything runs on
the card unless the caller passes `device="cpu"` (or CPU tensors and a CPU
generator).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models import encdec as ED
from repro_torch.models import frontends
from repro_torch.models.common import ModelConfig
from repro_torch.models.lm import (init_caches, init_lm_params, lm_decode_step,
                                   lm_forward, lm_loss, lm_prefill)


class ModelAPI(NamedTuple):
    cfg: ModelConfig
    init: Callable
    loss: Callable
    forward: Callable
    prefill: Callable
    decode: Callable
    make_caches: Callable
    make_batch: Callable


def build_api(cfg: ModelConfig, **fwd_kw) -> ModelAPI:
    """`fwd_kw` go to `lm_loss` (aux_coef, ce_block, moe_mode, gmm, remat);
    the encoder-decoder's loss takes none, as in the reference.  `loss` is
    differentiable on both branches (the kernels' gradients on a card)."""
    if cfg.family == "encdec":
        return _build_encdec_api(cfg)
    return _build_lm_api(cfg, **fwd_kw)


def _build_lm_api(cfg: ModelConfig, **fwd_kw) -> ModelAPI:
    def init(gen: torch.Generator):
        return init_lm_params(gen, cfg)

    def loss(params, batch):
        return lm_loss(params, cfg, tokens=batch.get("tokens"),
                       labels=batch["labels"],
                       embeddings=batch.get("embeddings"), **fwd_kw)

    def forward(params, batch):
        return lm_forward(params, cfg, tokens=batch.get("tokens"),
                          embeddings=batch.get("embeddings"))

    def prefill(params, batch):
        return lm_prefill(params, cfg, tokens=batch.get("tokens"),
                          embeddings=batch.get("embeddings"),
                          max_len=batch.get("max_len"))

    def decode(params, caches, batch):
        return lm_decode_step(params, cfg, caches, batch["token"])

    def make_caches(batch_size, cache_len, prefilled=0, device="cuda"):
        return init_caches(cfg, batch_size, cache_len, prefilled, device)

    def make_batch(gen: torch.Generator, seq_len, batch_size, kind="train",
                   device="cuda"):
        """Random token ids (or the audio frontend's embeddings) drawn from
        `gen` on its device, handed back on `device`."""
        def ids(shape):
            return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                 device=gen.device).to(device)

        if kind == "decode":
            return {"token": ids((batch_size,))}
        batch: dict[str, Any] = {}
        if cfg.frontend == "audio":
            batch["embeddings"] = frontends.synthetic_embeddings(
                gen, cfg, batch_size, seq_len).to(device)
        else:
            batch["tokens"] = ids((batch_size, seq_len))
        if kind == "train":
            batch["labels"] = ids((batch_size, seq_len))
        return batch

    return ModelAPI(cfg, init, loss, forward, prefill, decode, make_caches,
                    make_batch)


def _build_encdec_api(cfg: ModelConfig) -> ModelAPI:
    def init(gen: torch.Generator):
        return ED.init_encdec_params(gen, cfg)

    def loss(params, batch):
        return ED.encdec_loss(params, cfg, batch["enc_embeddings"],
                              batch["dec_tokens"], batch["labels"])

    def forward(params, batch):
        return ED.encdec_forward(params, batch["enc_embeddings"],
                                 batch["dec_tokens"], cfg), None

    def prefill(params, batch):
        return ED.encdec_prefill(params, batch["enc_embeddings"],
                                 batch["dec_tokens"], cfg,
                                 max_len=batch.get("max_len"))

    def decode(params, caches, batch):
        return ED.encdec_decode_step(params, cfg, caches, batch["token"])

    def make_caches(batch_size, cache_len, prefilled=0, enc_len=None,
                    device="cuda"):
        return ED.init_encdec_caches(cfg, batch_size, cache_len,
                                     enc_len or cache_len, prefilled, device)

    def make_batch(gen: torch.Generator, seq_len, batch_size, kind="train",
                   device="cuda"):
        """`seq_len` frame embeddings (the audio frontend's stand-in) and
        `decoder_len(seq_len)` decoder tokens, drawn from `gen` on its
        device, handed back on `device`."""
        def ids(shape):
            return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                 device=gen.device).to(device)

        if kind == "decode":
            return {"token": ids((batch_size,))}
        dec_len = ED.decoder_len(seq_len)
        batch = {"enc_embeddings": frontends.synthetic_embeddings(
                     gen, cfg, batch_size, seq_len).to(device),
                 "dec_tokens": ids((batch_size, dec_len))}
        if kind == "train":
            batch["labels"] = ids((batch_size, dec_len))
        return batch

    return ModelAPI(cfg, init, loss, forward, prefill, decode, make_caches,
                    make_batch)
