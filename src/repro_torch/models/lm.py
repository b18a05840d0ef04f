"""LM core: embedding, the decoder stage over stacked layer params, head.

A model is a sequence of *stages*; each stage holds its layers' params
stacked on a leading `[L, ...]` axis.  The port carries the `decoder` stage
kind (uniform causal decoder layers, dense or MoE FFN, optional window); the
other kinds of the reference arrive with their model families.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch

from repro_torch.models import blocks as B
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (ModelConfig, apply_norm, dense_init,
                                       embed_init, make_norm_params)
from repro_torch.models.moe import MoEAux

# ---------------------------------------------------------------------------
# Stage specs
# ---------------------------------------------------------------------------


def lm_stages(cfg: ModelConfig):
    """Returns [(kind, n, opts), ...]."""
    if cfg.family in ("dense", "moe") and not cfg.local_per_global:
        return [("decoder", cfg.num_layers,
                 {"moe": cfg.family == "moe", "window": cfg.window_size})]
    raise NotImplementedError(
        f"family {cfg.family!r} (local_per_global={cfg.local_per_global}): "
        f"the port carries the plain decoder stage only")


def init_lm_params(gen: torch.Generator, cfg: ModelConfig, device=None):
    """Random parameters from a seeded generator, drawn on the generator's
    device (pass `device` to check it is the one you meant).  The numbers
    differ from the reference's for the same seed; parity tests bridge the
    reference's parameters instead (`repro_torch.bridge`)."""
    if device is not None and torch.device(device).type != gen.device.type:
        raise ValueError(f"generator lives on {gen.device}, not {device}")
    params: dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.dtype),
        "stages": [
            B.init_decoder_block_params(gen, cfg, moe=opts["moe"], stack=(n,))
            for kind, n, opts in lm_stages(cfg)
        ],
        "final_norm": make_norm_params(cfg, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            gen, (cfg.d_model, cfg.vocab_size), cfg.d_model, cfg.dtype)
    return params


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_tokens(params, tokens, embeddings, cfg: ModelConfig):
    if embeddings is not None:
        h = embeddings.to(cfg.dtype)
    else:
        h = params["embed"][tokens.long()]
    if cfg.scale_embeddings:
        h = h * math.sqrt(cfg.d_model)
    return h


def lm_head(params, h, cfg: ModelConfig):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def layer_slice(sp, l: int):
    """Layer l's params out of a stacked stage: views, no copies."""
    if isinstance(sp, dict):
        return {k: layer_slice(v, l) for k, v in sp.items()}
    return None if sp is None else sp[l]


def _zero_aux(cfg: ModelConfig, device) -> MoEAux:
    z = torch.zeros((), device=device)
    return MoEAux(z, z, torch.zeros((max(cfg.num_experts, 1),),
                                    device=device))


def _mean_aux(auxs) -> MoEAux:
    return MoEAux(*(torch.stack(f).mean(0) for f in zip(*auxs)))


def lm_backbone(params, cfg: ModelConfig, tokens=None, embeddings=None, *,
                moe_mode: str = "capacity", use_dense: Optional[bool] = None,
                gmm: Optional[Callable] = None):
    """Embed + all stages + final norm. Returns (h [B,S,d], MoEAux): the
    aux is averaged over each stage's layers, then over the stages, as in
    the reference (zeros for a stage without experts).

    `gmm` replaces the capacity mode's expert matmul and gets each layer's
    id as DEVICE data: a one-element view into one `torch.arange(L)` per
    stage and call, so no layer costs a host-to-device copy."""
    h = embed_tokens(params, tokens, embeddings, cfg)
    auxs = []
    for sp, (kind, n, opts) in zip(params["stages"], lm_stages(cfg)):
        lids = torch.arange(n, dtype=torch.int32, device=h.device) \
            if gmm is not None else None
        layer_auxs = []
        for l in range(n):
            h, aux = B.decoder_block_forward(
                layer_slice(sp, l), h, cfg, window=opts.get("window"),
                moe=opts["moe"], moe_mode=moe_mode, use_dense=use_dense,
                gmm=gmm, layer_id=None if lids is None else lids[l:l + 1])
            layer_auxs.append(aux if aux is not None
                              else _zero_aux(cfg, h.device))
        auxs.append(_mean_aux(layer_auxs))
    return apply_norm(h, params["final_norm"], cfg), _mean_aux(auxs)


def lm_forward(params, cfg: ModelConfig, tokens=None, embeddings=None, *,
               moe_mode: str = "capacity", use_dense: Optional[bool] = None,
               gmm: Optional[Callable] = None):
    """Full logits (use for small scales / sampling)."""
    h, aux = lm_backbone(params, cfg, tokens, embeddings, moe_mode=moe_mode,
                         use_dense=use_dense, gmm=gmm)
    return lm_head(params, h, cfg), aux


def lm_prefill(params, cfg: ModelConfig, tokens=None, embeddings=None, *,
               max_len: Optional[int] = None,
               use_dense: Optional[bool] = None):
    """Returns (last-position logits [B, V], caches): one `KVCache` per
    stage, its k/v stacked on a leading [L] layer axis ([L, B, S, kvh, hd])
    and its length [L], as the reference's scan stacks them."""
    h = embed_tokens(params, tokens, embeddings, cfg)
    caches = []
    for sp, (kind, n, opts) in zip(params["stages"], lm_stages(cfg)):
        layer = []
        for l in range(n):
            h, cache = B.decoder_block_prefill(
                layer_slice(sp, l), h, cfg, window=opts.get("window"),
                moe=opts["moe"], max_len=max_len, use_dense=use_dense)
            layer.append(cache)
        caches.append(KVCache(*(torch.stack(f) for f in zip(*layer))))
    h = apply_norm(h, params["final_norm"], cfg)
    logits = lm_head(params, h[:, -1:], cfg)[:, 0]
    return logits, caches
