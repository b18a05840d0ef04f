"""Decoder block (pre-norm residual) assembled from attention and MoE/FFN.

Params are stored *stacked* on a leading layer axis by the LM core (lm.py);
a block receives one layer's slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.attention import (attention_forward,
                                          init_attention_params)
from repro_torch.models.common import (ModelConfig, act_fn, apply_norm,
                                       dense_init, make_norm_params)
from repro_torch.models.moe import init_moe_params, moe_forward_dense

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
                          moe_mode: str = "dense",
                          use_dense: Optional[bool] = None) -> torch.Tensor:
    """h: [B, S, d] -> [B, S, d].  Only the dense MoE mode is ported."""
    B, S, d = h.shape
    h = h + attention_forward(p["attn"], apply_norm(h, p["ln_attn"], cfg), cfg,
                              window=window, use_dense=use_dense)
    x = apply_norm(h, p["ln_ffn"], cfg)
    if moe:
        if moe_mode != "dense":
            raise NotImplementedError(
                f"moe_mode={moe_mode!r}: the port carries the dense mode "
                f"only (the capacity mode needs the dispatch/combine "
                f"kernels)")
        y = moe_forward_dense(p["ffn"], x.reshape(B * S, d), cfg)
        return h + y.reshape(B, S, d)
    return h + ffn_forward(p["ffn"], x, cfg)
