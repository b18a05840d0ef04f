"""GQA causal self-attention for the prefill path.

Supports GQA (num_kv_heads < num_heads), QKV bias, sliding windows, logit
softcap and QK norm.  `dense_causal_attention` is the O(S^2)-memory oracle;
the other branch of `attention_forward` is the flash attention kernel
(`repro_torch.kernels.flash_attention`), which never materialises the
[S, S] scores.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import _expand_kv, mha_flash
from repro_torch.models.common import (ModelConfig, apply_rope, dense_init,
                                       rms_norm)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_attention_params(gen: torch.Generator, cfg: ModelConfig,
                          stack: tuple = ()):
    """`stack` prepends leading axes (the [L] layer axis) to every leaf."""
    d, dev = cfg.d_model, gen.device
    p = {
        "wq": dense_init(gen, stack + (d, cfg.q_dim), d, cfg.dtype),
        "wk": dense_init(gen, stack + (d, cfg.kv_dim), d, cfg.dtype),
        "wv": dense_init(gen, stack + (d, cfg.kv_dim), d, cfg.dtype),
        "wo": dense_init(gen, stack + (cfg.q_dim, d), cfg.q_dim, cfg.dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(stack + (cfg.q_dim,), dtype=cfg.dtype, device=dev)
        p["bk"] = torch.zeros(stack + (cfg.kv_dim,), dtype=cfg.dtype, device=dev)
        p["bv"] = torch.zeros(stack + (cfg.kv_dim,), dtype=cfg.dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(stack + (cfg.head_dim,), dtype=cfg.dtype,
                                 device=dev)
        p["k_norm"] = torch.ones(stack + (cfg.head_dim,), dtype=cfg.dtype,
                                 device=dev)
    return p


def _project_qkv(p, x, x_kv, cfg: ModelConfig, positions, kv_positions):
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x_kv @ p["wk"]
    v = x_kv @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, x_kv.shape[1], cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, x_kv.shape[1], cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
    if kv_positions is not None:
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def dense_causal_attention(q, k, v, cfg: ModelConfig,
                           window: Optional[int]) -> torch.Tensor:
    """Reference O(S^2)-memory attention (small seqs / oracle)."""
    B, S, H, hd = q.shape
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * (hd ** -0.5)
    if cfg.logit_softcap is not None:
        s = torch.tanh(s / cfg.logit_softcap) * cfg.logit_softcap
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# Public block-level entry point
# ---------------------------------------------------------------------------


def attention_forward(p, x, cfg: ModelConfig, *, window: Optional[int] = None,
                      positions: Optional[torch.Tensor] = None,
                      use_dense: Optional[bool] = None) -> torch.Tensor:
    """Causal self-attention over full sequence. x: [B, S, d].

    `use_dense=True` takes the dense oracle, `False` the flash attention
    kernel; left at None, sequences up to `cfg.attn_chunk` go dense (the
    reference's rule) and longer ones through the kernel."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, x, x, cfg, positions, positions)
    if use_dense is None:
        use_dense = S <= cfg.attn_chunk
    if use_dense:
        o = dense_causal_attention(q, k, v, cfg, window)
    else:
        o = mha_flash(q, k, v, causal=True, window=window,
                      softcap=cfg.logit_softcap)
    return o.reshape(B, S, cfg.q_dim) @ p["wo"]
