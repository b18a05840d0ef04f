"""GQA causal self-attention: the prefill path and the cached decode path.

Supports GQA (num_kv_heads < num_heads), QKV bias, sliding windows, logit
softcap and QK norm.  `dense_causal_attention` is the O(S^2)-memory oracle;
the other branch of `attention_forward`/`attention_prefill` is the flash
attention kernel (`repro_torch.kernels.flash_attention`), which never
materialises the [S, S] scores.  Decode (`attention_decode_ragged`) has no
kernel in the reference either: plain torch ops, one query per row.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention.ops import _expand_kv, mha_flash
from repro_torch.models.common import (ModelConfig, apply_rope, dense_init,
                                       rms_norm)

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, S_max, kv_heads, head_dim]
    v: torch.Tensor  # [B, S_max, kv_heads, head_dim]
    # ring-buffer write index == tokens written so far (mod window for
    # windowed layers)
    length: torch.Tensor  # scalar int32


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


def _causal(q, k, v, cfg: ModelConfig, window: Optional[int],
            use_dense: Optional[bool]) -> torch.Tensor:
    """`use_dense=True` takes the dense oracle, `False` the flash attention
    kernel; left at None, sequences up to `cfg.attn_chunk` go dense (the
    reference's rule) and longer ones through the kernel."""
    if use_dense is None:
        use_dense = q.shape[1] <= cfg.attn_chunk
    if use_dense:
        return dense_causal_attention(q, k, v, cfg, window)
    return mha_flash(q, k, v, causal=True, window=window,
                     softcap=cfg.logit_softcap)


def attention_forward(p, x, cfg: ModelConfig, *, window: Optional[int] = None,
                      positions: Optional[torch.Tensor] = None,
                      use_dense: Optional[bool] = None) -> torch.Tensor:
    """Causal self-attention over full sequence. x: [B, S, d].  `use_dense`
    as in `_causal`."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, x, x, cfg, positions, positions)
    o = _causal(q, k, v, cfg, window, use_dense)
    return o.reshape(B, S, cfg.q_dim) @ p["wo"]


def _pad_seq(t: torch.Tensor, size: int) -> torch.Tensor:
    """[B, S, ...] -> [B, size, ...], zeros after S (no copy if size == S)."""
    S = t.shape[1]
    if size == S:
        return t
    out = t.new_zeros((t.shape[0], size) + tuple(t.shape[2:]))
    out[:, :S] = t
    return out


def attention_prefill(p, x, cfg: ModelConfig, *, window: Optional[int] = None,
                      max_len: Optional[int] = None,
                      use_dense: Optional[bool] = None
                      ) -> tuple[torch.Tensor, KVCache]:
    """Full-sequence causal attention that also returns the KV cache for
    decode.  Windowed layers keep a ring buffer of the last `window` tokens
    (keys stored post-RoPE, so ring order is irrelevant); full layers keep
    all S, padded to `max_len` if given.  Takes the flash kernel whenever
    `attention_forward` would."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, x, x, cfg, positions, positions)
    o = _causal(q, k, v, cfg, window, use_dense)
    if window is not None and S >= window:
        slots = torch.arange(S - window, S, device=x.device) % window
        ck = k.new_zeros((B, window) + tuple(k.shape[2:]))
        cv = v.new_zeros((B, window) + tuple(v.shape[2:]))
        ck[:, slots] = k[:, S - window:]
        cv[:, slots] = v[:, S - window:]
    else:
        size = window if window is not None else (max_len or S)
        ck, cv = _pad_seq(k, size), _pad_seq(v, size)
    cache = KVCache(ck, cv, torch.tensor(S, dtype=torch.int32,
                                         device=x.device))
    return o.reshape(B, S, cfg.q_dim) @ p["wo"], cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  window: Optional[int] = None, device=None) -> KVCache:
    size = min(max_len, window) if window else max_len
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=device),
                   torch.zeros(shape, dtype=cfg.dtype, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


def attention_decode_ragged(p, x, k_cache, v_cache, lengths,
                            cfg: ModelConfig):
    """One-token decode over a RAGGED batch: per-row cache lengths.

    x: [B, 1, d]; k_cache/v_cache: [B, S_max, kvh, hd]; lengths: [B] int32,
    on the device.  Row b appends its new K/V at slot `lengths[b]` and
    attends over its own prefix.  Unlike the reference, which returns new
    arrays, the new token's K/V is written into `k_cache`/`v_cache` IN PLACE
    (the decode runtime owns its preallocated cache; a copy per step would
    double its traffic), and the same tensors are returned: (out [B, 1, d],
    k_cache, v_cache).  The caller advances `lengths`.

    Grouped-query attention reshapes the queries to [B, kvh, H/kvh, hd]
    rather than repeating the cache per head: the same sums, without a
    head-expanded copy of the cache."""
    B = x.shape[0]
    size = k_cache.shape[1]
    KVH, hd = cfg.num_kv_heads, cfg.head_dim
    pos = lengths[:, None]  # RoPE position of the new token, per row
    q, k, v = _project_qkv(p, x, x, cfg, pos, pos)
    rows = torch.arange(B, device=x.device)
    slot = torch.clamp(lengths.long(), max=size - 1)
    k_cache[rows, slot] = k[:, 0]
    v_cache[rows, slot] = v[:, 0]
    qg = q.reshape(B, KVH, cfg.num_heads // KVH, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float())
    s = s * (hd ** -0.5)
    if cfg.logit_softcap is not None:
        s = torch.tanh(s / cfg.logit_softcap) * cfg.logit_softcap
    valid = torch.arange(size, device=x.device)[None, :] <= slot[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    pr = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bhgs,bshd->bhgd", pr, v_cache)
    return o.reshape(B, 1, cfg.q_dim) @ p["wo"], k_cache, v_cache
