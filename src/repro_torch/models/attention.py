"""GQA causal self-attention: the prefill path and the cached decode paths.

Supports GQA (num_kv_heads < num_heads), QKV bias, sliding windows, logit
softcap, QK norm, and dense cross attention (encoder-decoder).
`dense_causal_attention` is the O(S^2)-memory oracle; the other branch of
`attention_forward`/`attention_prefill` is the flash attention kernel
(`repro_torch.kernels.flash_attention`), which never materialises the
[S, S] scores.  `chunked_causal_attention` is the
reference's blocked online-softmax oracle of that kernel, in plain torch.
Decode -- `attention_decode` (one scalar cache length, ring buffers for
windowed layers) and `attention_decode_ragged` (a length per row) -- has no
kernel in the reference either: plain torch ops, one query per row.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention.ops import _expand_kv, mha_flash
from repro_torch.models import pshard
from repro_torch.models.common import (ModelConfig, apply_rope, dense_init,
                                       rms_norm)

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, S_max, kv_heads, head_dim]
    v: torch.Tensor  # [B, S_max, kv_heads, head_dim]
    # tokens written so far; a windowed layer's ring-buffer write slot is
    # this mod the window
    length: torch.Tensor  # scalar int32


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_attention_params(gen: torch.Generator, cfg: ModelConfig,
                          stack: tuple = (), cross: bool = False):
    """`stack` prepends leading axes (the [L] layer axis) to every leaf.
    Cross attention (`cross`) has the same leaves, as in the reference."""
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
    """q [B, S, H, hd], k / v [B, S_kv, KVH, hd].  H and KVH are read off
    the leaves: inside a tensor-parallel step (`pshard.model_parallel`)
    `wq` may hold this rank's heads only (whole heads, `launch.sharding.
    compute_specs`), and then `wk` / `wv` this rank's kv heads, or all of
    them where the kv heads do not split: K / V are then computed whole
    (a KV cache stores every kv head where they do not split), and the
    caller narrows them to the kv heads its local q heads read
    (`_kv_for_heads`)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    H, KVH = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    tp = H != cfg.num_heads
    kv_whole = tp and KVH == cfg.num_kv_heads
    xq = pshard.copy_to_model(x) if tp else x
    xk = x_kv if kv_whole or not tp else \
        (xq if x_kv is x else pshard.copy_to_model(x_kv))
    q = xq @ p["wq"]
    k = xk @ p["wk"]
    v = xk @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, x_kv.shape[1], KVH, hd)
    v = v.reshape(B, x_kv.shape[1], KVH, hd)
    if cfg.qk_norm:
        # a replicated norm scale on local heads: its gradient is partial
        q_norm = pshard.copy_to_model(p["q_norm"]) if tp else p["q_norm"]
        k_norm = pshard.copy_to_model(p["k_norm"]) \
            if tp and not kv_whole else p["k_norm"]
        q = rms_norm(q, q_norm, cfg.norm_eps)
        k = rms_norm(k, k_norm, cfg.norm_eps)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
    if kv_positions is not None:
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _kv_whole(H: int, KVH: int, cfg: ModelConfig) -> bool:
    """Whether H local q heads read K / V computed whole (KVH of them): a
    tensor-parallel step whose kv heads do not split over "model"."""
    return H != cfg.num_heads and KVH == cfg.num_kv_heads


def _kv_for_heads(k, v, H: int, cfg: ModelConfig):
    """K / V as `_project_qkv` gives them, narrowed to the kv heads H local
    q heads read where they were computed whole (`_local_kv_heads`)."""
    return _local_kv_heads(k, v, H, cfg) if _kv_whole(H, k.shape[2], cfg) \
        else (k, v)


def _kv_head_select(H: int, cfg: ModelConfig):
    """The kv heads this rank's H q heads read: (first, n), n consecutive
    kv heads, where the local heads cover whole groups or lie in one
    (each group's heads in a row), else the list of one kv head per local
    head."""
    G = cfg.num_heads // cfg.num_kv_heads
    first = pshard.model_parallel_rank() * H
    idx = [(first + i) // G for i in range(H)]
    uniq = sorted(set(idx))
    per = H // len(uniq)
    if per * len(uniq) == H and idx == [u for u in uniq for _ in range(per)]:
        return uniq[0], len(uniq)
    return idx


def _select_heads(t: torch.Tensor, sel) -> torch.Tensor:
    """`t`'s kv heads (dim 2) picked by `_kv_head_select`: a view where
    they are consecutive."""
    if isinstance(sel, tuple):
        return t.narrow(2, *sel)
    return t.index_select(2, torch.tensor(sel, device=t.device))


def _local_kv_heads(k, v, H: int, cfg: ModelConfig):
    """The kv heads this rank's H q heads read, out of K / V computed whole
    on every rank of "model": each local head's global group, one kv head
    per group where the local heads cover whole groups or lie in one,
    else one per local head.  The selection's gradient is partial (each
    rank's heads' share), so it is summed over "model" first
    (`copy_to_model` before the selection)."""
    sel = _kv_head_select(H, cfg)
    k, v = pshard.copy_to_model(k), pshard.copy_to_model(v)
    return (_select_heads(k, sel).contiguous(),
            _select_heads(v, sel).contiguous())


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
# Blocked online-softmax oracle of the flash kernel
# ---------------------------------------------------------------------------


def _pad_to_chunk(t: torch.Tensor, C: int) -> torch.Tensor:
    """[B, S, ...] -> [B, S rounded up to a multiple of C, ...], zeros after
    S (masked out: a padded key lies past every real query)."""
    S = t.shape[1]
    return _pad_seq(t, -(-S // C) * C)


def _attend_block(q, k, v, mask, softcap):
    """q [B,Cq,H,hd], k/v [B,Ck,H,hd], mask [Cq,Ck] bool -> (out, max,
    sumexp), fp32."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)  # [B,H,Cq]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o, m, l


def chunked_causal_attention(q, k, v, cfg: ModelConfig,
                             window: Optional[int],
                             chunk: Optional[int] = None) -> torch.Tensor:
    """Flash-style online-softmax attention, the reference's blocked oracle
    of the flash kernel.  q, k, v: [B, S, H(q|kv), hd] (kv in kv_heads;
    expanded here, or grouped when `cfg.gqa_grouped`).  Query chunks of
    `chunk` (default `cfg.attn_chunk`) rows each run an online softmax over
    the key chunks: all of them, or with `cfg.causal_block_skip` only those
    inside the causal (and window) frontier.  The `attn_dp_constraint`
    hints sit where the reference's do; its remat knobs change nothing
    here."""
    B, S, H, hd = q.shape
    if cfg.gqa_grouped and q.shape[2] != k.shape[2]:
        return _grouped_chunked_attention(q, k, v, cfg, window, chunk)
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    if cfg.attn_dp_constraint:
        q = pshard.constrain(q, "batch", None, "heads", None)
        k = pshard.constrain(k, "batch", None, "heads", None)
        v = pshard.constrain(v, "batch", None, "heads", None)
    C = min(chunk or cfg.attn_chunk, S)
    if S % C != 0:
        q, k, v = (_pad_to_chunk(t, C) for t in (q, k, v))
        return chunked_causal_attention(q, k, v, cfg, window, C)[:, :S]
    nq = S // C
    kc = k.reshape(B, nq, C, H, hd)
    vc = v.reshape(B, nq, C, H, hd)
    pos = torch.arange(C, device=q.device)
    outs = []
    for qi in range(nq):
        qb = q[:, qi * C:(qi + 1) * C]
        lo = 0
        if cfg.causal_block_skip and window is not None:
            lo = max(0, (qi * C - window) // C)
        ks = range(lo, qi + 1) if cfg.causal_block_skip else range(nq)
        o_acc = torch.zeros((B, C, H, hd), device=q.device)
        m_acc = torch.full((B, H, C), NEG_INF, device=q.device)
        l_acc = torch.zeros((B, H, C), device=q.device)
        for ki in ks:
            abs_q = qi * C + pos[:, None]
            abs_k = ki * C + pos[None, :]
            mask = abs_k <= abs_q
            if window is not None:
                mask &= abs_k > abs_q - window
            o, m, l = _attend_block(qb, kc[:, ki], vc[:, ki], mask,
                                    cfg.logit_softcap)
            m_new = torch.maximum(m_acc, m)
            corr_old = torch.exp(m_acc - m_new)
            corr_new = torch.exp(m - m_new)
            o_acc = o_acc * corr_old.permute(0, 2, 1)[..., None] \
                + o * corr_new.permute(0, 2, 1)[..., None]
            l_acc = l_acc * corr_old + l * corr_new
            m_acc = m_new
        l_acc = torch.clamp(l_acc, min=1e-30)
        outs.append((o_acc / l_acc.permute(0, 2, 1)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)


def _grouped_chunked_attention(q, k, v, cfg: ModelConfig,
                               window: Optional[int],
                               chunk: Optional[int] = None) -> torch.Tensor:
    """GQA without head-expanded k/v: scores per (kv_head, group) by einsum
    broadcasting.  Same math as `chunked_causal_attention`; every key chunk
    is visited, as in the reference."""
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    C = min(chunk or cfg.attn_chunk, S)
    if S % C != 0:
        q, k, v = (_pad_to_chunk(t, C) for t in (q, k, v))
        return _grouped_chunked_attention(q, k, v, cfg, window, C)[:, :S]
    if cfg.attn_dp_constraint:
        q = pshard.constrain(q, "batch", None, "heads", None)
        k = pshard.constrain(k, "batch", None, None, None)
        v = pshard.constrain(v, "batch", None, None, None)
    nq = S // C
    q5 = q.reshape(B, S, KVH, G, hd)
    kc = k.reshape(B, nq, C, KVH, hd)
    vc = v.reshape(B, nq, C, KVH, hd)
    scale = hd ** -0.5
    pos = torch.arange(C, device=q.device)
    outs = []
    for qi in range(nq):
        qb = q5[:, qi * C:(qi + 1) * C].float()
        o_acc = torch.zeros((B, C, KVH, G, hd), device=q.device)
        m_acc = torch.full((B, KVH, G, C), NEG_INF, device=q.device)
        l_acc = torch.zeros((B, KVH, G, C), device=q.device)
        for ki in range(nq):
            vb = vc[:, ki]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kc[:, ki].float()) \
                * scale
            if cfg.logit_softcap is not None:
                s = torch.tanh(s / cfg.logit_softcap) * cfg.logit_softcap
            abs_q = qi * C + pos[:, None]
            abs_k = ki * C + pos[None, :]
            mask = abs_k <= abs_q
            if window is not None:
                mask &= abs_k > abs_q - window
            s = torch.where(mask[None, None, None], s,
                            torch.full_like(s, NEG_INF))
            m = s.amax(dim=-1)  # [B,KVH,G,C]
            p = torch.exp(s - m[..., None])
            l = p.sum(dim=-1)
            o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(vb.dtype).float(),
                             vb.float())
            m_new = torch.maximum(m_acc, m)
            c_old = torch.exp(m_acc - m_new)
            c_new = torch.exp(m - m_new)
            o_acc = o_acc * c_old.permute(0, 3, 1, 2)[..., None] \
                + o * c_new.permute(0, 3, 1, 2)[..., None]
            l_acc = l_acc * c_old + l * c_new
            m_acc = m_new
        l_acc = torch.clamp(l_acc, min=1e-30)
        o = o_acc / l_acc.permute(0, 3, 1, 2)[..., None]
        outs.append(o.to(q.dtype))
    return torch.cat(outs, dim=1).reshape(B, S, H, hd)


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
    k, v = _kv_for_heads(k, v, q.shape[2], cfg)
    return _out_proj(_causal(q, k, v, cfg, window, use_dense), p["wo"], cfg)


def _out_proj(o: torch.Tensor, wo: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """o [B, S, H, hd] @ wo; local heads: `wo` holds their rows, the
    ranks' partial outputs add up over "model"."""
    B, S, H, hd = o.shape
    out = o.reshape(B, S, H * hd) @ wo
    return pshard.reduce_from_model(out) if H != cfg.num_heads else out


def cross_attention_forward(p, x, memory, cfg: ModelConfig) -> torch.Tensor:
    """Cross attention (decoder -> encoder memory). No RoPE on the cross
    path, no mask; dense, as in the reference (no kernel there either).
    x: [B, S, d], memory: [B, S_enc, d].  On the heads `wq` holds, as
    `attention_forward`."""
    q, k, v = _project_qkv(p, x, memory, cfg, None, None)
    H = q.shape[2]
    k, v = _kv_for_heads(k, v, H, cfg)
    o = unmasked_attention(q, _expand_kv(k, H), _expand_kv(v, H), cfg)
    return _out_proj(o, p["wo"], cfg)


def unmasked_attention(q, k, v, cfg: ModelConfig) -> torch.Tensor:
    """softmax(q kᵀ / √dh) v with no mask (cross attention, the encoder):
    fp32 scores, probabilities rounded to v's dtype before the product, as
    the reference.  q: [B, Sq, H, dh]; k, v: [B, Sk, H, dh] (heads already
    expanded; a k already in fp32 is not copied again)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * (cfg.head_dim ** -0.5)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1).to(v.dtype),
                        v)


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
    `attention_forward` would.

    Inside a mesh serving step the attention runs on the rank's local
    heads (as `attention_forward`, the partial outputs added over "model")
    and the cache keeps the rank's shard: its kv heads where they split,
    else all of them (K / V before `_local_kv_heads` narrows them for the
    kernel), and, inside `pshard.sequence_parallel`, only its slots of the
    padded buffer or of the ring."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, kc, vc = _project_qkv(p, x, x, cfg, positions, positions)
    H = q.shape[2]
    k, v = _kv_for_heads(kc, vc, H, cfg)
    o = _causal(q, k, v, cfg, window, use_dense)
    del k, v
    sp = pshard.sequence_shard()
    if sp is not None:
        size = window if window is not None else (max_len or S)
        ck, cv = (_slot_shard(t, S, size, window, sp) for t in (kc, vc))
    elif window is not None and S >= window:
        slots = torch.arange(S - window, S, device=x.device) % window
        ck = kc.new_zeros((B, window) + tuple(kc.shape[2:]))
        cv = vc.new_zeros((B, window) + tuple(vc.shape[2:]))
        ck[:, slots] = kc[:, S - window:]
        cv[:, slots] = vc[:, S - window:]
    else:
        size = window if window is not None else (max_len or S)
        ck, cv = _pad_seq(kc, size), _pad_seq(vc, size)
    cache = KVCache(ck, cv, torch.tensor(S, dtype=torch.int32,
                                         device=x.device))
    return _out_proj(o, p["wo"], cfg), cache


def _slot_shard(t: torch.Tensor, S: int, size: int, window: Optional[int],
                sp) -> torch.Tensor:
    """This rank's slots [offset, offset + size / count) of the cache
    `attention_prefill` would store whole from t [B, S, KVH, hd]: slot j
    holds position j of a full layer (zeros from S on), and of a ring of
    `window` slots the one of the last `window` positions congruent to j
    (zeros from S on where S < window)."""
    local = size // sp.count
    j = torch.arange(sp.offset, sp.offset + local, device=t.device)
    if window is not None and S >= window:
        pos = S - window + torch.remainder(j - S, window)
    else:
        pos = j
    held = pos < S
    rows = t.index_select(1, torch.clamp(pos, max=S - 1))
    return torch.where(held[None, :, None, None], rows,
                       torch.zeros_like(rows))


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  window: Optional[int] = None, device=None) -> KVCache:
    size = min(max_len, window) if window else max_len
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=device),
                   torch.zeros(shape, dtype=cfg.dtype, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


def attention_decode(p, x, cache: KVCache, cfg: ModelConfig, *,
                     window: Optional[int] = None
                     ) -> tuple[torch.Tensor, KVCache]:
    """One-token decode at one scalar cache length. x: [B, 1, d]; `cache`
    holds `cache.length` prior tokens (a 0-d int32 tensor on the device).

    Windowed layers write a ring buffer (slot `length % size`, and every
    written slot is valid: `idx < min(length + 1, size)`); full layers
    append (slot `min(length, size - 1)`, valid `idx <= min(length,
    size - 1)`) -- the reference's two rules.  Unlike the reference, which
    returns a new cache, this one CONSUMES `cache`: the new token's K/V is
    written into `cache.k` / `cache.v` and `cache.length` advances by 1, all
    IN PLACE (a copy of the cache per layer and step would multiply the
    step's traffic), through `index_copy_` with a one-element index on the
    device, so the step reads nothing back to the host.  Returns (out
    [B, 1, d], cache) -- the same KVCache, so no stale copy is left.

    Inside a mesh serving step the cache is the rank's shard, in one of
    three layouts: its kv heads (local q heads read them; the partial
    outputs of `wo`'s rows added over "model"); all kv heads whole (as on
    one device, over the local q heads); or its slots of the sequence
    (`pshard.sequence_parallel`, flash-decoding split-K): the rank owning
    the new token's slot writes it (`_owner_write`), each rank scores every
    q head it needs -- all of them, gathered over "model", where "model"
    shards the sequence -- against its keys, masked by global slot, and
    the partial softmaxes merge by their max and sum (`_merge_split_k`)."""
    B = x.shape[0]
    hd = cfg.head_dim
    length = cache.length
    pos = length.reshape(1, 1).expand(B, 1)
    q, k, v = _project_qkv(p, x, x, cfg, pos, pos)
    H = q.shape[2]
    sp = pshard.sequence_shard()
    local = cache.k.shape[1]
    size = local * (sp.count if sp is not None else 1)
    if window is not None:
        slot = length % size  # ring buffer
    else:
        slot = torch.clamp(length, max=size - 1)  # append
    i = torch.arange(local, device=x.device)
    if sp is None:
        idx = slot.reshape(1).long()
        cache.k.index_copy_(1, idx, k)
        cache.v.index_copy_(1, idx, v)
    else:
        _owner_write(cache.k, k, slot - sp.offset)
        _owner_write(cache.v, v, slot - sp.offset)
        i = i + sp.offset  # global slot indices
    valid = i <= torch.clamp(length, max=size - 1) if window is None \
        else i < torch.clamp(length + 1, max=size)
    ck, cv = cache.k, cache.v
    gathered = sp is not None and sp.model and H != cfg.num_heads
    if gathered:  # every head against this rank's slots
        q = pshard.gather_from_model(q, 2)
    elif _kv_whole(H, ck.shape[2], cfg):
        sel = _kv_head_select(H, cfg)
        ck, cv = _select_heads(ck, sel), _select_heads(cv, sel)
    KVH = ck.shape[2]
    qg = q.reshape(B, KVH, q.shape[2] // KVH, hd)
    s = _decode_scores(qg, ck, valid, cfg)
    if sp is None:
        pr = torch.softmax(s, dim=-1).to(cv.dtype)
        o = torch.einsum("bhgs,bshd->bhgd", pr, cv)
    else:
        o = _merge_split_k(s, cv, pshard.seq_max, pshard.seq_sum).to(cv.dtype)
    o = o.reshape(B, 1, q.shape[2], hd)
    if gathered:  # this rank's heads, for its rows of wo
        o = o.narrow(2, pshard.model_parallel_rank() * H, H)
    length.add_(1)  # last: pos, slot and valid above read the old length
    return _out_proj(o, p["wo"], cfg), cache


def _owner_write(buf: torch.Tensor, new: torch.Tensor,
                 local_slot: torch.Tensor):
    """buf[:, local_slot] = new where 0 <= local_slot < buf.shape[1], else
    nothing: the shard owning a global slot writes it.  The test is device
    data (the slot is clamped into the shard and the old row written back
    where the shard does not own it), so no rank reads `length` back."""
    n = buf.shape[1]
    mine = (local_slot >= 0) & (local_slot < n)
    idx = torch.clamp(local_slot, 0, n - 1).reshape(1).long()
    buf.index_copy_(1, idx, torch.where(mine, new, buf.index_select(1, idx)))


def _decode_scores(qg, k, valid, cfg: ModelConfig) -> torch.Tensor:
    """fp32 scores [..., B, KVH, G, S] of grouped queries qg [..., B, KVH,
    G, hd] against k [..., B, S, KVH, hd], softcapped, NEG_INF where
    `valid` [..., S] is False."""
    s = torch.einsum("...bhgd,...bshd->...bhgs", qg.float(), k.float())
    s = s * (cfg.head_dim ** -0.5)
    if cfg.logit_softcap is not None:
        s = torch.tanh(s / cfg.logit_softcap) * cfg.logit_softcap
    valid = valid[..., None, None, None, :]
    return torch.where(valid, s, torch.full_like(s, NEG_INF))


def _merge_split_k(s, v, reduce_max, reduce_sum) -> torch.Tensor:
    """softmax(s) v over a sequence split across shards, fp32: s [..., B,
    KVH, G, S_shard] this shard's scores, v [..., B, S_shard, KVH, hd] its
    values.  The max over every shard first, then the sum of exp(s - max);
    the probabilities are rounded to v's dtype before the product, as the
    one-device softmax's are, and the shards' products summed
    (`reduce_max` / `reduce_sum`: elementwise over the shards)."""
    m = reduce_max(s.amax(-1, keepdim=True))
    e = torch.exp(s - m)
    l = reduce_sum(e.sum(-1, keepdim=True))
    pr = (e / l).to(v.dtype)
    return reduce_sum(torch.einsum("...bhgs,...bshd->...bhgd", pr.float(),
                                   v.float()))


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
