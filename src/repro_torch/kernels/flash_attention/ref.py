"""Plain PyTorch versions of the flash attention kernels: the forward (and
the log-sum-exp of each row it keeps for the backward) and the backward,
recomputed from that log-sum-exp with the formulas the backward kernel
uses.  The wrappers take them for tensors on the CPU."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _mask(S: int, causal: bool, window: Optional[int], device):
    pos = torch.arange(S, device=device)
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None, return_lse: bool = False):
    """q, k, v: [BH, S, dh] -> o [BH, S, dh]; with `return_lse` also the
    [BH, S] log-sum-exp of each row's scaled (capped) masked scores, in
    fp32 (float64 for float64 inputs)."""
    BH, S, dh = q.shape
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bqd,bkd->bqk", q.to(acc), k.to(acc))
    s = s / math.sqrt(dh)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    mask = _mask(S, causal, window, q.device)
    s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o


def expand_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, kv_heads, hd] -> [B, S, num_heads, hd] by group replication."""
    kvh = k.shape[2]
    if kvh == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // kvh, dim=2)


def attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      softcap: Optional[float] = None):
    """Model layout: q [B, S, H, dh], k, v [B, S, KVH, dh] -> (o [B, S, H,
    dh], lse [B, H, S]), on the expanded heads."""
    B, S, H, dh = q.shape

    def to_bh(x):
        return expand_kv(x, H).permute(0, 2, 1, 3).reshape(B * H, S, dh)

    o, lse = attention_ref(to_bh(q), to_bh(k), to_bh(v), causal=causal,
                           window=window, softcap=softcap, return_lse=True)
    return (o.reshape(B, H, S, dh).permute(0, 2, 1, 3),
            lse.reshape(B, H, S))


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      softcap: Optional[float] = None):
    """The gradient of the forward, model layout: q, o, do [B, S, H, dh];
    k, v [B, S, KVH, dh]; lse [B, H, S] from the forward -> (dq, dk, dv) in
    the inputs' types.  In fp32 (float64 for float64 inputs):

        P = exp(S - lse) under the mask, D = rowsum(dO * O)
        dV = P^T dO, dP = dO V^T, dS = P * (dP - D) [* (1 - tanh^2)]
        dQ = dS K / sqrt(dh), dK = dS^T Q / sqrt(dh)

    dK and dV summed over each KV head's group of query heads."""
    B, S, H, dh = q.shape
    KVH = k.shape[2]
    acc = torch.promote_types(q.dtype, torch.float32)
    qf, of, dof = (t.to(acc) for t in (q, o, do))
    kf, vf = (expand_kv(t, H).to(acc) for t in (k, v))
    scale = 1.0 / math.sqrt(dh)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    th = None
    if softcap is not None:
        th = torch.tanh(s / softcap)
        s = th * softcap
    mask = _mask(S, causal, window, q.device)
    p = torch.where(mask[None, None], torch.exp(s - lse.to(acc)[..., None]),
                    torch.zeros_like(s))
    D = (dof * of).sum(-1).permute(0, 2, 1)  # [B, H, S]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - D[..., None])
    if th is not None:
        ds = ds * (1 - th * th)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    G = H // KVH
    dk = dk.reshape(B, S, KVH, G, dh).sum(3)
    dv = dv.reshape(B, S, KVH, G, dh).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
