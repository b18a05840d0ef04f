"""Blocked causal flash attention (prefill hot spot).

`flash_attention` is the wrapper of the CUDA kernel in
`csrc/flash_attention.cu`; it replaces the TPU kernel
`repro.kernels.flash_attention.flash_attention.flash_attention`.
`attention_ref` is the plain PyTorch version of the same function.  The
wrapper takes it only for tensors that lie on the CPU; for CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build, _launch

HEAD_DIMS = (32, 64, 128)  # head dims the kernel is instantiated for


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """q, k, v: [BH, S, dh]."""
    BH, S, dh = q.shape
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float())
    s = s / math.sqrt(dh)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v).to(q.dtype)


def flash_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, window: Optional[int],
                 softcap: Optional[float]) -> torch.Tensor:
    """Launch the kernel on CUDA tensors in model layout: q [B, S, H, dh],
    k, v [B, S, KVH, dh] (KVH divides H; the kernel indexes the KV head, the
    expanded K/V are never written).  Returns [B, S, H, dh]."""
    B, S, H, dh = q.shape
    KVH = k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must lie on one CUDA "
                         "device")
    if q.dtype not in _launch.DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must share float32 or "
                         "bfloat16")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in "
                         f"{HEAD_DIMS}")
    if k.shape != (B, S, KVH, dh) or v.shape != k.shape or H % KVH:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty((B, S, H, dh), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    lib = _build.load()
    code = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _launch.DTYPE_CODE[q.dtype], B, H, KVH, S, dh,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(1), o.stride(2),
        int(bool(causal)), int(window) if window is not None else 0,
        float(softcap) if softcap is not None else 0.0,
        1.0 / math.sqrt(dh), _launch.stream_ptr(q.device))
    _launch.check(code, "flash_attention")
    _launch.count_launch(flash_attention)
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q, k, v: [BH, S, dh] (kv already head-expanded). Returns [BH, S, dh]."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    o = flash_launch(q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2),
                     causal=causal, window=window, softcap=softcap)
    return o.squeeze(2)


flash_attention.launches = 0
