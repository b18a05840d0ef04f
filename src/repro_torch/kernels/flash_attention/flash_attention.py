"""Blocked causal flash attention (prefill hot spot).

`flash_attention` is the wrapper of the CUDA kernel in
`csrc/flash_attention.cu`; it replaces the TPU kernel
`repro.kernels.flash_attention.flash_attention.flash_attention`.
`attention_ref` is the plain PyTorch version of the same function.  The
wrapper takes it only for tensors that lie on the CPU; for CUDA tensors it
launches the kernel or raises.

`route` picks one of three kernels by shape and the launch function runs
it: "wgmma" (bf16, head dim 64 or 128, TMA-describable tensors: the main
path), "wmma" (other bf16, and every bf16 at head dim 32, 192 or 256) and
"fma" (fp32, every head dim in `HEAD_DIMS`).  `flash_attention.launches`
counts every launch and `flash_attention.launches_by_route` splits them by
route.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build, _launch

# head dims the .cu instantiates on the fma and wmma routes, and the ones
# its wgmma kernel takes (a test reads both out of the .cu)
HEAD_DIMS = (32, 64, 128, 192, 256)
WGMMA_HEAD_DIMS = (64, 128)


def route(dtype: torch.dtype, dh: int, ptrs: Sequence[int],
          strides: Sequence[Sequence[int]]) -> str:
    """The kernel `flash_attention_launch` runs, by shape: fp32 -> "fma"
    (head dims 32, 64, 128, 192, 256); bf16 with a head dim in
    `WGMMA_HEAD_DIMS` (64, 128) whose q, k, v bases (`ptrs`) are 16-byte
    aligned and whose (batch, position, head) strides (elements) are
    multiples of 8, i.e. of 16 bytes, as TMA needs -> "wgmma"; any other
    bf16, among them every one at head dim 32, 192 or 256 (deepseek_v32's
    192, gemma3's 256) -> "wmma".  `flash_launch` refuses a head dim outside
    `HEAD_DIMS` before this is asked."""
    if dtype == torch.float32:
        return "fma"
    tma = (dh in WGMMA_HEAD_DIMS and all(p % 16 == 0 for p in ptrs)
           and all(x % 8 == 0 for st in strides for x in st))
    return "wgmma" if tma else "wmma"


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
    if q.dtype not in _launch.DTYPES or k.dtype != q.dtype \
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
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    strides = (q.stride()[:3], k.stride()[:3], v.stride()[:3])
    r = route(q.dtype, dh, ptrs, strides)
    code = lib.flash_attention_launch(
        *ptrs, o.data_ptr(), _launch.ROUTES.index(r), B, H, KVH, S, dh,
        *strides[0], *strides[1], *strides[2], *o.stride()[:3],
        int(bool(causal)), int(window) if window is not None else 0,
        float(softcap) if softcap is not None else 0.0,
        1.0 / math.sqrt(dh), _launch.stream_ptr(q.device))
    _launch.check(code, "flash_attention")
    _launch.count_launch(flash_attention, r)
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
flash_attention.launches_by_route = dict.fromkeys(_launch.ROUTES, 0)
