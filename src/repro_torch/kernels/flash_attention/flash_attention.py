"""Blocked causal flash attention (prefill hot spot).

`flash_attention` is the wrapper of the CUDA kernel in
`csrc/flash_attention.cu`; it replaces the TPU kernel
`repro.kernels.flash_attention.flash_attention.flash_attention`.
`attention_ref` is the plain PyTorch version of the same function.  The
wrapper takes it only for tensors that lie on the CPU; for CUDA tensors it
launches the kernel or raises.

`route` picks one of three kernels by shape and the launch function runs
it: "wgmma" (bf16, TMA-describable tensors at a head dim of
`WGMMA_HEAD_DIMS`: 64 and 128 on the main path's kernel, 192 and 256 --
deepseek_v32's and gemma3's heads -- on its wide-head sibling), "wmma"
(other bf16: head dim 32, or tensors TMA cannot describe) and "fma" (fp32,
every head dim in `HEAD_DIMS`).  `flash_attention.launches` counts every
launch and `flash_attention.launches_by_route` splits them by route.

The gradient: `FlashAttention` (a `torch.autograd.Function`) runs the
forward with its per-row log-sum-exp and, for the backward,
`flash_attention_bwd` -- the CUDA kernels of the same `.cu` on a card,
picked by `route` asked of q, k, v and dO: the forward's rule at the
forward's head dims ("wgmma" for TMA-describable bf16 at 64 and 128 and,
on the wide-head kernels, 192 and 256; "wmma" for other bf16; "fma" for
fp32; another head dim raises `NotImplementedError`), `attention_bwd_ref`
on the CPU.  The TPU kernel has no backward; the
reference trains through its plain chunked attention instead.
`flash_attention_bwd.launches` counts its launches and
`flash_attention_bwd.launches_by_route` splits them by route.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref,
                                                     attention_ref)

# head dims the .cu instantiates on the fma and wmma routes, and the ones
# its wgmma kernels take, forward and backward alike (a test reads each set
# out of the .cu, both directions)
HEAD_DIMS = (32, 64, 128, 192, 256)
WGMMA_HEAD_DIMS = (64, 128, 192, 256)
# the backward's scratch rows: S rounded up to a multiple of this (the
# .cu's wgb::PAD)
BWD_PAD = 384


def route(dtype: torch.dtype, dh: int, ptrs: Sequence[int],
          strides: Sequence[Sequence[int]]) -> str:
    """The kernels `flash_attention_launch` and `flash_attention_bwd_launch`
    run, by shape: fp32 -> "fma" (head dims 32, 64, 128, 192, 256); bf16
    with a head dim in `WGMMA_HEAD_DIMS` (64, 128, 192, 256) whose bases
    (`ptrs`: q, k, v, and dO for the backward) are 16-byte aligned and whose
    (batch, position, head) strides (elements) are multiples of 8, i.e. of
    16 bytes, as TMA needs -> "wgmma"; any other bf16 (head dim 32, an
    unaligned base or stride) -> "wmma".  `flash_launch` and
    `flash_attention_bwd` refuse a head dim outside `HEAD_DIMS` before this
    is asked."""
    if dtype == torch.float32:
        return "fma"
    tma = (dh in WGMMA_HEAD_DIMS and all(p % 16 == 0 for p in ptrs)
           and all(x % 8 == 0 for st in strides for x in st))
    return "wgmma" if tma else "wmma"


def _check_qkv(what: str, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor):
    B, S, H, dh = q.shape
    KVH = k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{what}: q, k, v must lie on one CUDA device")
    if q.dtype not in _launch.DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{what}: q, k, v must share float32 or bfloat16")
    if k.shape != (B, S, KVH, dh) or v.shape != k.shape or H % KVH:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")


def flash_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, window: Optional[int],
                 softcap: Optional[float], with_lse: bool = False):
    """Launch the kernel on CUDA tensors in model layout: q [B, S, H, dh],
    k, v [B, S, KVH, dh] (KVH divides H; the kernel indexes the KV head, the
    expanded K/V are never written).  Returns [B, S, H, dh]; with
    `with_lse`, (o, lse [B, H, S] fp32), o the same bits."""
    B, S, H, dh = q.shape
    KVH = k.shape[2]
    _check_qkv("flash_attention", q, k, v)
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in "
                         f"{HEAD_DIMS}")
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty((B, S, H, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if o.numel() == 0:
        return (o, lse) if with_lse else o
    lib = _build.load()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    strides = (q.stride()[:3], k.stride()[:3], v.stride()[:3])
    r = route(q.dtype, dh, ptrs, strides)
    code = lib.flash_attention_launch(
        *ptrs, o.data_ptr(), lse.data_ptr() if with_lse else None,
        _launch.ROUTES.index(r), B, H, KVH, S, dh,
        *strides[0], *strides[1], *strides[2], *o.stride()[:3],
        int(bool(causal)), int(window) if window is not None else 0,
        float(softcap) if softcap is not None else 0.0,
        1.0 / math.sqrt(dh), _launch.stream_ptr(q.device))
    _launch.check(code, "flash_attention")
    _launch.count_launch(flash_attention, r)
    return (o, lse) if with_lse else o


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """The gradient of the forward in model layout: q, o, do [B, S, H, dh];
    k, v [B, S, KVH, dh]; lse [B, H, S] fp32 from the forward -> (dq, dk,
    dv) in q's type.  On the CPU `attention_bwd_ref`; on CUDA tensors the
    backward kernels of the route `route` gives q, k, v and dO
    (deterministic: no atomics), or a raise -- never another route."""
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                 window=window, softcap=softcap)
    B, S, H, dh = q.shape
    KVH = k.shape[2]
    if dh not in HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention_bwd: head dim {dh} has no backward kernel "
            f"(head dims {HEAD_DIMS})")
    _check_qkv("flash_attention_bwd", q, k, v)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype or lse.shape != (B, H, S) \
            or lse.dtype != torch.float32 or lse.device != q.device \
            or o.device != q.device or do.device != q.device:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)} do not "
                         f"match q {tuple(q.shape)}")
    q, k, v, o, do = (t if t.stride(3) == 1 else t.contiguous()
                      for t in (q, k, v, o, do))
    lse = lse.contiguous()
    dq = torch.empty((B, S, H, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, KVH, dh), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    f32 = dict(dtype=torch.float32, device=q.device)
    S_pad = -(-S // BWD_PAD) * BWD_PAD
    D = torch.empty((2 * B * H * S_pad,), **f32)
    dk_part = torch.empty((B, H, S, dh), **f32)
    dv_part = torch.empty((B, H, S, dh), **f32)
    strides = [x for t in (q, k, v, o, do, dq, dk, dv) for x in t.stride()[:3]]
    r = route(q.dtype, dh, [t.data_ptr() for t in (q, k, v, do)],
              [t.stride()[:3] for t in (q, k, v, do)])
    code = _build.load().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), D.data_ptr(), dk_part.data_ptr(), dv_part.data_ptr(),
        _launch.ROUTES.index(r), B, H, KVH, S, dh,
        (ctypes.c_longlong * len(strides))(*strides), int(bool(causal)),
        int(window) if window is not None else 0,
        float(softcap) if softcap is not None else 0.0, 1.0 / math.sqrt(dh),
        _launch.stream_ptr(q.device))
    _launch.check(code, "flash_attention_bwd")
    _launch.count_launch(flash_attention_bwd, r)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention in model layout: q [B, S, H, dh], k,
    v [B, S, KVH, dh].  The forward keeps its log-sum-exp for the backward
    (the kernel's o is the same bits as without it)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        opts = dict(causal=causal, window=window, softcap=softcap)
        if q.device.type == "cpu":
            o, lse = attention_fwd_ref(q, k, v, **opts)
        else:
            o, lse = flash_launch(q, k, v, with_lse=True, **opts)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = opts
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q, k, v: [BH, S, dh] (kv already head-expanded). Returns [BH, S, dh]."""
    if _launch.needs_grad(q, k, v):
        return FlashAttention.apply(q.unsqueeze(2), k.unsqueeze(2),
                                    v.unsqueeze(2), causal, window,
                                    softcap).squeeze(2)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    o = flash_launch(q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2),
                     causal=causal, window=window, softcap=softcap)
    return o.squeeze(2)


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(_launch.ROUTES, 0)
flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_route = dict.fromkeys(_launch.ROUTES, 0)
