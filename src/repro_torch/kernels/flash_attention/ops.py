"""Model-layout adapter for the flash attention kernel."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._launch import needs_grad
from repro_torch.kernels.flash_attention.flash_attention import (
    FlashAttention, flash_launch)
from repro_torch.kernels.flash_attention.ref import attention_fwd_ref
from repro_torch.kernels.flash_attention.ref import expand_kv as _expand_kv

__all__ = ["_expand_kv", "mha_flash"]


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None) -> torch.Tensor:
    """Model layout [B, S, H, dh]; k, v may have fewer heads (GQA).  On a
    CUDA tensor the kernel reads this layout directly and indexes the KV head
    itself; on the CPU the plain version runs on the expanded heads.  Where
    autograd records, the call goes through `FlashAttention`, whose backward
    is the backward kernel (its plain version on the CPU)."""
    if needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, softcap)
    if q.device.type != "cpu":
        return flash_launch(q, k, v, causal=causal, window=window,
                            softcap=softcap)
    return attention_fwd_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)[0]
