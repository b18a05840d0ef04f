"""Model-layout adapter for the flash attention kernel."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    attention_ref, flash_launch)


def _expand_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, kv_heads, hd] -> [B, S, num_heads, hd] by group replication."""
    kvh = k.shape[2]
    if kvh == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // kvh, dim=2)


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None) -> torch.Tensor:
    """Model layout [B, S, H, dh]; k, v may have fewer heads (GQA).  On a
    CUDA tensor the kernel reads this layout directly and indexes the KV head
    itself; on the CPU the plain version runs on the expanded heads."""
    B, S, H, dh = q.shape
    if q.device.type != "cpu":
        return flash_launch(q, k, v, causal=causal, window=window,
                            softcap=softcap)
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)

    def to_bh(x):
        return x.permute(0, 2, 1, 3).reshape(B * H, S, dh)

    o = attention_ref(to_bh(q), to_bh(k), to_bh(v), causal=causal,
                      window=window, softcap=softcap)
    return o.reshape(B, H, S, dh).permute(0, 2, 1, 3)
