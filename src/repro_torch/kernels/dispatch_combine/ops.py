"""The dispatch/combine kernels wired into the capacity-mode MoE layer.

`kernel_moe_dispatch` / `kernel_moe_combine` have the contract of
`models.moe.moe_dispatch` / `moe_combine` (tested bit for bit): the index
arithmetic (stable argsort by expert, exclusive-prefix offsets, capacity
cut) stays in torch ops on the tensors' device, and the payload movement --
the row copies -- runs in the kernels.  Nothing is read back to the host:
the capacity `C` comes from the token count, which the host knows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch_combine.dispatch_combine import (
    combine_gather, dispatch_scatter)
from repro_torch.models.common import ModelConfig


def kernel_moe_dispatch(x: torch.Tensor, idx: torch.Tensor, cfg: ModelConfig,
                        capacity=None):
    """x: [T, d]; idx: [T, K] -> ([E, C, d], info) -- same contract as
    models.moe.moe_dispatch."""
    from repro_torch.models.moe import dispatch_slots, expert_capacity
    T, d = x.shape
    K, E = cfg.top_k, cfg.num_experts
    C = capacity or expert_capacity(T, cfg)
    perm, slot, valid, group_sizes = dispatch_slots(idx, E, C)
    token_of = (perm // K).to(torch.int32)
    xb = dispatch_scatter(token_of, slot.to(torch.int32), x,
                          rows_out=E * C + 1)
    xb = xb[:E * C].reshape(E, C, d)
    info = dict(perm=perm, slot=slot, valid=valid, group_sizes=group_sizes,
                capacity=C)
    return xb, info


def kernel_moe_combine(yb: torch.Tensor, info, weights: torch.Tensor,
                       T: int, via_gather: bool = False) -> torch.Tensor:
    """yb: [E, C, d] expert outputs -> [T, d]: gather by slot (the kernel),
    un-permute (a row scatter through perm, or with `via_gather` a gather
    through argsort(perm), as `moe_combine`), weighted sum over the top-K."""
    E, C, d = yb.shape
    K = weights.shape[1]
    flat = torch.cat([yb.reshape(E * C, d),
                      torch.zeros((1, d), dtype=yb.dtype, device=yb.device)])
    gathered = combine_gather(info["slot"].to(torch.int32), flat)
    if via_gather:
        out_sorted = gathered.index_select(0, torch.argsort(info["perm"]))
    else:
        out_sorted = torch.zeros((T * K, d), dtype=flat.dtype,
                                 device=flat.device)
        out_sorted.index_copy_(0, info["perm"], gathered)  # a permutation
    out = out_sorted.reshape(T, K, d)
    return torch.einsum("tkd,tk->td", out, weights.to(out.dtype))
