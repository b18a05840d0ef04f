"""The dispatch/combine kernels wired into the capacity-mode MoE layer.

`kernel_moe_dispatch` / `kernel_moe_combine` have the contract of
`models.moe.moe_dispatch` / `moe_combine` (tested bit for bit, and at 1e-6 in
fp32).  Each is one call of a whole-operation route: the dispatch's index
arithmetic (stable ranks by expert, offsets, the capacity cut) and its row
writes run in `dispatch_whole`'s two launches, the combine's gather,
un-permute and weighted sum in `combine_weighted`'s one.  Nothing is read
back to the host: the capacity `C` comes from the token count, which the
host knows.

`info` carries one field beyond the reference's: `pair_slot`, each (token,
k) pair's capacity row in pair order, which the combine reads in place of
un-permuting by `perm`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch_combine.dispatch_combine import (
    combine_weighted, dispatch_whole)
from repro_torch.models.common import ModelConfig


def kernel_moe_dispatch(x: torch.Tensor, idx: torch.Tensor, cfg: ModelConfig,
                        capacity=None):
    """x: [T, d]; idx: [T, K] -> ([E, C, d], info) -- same contract as
    models.moe.moe_dispatch, plus info["pair_slot"]."""
    from repro_torch.models.moe import expert_capacity
    T, d = x.shape
    E = cfg.num_experts
    C = capacity or expert_capacity(T, cfg)
    xb, perm, slot, valid, group_sizes, pair_slot = dispatch_whole(
        x, idx, E, C)
    info = dict(perm=perm, slot=slot, valid=valid, group_sizes=group_sizes,
                capacity=C, pair_slot=pair_slot)
    return xb.reshape(E, C, d), info


def kernel_moe_combine(yb: torch.Tensor, info, weights: torch.Tensor,
                       T: int, via_gather: bool = False) -> torch.Tensor:
    """yb: [E, C, d] expert outputs -> [T, d]: the weighted sum over the
    top-K of each token's rows.  `via_gather` picks how `moe_combine`
    un-permutes; both give this function, so one kernel serves both.  An
    `info` without `pair_slot` (from `moe_dispatch`) gets it by one
    scatter."""
    del T, via_gather  # T is weights.shape[0]; the un-permute is implicit
    E, C, d = yb.shape
    pair_slot = info.get("pair_slot")
    if pair_slot is None:
        pair_slot = torch.empty_like(info["slot"]).scatter_(
            0, info["perm"], info["slot"])
    return combine_weighted(yb.reshape(E * C, d), pair_slot, weights)
