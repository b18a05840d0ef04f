"""The dispatch/combine kernels wired into the capacity-mode MoE layer.

`kernel_moe_dispatch` / `kernel_moe_combine` have the contract of
`models.moe.moe_dispatch` / `moe_combine` (tested bit for bit, and at 1e-6 in
fp32).  Each is one call of a whole-operation route: the dispatch's index
arithmetic (stable ranks by expert, offsets, the capacity cut) and its row
writes run in `dispatch_whole`'s one launch, the combine's gather,
un-permute and weighted sum in `combine_weighted`'s one.  Nothing is read
back to the host: the capacity `C` comes from the token count, which the
host knows.

The dispatch's route is a function of the expert count alone
(`dispatch_route`): "whole" holds at most `WHOLE_MAX_EXPERTS` experts in its
rank block's shared memory; beyond that the index arithmetic runs in torch
ops (`dispatch_slots`) and the rows move through the "scatter" kernel, which
has no bound on E.

`info` carries one field beyond the reference's: `pair_slot`, each (token,
k) pair's capacity row in pair order, which the combine reads in place of
un-permuting by `perm`.

Gradients (where autograd records; serving calls the kernels directly):
`MoEDispatch`'s backward is dx[t] = sum_k dxb[pair_slot[t*K+k]] over the
kept pairs -- exactly `combine_weighted(dxb, pair_slot, ones)`, the
forward's own kernel (a dropped pair's row lies outside dxb and adds
nothing); `MoECombine`'s backward is the `combine_weighted_bwd` kernel,
which also carries the gradient to the router's weights.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._launch import needs_grad
from repro_torch.kernels.dispatch_combine.dispatch_combine import (
    WHOLE_MAX_EXPERTS, combine_weighted, combine_weighted_bwd,
    dispatch_scatter, dispatch_whole)
from repro_torch.models.common import ModelConfig


def dispatch_route(num_experts: int) -> str:
    """The route `kernel_moe_dispatch` takes for `num_experts` experts."""
    return "whole" if num_experts <= WHOLE_MAX_EXPERTS else "scatter"


def pair_slots(perm: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Each (token, k) pair's capacity row in pair order: `slot` (in
    expert-sorted order) put back through `perm`."""
    return torch.empty_like(slot).scatter_(0, perm, slot)


def _dispatch(x: torch.Tensor, idx: torch.Tensor, E: int, C: int):
    """(xb [E*C, d], perm, slot, valid, group_sizes, pair_slot) on the
    route of E."""
    from repro_torch.models.moe import dispatch_slots
    if dispatch_route(E) == "whole":
        return dispatch_whole(x, idx, E, C)
    perm, slot, valid, group_sizes = dispatch_slots(idx, E, C)
    xb = dispatch_scatter((perm // idx.shape[1]).to(torch.int32),
                          slot.to(torch.int32), x,
                          rows_out=E * C + 1)[:E * C]
    return xb, perm, slot, valid, group_sizes, pair_slots(perm, slot)


class MoEDispatch(torch.autograd.Function):
    """`_dispatch` with its gradient: dx = combine_weighted(dxb, pair_slot,
    ones) -- each token's kept capacity rows summed over k in order."""

    @staticmethod
    def forward(ctx, x, idx, E, C):
        out = _dispatch(x, idx, E, C)
        ctx.save_for_backward(out[-1])
        ctx.mark_non_differentiable(*out[1:])
        ctx.topk = idx.shape
        return out

    @staticmethod
    def backward(ctx, dxb, *_):
        pair_slot, = ctx.saved_tensors
        ones = torch.ones(ctx.topk, dtype=torch.float32, device=dxb.device)
        return combine_weighted(dxb.contiguous(), pair_slot, ones), None, \
            None, None


class MoECombine(torch.autograd.Function):
    """`combine_weighted` with its gradient, the `combine_weighted_bwd`
    kernel: the capacity rows' gradient and the weights'."""

    @staticmethod
    def forward(ctx, yb, pair_slot, weights):
        ctx.save_for_backward(yb, pair_slot, weights)
        return combine_weighted(yb, pair_slot, weights)

    @staticmethod
    def backward(ctx, dout):
        yb, pair_slot, weights = ctx.saved_tensors
        dyb, dw = combine_weighted_bwd(dout.contiguous(), yb, pair_slot,
                                       weights)
        return dyb, None, dw.to(weights.dtype)


def kernel_moe_dispatch(x: torch.Tensor, idx: torch.Tensor, cfg: ModelConfig,
                        capacity=None):
    """x: [T, d]; idx: [T, K] -> ([E, C, d], info) -- same contract as
    models.moe.moe_dispatch, plus info["pair_slot"]."""
    from repro_torch.models.moe import expert_capacity
    T, d = x.shape
    E = cfg.num_experts
    C = capacity or expert_capacity(T, cfg)
    if needs_grad(x):
        out = MoEDispatch.apply(x, idx, E, C)
    else:
        out = _dispatch(x, idx, E, C)
    xb, perm, slot, valid, group_sizes, pair_slot = out
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
        pair_slot = pair_slots(info["perm"], info["slot"])
    if needs_grad(yb, weights):
        return MoECombine.apply(yb.reshape(E * C, d), pair_slot, weights)
    return combine_weighted(yb.reshape(E * C, d), pair_slot, weights)
