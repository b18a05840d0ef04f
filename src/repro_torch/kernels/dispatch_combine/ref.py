"""Plain PyTorch versions of the dispatch/combine kernels.

The same functions as `csrc/dispatch_combine.cu`, in torch ops that never
read an index back to the host.  The trash row `rows_out - 1` of
`dispatch_scatter_ref` stays zero, as in the kernel (the reference's scatter
writes the dropped pairs there and its callers ignore the row)."""
from __future__ import annotations

import torch


def dispatch_scatter_ref(token_of: torch.Tensor, slot: torch.Tensor,
                         x: torch.Tensor, rows_out: int) -> torch.Tensor:
    """out[slot[i]] = x[token_of[i]]; out: [rows_out, d], zeros elsewhere.
    Pairs aimed at the trash row or outside the table are dropped."""
    trash = rows_out - 1
    keep = (slot >= 0) & (slot < trash) & (token_of >= 0) \
        & (token_of < x.shape[0])
    dst = torch.where(keep, slot.long(), trash)
    src = x.index_select(0, torch.where(keep, token_of.long(), 0))
    out = torch.zeros((rows_out, x.shape[1]), dtype=x.dtype, device=x.device)
    out.index_copy_(0, dst, src)  # valid slots are unique
    out[trash] = 0  # whichever dropped pair landed there last
    return out


def combine_gather_ref(slot: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """out[i] = yb[slot[i]]; a slot outside yb gives a zero row."""
    R = yb.shape[0]
    ok = (slot >= 0) & (slot < R)
    rows = yb.index_select(0, torch.where(ok, slot.long(), 0))
    return torch.where(ok[:, None], rows, torch.zeros_like(rows))


# Pairs ranked at once by the whole dispatch: the block of its kernel
# (WHOLE_THREADS in csrc/dispatch_combine.cu).
RANK_CHUNK = 256


def dispatch_whole_ref(x: torch.Tensor, idx: torch.Tensor, num_experts: int,
                       capacity: int):
    """The whole dispatch of `moe_dispatch`, as its kernel computes it.
    x: [T, d]; idx: [T, K] expert ids -> (xb [E*C, d], perm, slot, valid,
    group_sizes, pair_slot).  Stable ranks come chunk by chunk in pair
    order, per-expert counts carried across chunks (no sort); pair_slot[i]
    is pair i's capacity row, E*C when dropped; capacity row c of expert e
    holds the c-th pair routed to e.  Ids outside [0, E) share one bucket
    after the experts: counted in no group, never placed."""
    E, C = num_experts, capacity
    K = idx.shape[1]
    dev = x.device
    flat = idx.reshape(-1).long()
    N = flat.numel()
    e = torch.where((flat >= 0) & (flat < E), flat, E)
    buckets = torch.arange(E + 1, device=dev)
    counts = torch.zeros(E + 1, dtype=torch.long, device=dev)
    counts.scatter_add_(0, e, torch.ones_like(e))
    offset = torch.cumsum(counts, 0) - counts
    carry = torch.zeros(E + 1, dtype=torch.long, device=dev)
    pos = torch.empty(N, dtype=torch.long, device=dev)
    for base in range(0, N, RANK_CHUNK):
        ec = e[base:base + RANK_CHUNK]
        hit = (ec[:, None] == buckets).long()  # [chunk, E + 1]
        earlier = torch.cumsum(hit, 0) - hit  # same-bucket pairs before
        pos[base:base + RANK_CHUNK] = carry[ec] \
            + earlier.gather(1, ec[:, None])[:, 0]
        carry += hit.sum(0)
    ok = (e < E) & (pos < C)
    pair_slot = torch.where(ok, e * C + pos, E * C)
    j = offset[e] + pos  # each pair's place in the stable sort by expert
    pairs = torch.arange(N, device=dev)
    perm = torch.empty_like(pairs).index_copy_(0, j, pairs)
    slot = torch.empty_like(pairs).index_copy_(0, j, pair_slot)
    valid = torch.empty(N, dtype=torch.bool, device=dev).index_copy_(0, j, ok)
    # capacity row -> source token; dropped pairs land in a row cut off
    row_src = torch.full((E * C + 1,), -1, dtype=torch.long, device=dev)
    row_src.index_copy_(0, pair_slot, torch.where(ok, pairs // K, -1))
    row_src = row_src[:E * C]
    rows = x.index_select(0, row_src.clamp(min=0))
    xb = torch.where((row_src >= 0)[:, None], rows, torch.zeros_like(rows))
    return xb, perm, slot, valid, counts[:E], pair_slot


def combine_weighted_ref(yb: torch.Tensor, pair_slot: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """out[t] = sum_{k=0..K-1} w[t, k] * yb[pair_slot[t*K + k]], as its
    kernel computes it: each weight rounded to yb's type first, products and
    sums in fp32 each rounded on its own, over k in order, rounded to yb's
    type once.  A pair_slot outside yb adds nothing.  yb: [R, d];
    pair_slot: [T*K]; weights: [T, K] -> [T, d], yb's type."""
    R, d = yb.shape
    T, K = weights.shape
    f = _acc_type(yb)
    ps = pair_slot.reshape(T, K)
    ok = (ps >= 0) & (ps < R)
    rows = yb.index_select(0, torch.where(ok, ps, 0).reshape(-1)) \
        .reshape(T, K, d).to(f)
    w = weights.to(yb.dtype).to(f)
    acc = torch.zeros((T, d), dtype=f, device=yb.device)
    for k in range(K):
        acc = torch.where(ok[:, k, None], acc + w[:, k, None] * rows[:, k],
                          acc)
    return acc.to(yb.dtype)


def _acc_type(t: torch.Tensor) -> torch.dtype:
    """fp32 for the kernels' types; float64 stays float64 (gradchecks)."""
    return torch.promote_types(t.dtype, torch.float32)


def combine_weighted_bwd_ref(dout: torch.Tensor, yb: torch.Tensor,
                             pair_slot: torch.Tensor,
                             weights: torch.Tensor):
    """The gradient of `combine_weighted_ref`, as its kernel computes it:
    dyb[pair_slot[t*K + k]] = w[t, k] * dout[t] (the weight rounded to yb's
    type first, the product rounded once to yb's type), every other row of
    dyb zero; dw[t, k] = sum_d yb[slot, d] * dout[t, d] in fp32 (0 for a
    pair_slot outside yb).  dout: [T, d]; yb: [R, d]; pair_slot: [T*K];
    weights: [T, K] -> (dyb [R, d] yb's type, dw [T, K] fp32)."""
    R, d = yb.shape
    T, K = weights.shape
    f = _acc_type(yb)
    ps = pair_slot.reshape(-1)
    ok = (ps >= 0) & (ps < R)
    w = weights.to(yb.dtype).to(f).reshape(-1)
    g = dout.to(f).repeat_interleave(K, dim=0)  # [T*K, d], pair order
    rows = (w[:, None] * g).to(yb.dtype)
    dyb = torch.zeros((R + 1, d), dtype=yb.dtype, device=yb.device)
    dyb.index_copy_(0, torch.where(ok, ps, R), rows)  # kept slots unique
    y = yb.index_select(0, torch.where(ok, ps, 0)).to(f)
    dw = torch.where(ok, (y * g).sum(-1), torch.zeros_like(w))
    return dyb[:R], dw.reshape(T, K).to(f)
