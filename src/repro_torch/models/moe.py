"""Mixture-of-Experts FFN: top-k router + expert FFN + shared experts.

Two execution modes, as in the reference:
  * ``dense``    -- exact dropless reference (every expert on every token,
                    combined with the router weights).  The oracle the
                    disaggregated executor is held against.
  * ``capacity`` -- sort tokens by expert, scatter into fixed [E, C, d]
                    capacity buffers, batched expert matmul, gather and
                    combine.  The payload movement runs through the
                    dispatch/combine kernels (`kernels/dispatch_combine`): on
                    a card their CUDA kernels, on the CPU their plain
                    versions.  The decode step of prefill/decode serving
                    runs this mode.  `moe_dispatch`/`moe_combine` are its
                    plain torch oracles.

The batched expert matmul is pluggable (`gmm=`), as in the reference.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.kernels.dispatch_combine.ops import (kernel_moe_combine,
                                                      kernel_moe_dispatch)
from repro_torch.models import pshard
from repro_torch.models.common import ModelConfig, act_fn, dense_init


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor  # scalar
    dropped_fraction: torch.Tensor  # scalar, share of routed pairs dropped
    expert_load: torch.Tensor  # [E] share of routed pairs per expert


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_moe_params(gen: torch.Generator, cfg: ModelConfig,
                    stack: tuple = ()):
    d, f, E = cfg.d_model, cfg.expert_d_ff, cfg.num_experts
    p = {
        "router": dense_init(gen, stack + (d, E), d, torch.float32),
        "experts": {
            "w_gate": dense_init(gen, stack + (E, d, f), d, cfg.dtype),
            "w_up": dense_init(gen, stack + (E, d, f), d, cfg.dtype),
            "w_down": dense_init(gen, stack + (E, f, d), f, cfg.dtype),
        },
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": dense_init(gen, stack + (d, fs), d, cfg.dtype),
            "w_up": dense_init(gen, stack + (d, fs), d, cfg.dtype),
            "w_down": dense_init(gen, stack + (fs, d), fs, cfg.dtype),
        }
    return p


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------


def router_topk(p_router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig):
    """x: [T, d] -> (weights [T,K] fp32, idx [T,K] int32, probs [T,E] fp32)."""
    logits = x.float() @ p_router  # router always fp32
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.router_renorm:
        weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    return weights, idx.to(torch.int32), probs


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                      num_experts: int):
    """Switch-style auxiliary loss: E * sum_e f_e * P_e, f by scatter-add
    (exact integer counts, no [T, K, E] one-hot and no host read).  Inside
    a data-parallel step (`pshard.data_parallel`) f and P are the means over
    the group's equal batch shards, so the loss is the global batch's."""
    flat = idx.reshape(-1).long()
    counts = torch.zeros(num_experts, dtype=torch.float32, device=idx.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    f = pshard.all_reduce_mean(counts / max(idx.shape[0], 1))
    P = pshard.all_reduce_mean(torch.mean(probs, dim=0))
    return num_experts * torch.sum(f * P), f / max(idx.shape[1], 1)


# ---------------------------------------------------------------------------
# Expert FFN (gated)
# ---------------------------------------------------------------------------


def gated_ffn(x, w_gate, w_up, w_down, act, width: Optional[int] = None):
    """One gated FFN: act(x @ w_gate) * (x @ w_up) @ w_down -- the shared-
    expert / single-expert building block (also used by the threaded executor
    for shared-expert compute on the attention device).  `width`: the
    FFN's whole hidden width; where the weights hold fewer columns they are
    this rank's share over "model" (column-parallel gate / up, row-parallel
    down), and the ranks' partial outputs are added up."""
    tp = width is not None and w_gate.shape[-1] != width
    if tp:
        x = pshard.copy_to_model(x)
    h = act(x @ w_gate) * (x @ w_up)
    return pshard.reduce_from_model(h @ w_down) if tp else h @ w_down


def default_gmm(xb: torch.Tensor, experts: dict,
                cfg: ModelConfig) -> torch.Tensor:
    """Batched expert matmul on capacity buffers. xb: [E, C, d] -> [E, C, d]."""
    act = act_fn(cfg.act)
    g = torch.einsum("ecd,edf->ecf", xb, experts["w_gate"])
    u = torch.einsum("ecd,edf->ecf", xb, experts["w_up"])
    h = act(g) * u
    return torch.einsum("ecf,efd->ecd", h, experts["w_down"])


# ---------------------------------------------------------------------------
# Dense (oracle) mode
# ---------------------------------------------------------------------------


def moe_forward_dense(p, x: torch.Tensor, cfg: ModelConfig):
    """Exact dropless MoE. x: [T, d] -> (y [T, d], MoEAux with
    dropped_fraction 0).  O(T*E*f) compute -- smoke/oracle only.

    Every expert runs on every token; the loop over experts keeps the
    [T, E, d] intermediate of the reference's einsum out of memory (at 128
    experts it would not fit) while summing experts in the same order."""
    T, d = x.shape
    weights, idx, probs = router_topk(p["router"], x, cfg)
    act = act_fn(cfg.act)
    combine = torch.zeros((T, cfg.num_experts), dtype=torch.float32,
                          device=x.device)
    combine.scatter_add_(1, idx.long(), weights)
    combine = combine.to(x.dtype)
    ex = p["experts"]
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for e in range(cfg.num_experts):
        y_e = gated_ffn(x, ex["w_gate"][e], ex["w_up"][e], ex["w_down"][e],
                        act)
        y = y + combine[:, e:e + 1] * y_e
    if "shared" in p:
        y = y + gated_ffn(x, p["shared"]["w_gate"], p["shared"]["w_up"],
                          p["shared"]["w_down"], act)
    lb, load = load_balance_loss(probs, idx, cfg.num_experts)
    return y, MoEAux(lb, torch.zeros((), device=x.device), load)


# ---------------------------------------------------------------------------
# Capacity mode
# ---------------------------------------------------------------------------


def expert_capacity(num_tokens: int, cfg: ModelConfig) -> int:
    c = int(num_tokens * cfg.top_k / max(cfg.num_experts, 1)
            * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # the reference rounds up to 8


def dispatch_slots(idx: torch.Tensor, num_experts: int, capacity: int):
    """Index arithmetic of the dispatch, on idx's device, no host read.
    idx: [T, K] -> (perm [T*K] sorted (token, k) pairs by expert, stable;
    slot [T*K] capacity-buffer row of each sorted pair, E*C when dropped;
    valid [T*K]; group_sizes [E] pairs routed to each expert)."""
    E, C = num_experts, capacity
    flat_e = idx.reshape(-1).long()
    perm = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[perm]
    # exact integer counts; bincount would read its maximum back
    group_sizes = torch.zeros(E, dtype=torch.long, device=idx.device)
    group_sizes.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    group_offset = torch.cumsum(group_sizes, 0) - group_sizes
    pos = torch.arange(flat_e.numel(), device=idx.device) \
        - group_offset[sorted_e]
    valid = pos < C
    slot = torch.where(valid, sorted_e * C + pos,
                       torch.full_like(pos, E * C))
    return perm, slot, valid, group_sizes


def moe_dispatch(x: torch.Tensor, idx: torch.Tensor, cfg: ModelConfig,
                 capacity: Optional[int] = None):
    """Plain sort-based dispatch (the oracle of `kernel_moe_dispatch`).
    x: [T, d]; idx: [T, K] -> (xb [E, C, d], dispatch info)."""
    T, d = x.shape
    K, E = cfg.top_k, cfg.num_experts
    C = capacity or expert_capacity(T, cfg)
    perm, slot, valid, group_sizes = dispatch_slots(idx, E, C)
    rows = x.index_select(0, perm // K)
    xb = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    xb.index_copy_(0, slot, rows)  # dropped pairs land in row E*C
    info = dict(perm=perm, slot=slot, valid=valid, group_sizes=group_sizes,
                capacity=C)
    return xb[:E * C].reshape(E, C, d), info


def moe_combine(yb: torch.Tensor, info, weights: torch.Tensor, T: int,
                via_gather: bool = False) -> torch.Tensor:
    """Plain inverse of dispatch (the oracle of `kernel_moe_combine`):
    gather expert outputs, un-permute, weight, sum over K.  via_gather
    un-permutes with a gather through argsort(perm) instead of a row
    scatter."""
    E, C, d = yb.shape
    K = weights.shape[1]
    flat = yb.reshape(E * C, d)
    valid = info["valid"]
    rows = flat.index_select(0, torch.where(valid, info["slot"], 0))
    gathered = torch.where(valid[:, None], rows, torch.zeros_like(rows))
    if via_gather:
        out_sorted = gathered.index_select(0, torch.argsort(info["perm"]))
    else:
        out_sorted = torch.zeros((T * K, d), dtype=flat.dtype,
                                 device=flat.device)
        out_sorted.index_copy_(0, info["perm"], gathered)
    out = out_sorted.reshape(T, K, d)
    return torch.einsum("tkd,tk->td", out, weights.to(out.dtype))


def moe_forward_capacity(p, x: torch.Tensor, cfg: ModelConfig,
                         gmm: Optional[Callable] = None,
                         capacity: Optional[int] = None):
    """Capacity-mode MoE. x: [T, d] -> (y [T, d], MoEAux).

    Each of the `dispatch_groups` groups sorts and scatters only its own
    tokens (the reference vmaps over groups; here a loop); one expert matmul
    runs over all groups' buffers.  The payload moves through the
    dispatch/combine kernels; `combine_via_gather` selects how the combine
    un-permutes, as in the reference.  Inside a data-parallel step of n
    ranks x holds 1/n of the batch and so `dispatch_groups / n` whole
    groups: the capacity sees the reference's per-group token count.  The
    `moe_shard_constraints` hints sit where the reference's do.

    Expert parallel (`pshard.model_parallel`, `p["experts"]` holding this
    rank's whole experts): the router runs replicated and every rank of
    "model" dispatches the same tokens (they share its data shard), keeps
    its experts' rows of the buffer (`scatter_to_model`), runs the expert
    matmul on them and all-gathers the outputs before the combine; each
    capacity row is its own chain of dots, so the output equals the one-
    device layer's.  The shared expert is tensor parallel as the dense
    FFN."""
    T, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    ep = p["experts"]["w_gate"].shape[0] != E
    weights, idx, probs = router_topk(p["router"], x, cfg)
    G = _local_groups(cfg.dispatch_groups)
    G = G if T % G == 0 else 1
    Tg = T // G
    C = capacity or expert_capacity(Tg, cfg)
    xg, idxg, wg = (a.reshape(G, Tg, -1) for a in (x, idx, weights))
    if cfg.moe_shard_constraints:
        xg = pshard.constrain(xg, "moe_group", None, None)
        idxg = pshard.constrain(idxg, "moe_group", None, None)
    xbs, infos = zip(*(kernel_moe_dispatch(xg[g], idxg[g], cfg, C)
                       for g in range(G)))
    # [E, G, C, d] -> [E, G*C, d]: one matmul per expert over all groups
    xb = torch.stack(xbs, 1)
    if cfg.moe_shard_constraints:
        xb = pshard.constrain(xb, None, "moe_group", None, None)
    xb2 = xb.reshape(E, G * C, d)
    if cfg.moe_shard_constraints:
        xb2 = pshard.constrain(xb2, "experts", "moe_rows", None)
    if ep:
        xb2 = pshard.scatter_to_model(xb2, 0)
    yb2 = (gmm or default_gmm)(xb2, p["experts"], cfg)
    if ep:
        yb2 = pshard.gather_from_model(yb2, 0)
    if cfg.moe_shard_constraints:
        yb2 = pshard.constrain(yb2, "experts", "moe_rows", None)
    yb = yb2.reshape(E, G, C, d)
    if cfg.moe_shard_constraints:
        yb = pshard.constrain(yb, None, "moe_group", None, None)
    ys = [kernel_moe_combine(yb[:, g].contiguous(), infos[g], wg[g], Tg,
                             via_gather=cfg.combine_via_gather)
          for g in range(G)]
    y = ys[0] if G == 1 else torch.cat(ys, 0)
    if cfg.moe_shard_constraints:
        y = pshard.constrain(y, "moe_tokens", None)
    lb, load = load_balance_loss(probs, idx, E)
    kept = sum(info["valid"].sum() for info in infos)
    aux = MoEAux(lb, 1.0 - kept / (T * K), load)
    if "shared" in p:
        y = y + gated_ffn(x, p["shared"]["w_gate"], p["shared"]["w_up"],
                          p["shared"]["w_down"], act_fn(cfg.act),
                          cfg.expert_d_ff * cfg.num_shared_experts)
    return y, aux


def _local_groups(groups: int) -> int:
    """The dispatch groups of this rank's batch shard."""
    n = pshard.data_parallel_size()
    if n == 1:
        return max(groups, 1)
    if groups % n:
        raise ValueError(
            f"dispatch_groups={groups} over {n} data-parallel ranks: a rank "
            f"must hold whole groups (set it with "
            f"launch.sharding.dispatch_groups_for)")
    return groups // n


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig, *,
                mode: str = "capacity", gmm: Optional[Callable] = None,
                capacity: Optional[int] = None):
    if mode == "dense":
        return moe_forward_dense(p, x, cfg)
    return moe_forward_capacity(p, x, cfg, gmm=gmm, capacity=capacity)
