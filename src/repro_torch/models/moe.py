"""Mixture-of-Experts FFN: top-k router + expert FFN + shared experts.

The port carries the ``dense`` mode -- the exact dropless reference that
computes every expert on every token and combines with the router weights.
It is the oracle the disaggregated executor is held against.  (The
``capacity`` mode of the reference rides on the dispatch/combine kernels,
which are not ported yet.)
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig, act_fn, dense_init

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


# ---------------------------------------------------------------------------
# Expert FFN (gated)
# ---------------------------------------------------------------------------


def gated_ffn(x, w_gate, w_up, w_down, act):
    """One gated FFN: act(x @ w_gate) * (x @ w_up) @ w_down -- the shared-
    expert / single-expert building block (also used by the threaded executor
    for shared-expert compute on the attention device)."""
    h = act(x @ w_gate) * (x @ w_up)
    return h @ w_down


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


def moe_forward_dense(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Exact dropless MoE. x: [T, d]. O(T*E*f) compute -- smoke/oracle only.

    Every expert runs on every token; the loop over experts keeps the
    [T, E, d] intermediate of the reference's einsum out of memory (at 128
    experts it would not fit) while summing experts in the same order."""
    T, d = x.shape
    weights, idx, _ = router_topk(p["router"], x, cfg)
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
    return y
