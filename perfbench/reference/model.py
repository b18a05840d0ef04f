"""Plain PyTorch reference of the benchmark's MoE decoder models.

Independent of the program: torch alone, written from the published model
description (pre-norm decoder; RMSNorm; q / k / v / o projections with
grouped kv heads, an RMSNorm over each q and k head where the model has
one, rotary embeddings by halves; causal softmax attention; a softmax
router over the experts, top-k with the k weights renormalised to sum to 1;
SiLU-gated experts, plus the shared experts; a final RMSNorm and the LM
head).  It reads the weights the benchmark made and the prompts' token ids,
nothing the program made.

It runs layer by layer over a block of prompts so that it fits beside the
weights: one layer's weights are read at a time, attention goes a few heads
at a time.  `precision` is "fp32" (float32 throughout, TF32 off: the
reference) or "fp8": every matrix product's operands rounded to
float8 e4m3 with a scale per row of the left operand and per column of the
right one, the rest in float32 (the control: the nearest precision below
the bf16 that the configurations state).
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch

F8_MAX = 448.0  # the largest finite float8 e4m3fn


def _f8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along `dim`."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / F8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a [..., n, k] @ b [..., k, m] in float32, operands first rounded to
    float8 where `precision` is "fp8"."""
    a, b = a.float(), b.float()
    if precision == "fp8":
        a, b = _f8(a, -1), _f8(b, -2)
    elif precision != "fp32":
        raise ValueError(f"precision {precision!r}")
    return a @ b


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [n, heads, hd], positions 0..n-1, rotation by halves."""
    n, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(n, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def causal_attention(q, k, v, precision: str, heads_per_step: int = 8):
    """q [n, H, hd], k / v [n, KVH, hd] -> [n, H, hd]; head h reads kv head
    h // (H / KVH)."""
    n, H, hd = q.shape
    group = H // k.shape[1]
    mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for h0 in range(0, H, heads_per_step):
        hs = range(h0, min(h0 + heads_per_step, H))
        qh = q[:, hs].transpose(0, 1)  # [h, n, hd]
        kh = k[:, [h // group for h in hs]].transpose(0, 1)
        vh = v[:, [h // group for h in hs]].transpose(0, 1)
        s = mm(qh, kh.transpose(1, 2), precision) / math.sqrt(hd)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[:, hs] = mm(p, vh, precision).transpose(0, 1)
    return out


def gated(x, wg, wu, wd, precision: str) -> torch.Tensor:
    g, u = mm(x, wg, precision), mm(x, wu, precision)
    return mm(torch.nn.functional.silu(g) * u, wd, precision)


def attention_block(m: dict, lp: dict, h: torch.Tensor, precision: str):
    n = h.shape[0]
    H, KVH, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    a = lp["attn"]
    x = rms_norm(h, lp["ln_attn"], m["norm_eps"])
    q = mm(x, a["wq"], precision).reshape(n, H, hd)
    k = mm(x, a["wk"], precision).reshape(n, KVH, hd)
    v = mm(x, a["wv"], precision).reshape(n, KVH, hd)
    if m["qk_norm"]:
        q = rms_norm(q, a["q_norm"], m["norm_eps"])
        k = rms_norm(k, a["k_norm"], m["norm_eps"])
    q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    o = causal_attention(q, k, v, precision).reshape(n, H * hd)
    return h + mm(o, a["wo"], precision)


def moe_block(m: dict, lp: dict, h: torch.Tensor, precision: str):
    """h [T, d] (the tokens of every prompt of the block)."""
    ffn = lp["ffn"]
    x = rms_norm(h, lp["ln_ffn"], m["norm_eps"])
    probs = torch.softmax(mm(x, ffn["router"], precision), dim=-1)
    w, idx = torch.topk(probs, m["top_k"], dim=-1)
    w = w / w.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    ex = ffn["experts"]
    for e in range(m["num_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        ye = gated(x[tok], ex["w_gate"][e], ex["w_up"][e], ex["w_down"][e],
                   precision)
        y.index_add_(0, tok, ye * w[tok, slot][:, None])
    if "shared" in ffn:
        s = ffn["shared"]
        y = y + gated(x, s["w_gate"], s["w_up"], s["w_down"], precision)
    return h + y


def _layer(stage: dict, l: int) -> dict:
    if isinstance(stage, dict):
        return {k: _layer(v, l) for k, v in stage.items()}
    return stage[l]


def final_hidden(m: dict, params: dict, prompts: Sequence[torch.Tensor],
                 precision: str = "fp32") -> List[torch.Tensor]:
    """The final-normed hidden states [n_i, d] (float32) of each prompt."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            hs = [params["embed"][t.long()].float() for t in prompts]
            sizes = [len(t) for t in prompts]
            stage = params["stages"][0]
            for l in range(m["num_layers"]):
                lp = _layer(stage, l)
                hs = [attention_block(m, lp, h, precision) for h in hs]
                hs = list(torch.split(
                    moe_block(m, lp, torch.cat(hs), precision), sizes))
            return [rms_norm(h, params["final_norm"], m["norm_eps"])
                    for h in hs]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def logits(params: dict, h: torch.Tensor, precision: str = "fp32"):
    """LM-head logits of final hidden rows h [n, d] (float32)."""
    return mm(h, params["lm_head"], precision)
