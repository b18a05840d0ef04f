"""Random weights from the seed, made on the device in the port's parameter
layout (a nested dict with every layer stacked on a leading [L] axis).

The benchmark makes them itself and hands the same tensors to the program
and to the reference.  One `normal_` per stacked leaf, drawn in the type it
is served in (the routers in fp32), then scaled in place: N(0, 1/in) for the
projections, N(0, 0.02^2) for the embedding, 1 + N(0, 0.05^2) for the norm
scales, so the check sees a norm's scale applied.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _normal(gen, shape, dtype, std: float, mean: float = 0.0):
    t = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    t.normal_(0.0, 1.0, generator=gen)
    t.mul_(std)
    if mean:
        t.add_(mean)
    return t


def _dense(gen, shape, in_dim: int, dtype):
    return _normal(gen, shape, dtype, 1.0 / math.sqrt(in_dim))


def _norm(gen, shape, dtype):
    return _normal(gen, shape, dtype, 0.05, mean=1.0)


def make_params(m: dict, seed: int, device) -> dict:
    """Parameters of the model described by `m` (a configuration file's
    "model" object)."""
    dtype = DTYPES[m["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    L, d, hd = m["num_layers"], m["d_model"], m["head_dim"]
    q_dim, kv_dim = m["num_heads"] * hd, m["num_kv_heads"] * hd
    E, f, V = m["num_experts"], m["moe_d_ff"], m["vocab_size"]
    attn = {"wq": _dense(gen, (L, d, q_dim), d, dtype),
            "wk": _dense(gen, (L, d, kv_dim), d, dtype),
            "wv": _dense(gen, (L, d, kv_dim), d, dtype),
            "wo": _dense(gen, (L, q_dim, d), q_dim, dtype)}
    if m["qk_norm"]:
        attn["q_norm"] = _norm(gen, (L, hd), dtype)
        attn["k_norm"] = _norm(gen, (L, hd), dtype)
    ffn = {"router": _dense(gen, (L, d, E), d, torch.float32),
           "experts": {"w_gate": _dense(gen, (L, E, d, f), d, dtype),
                       "w_up": _dense(gen, (L, E, d, f), d, dtype),
                       "w_down": _dense(gen, (L, E, f, d), f, dtype)}}
    if m["num_shared_experts"]:
        fs = f * m["num_shared_experts"]
        ffn["shared"] = {"w_gate": _dense(gen, (L, d, fs), d, dtype),
                         "w_up": _dense(gen, (L, d, fs), d, dtype),
                         "w_down": _dense(gen, (L, fs, d), fs, dtype)}
    stage = {"ln_attn": _norm(gen, (L, d), dtype), "attn": attn,
             "ln_ffn": _norm(gen, (L, d), dtype), "ffn": ffn}
    return {"embed": _normal(gen, (V, d), dtype, 0.02),
            "stages": [stage],
            "final_norm": _norm(gen, (d,), dtype),
            "lm_head": _dense(gen, (d, V), d, dtype)}
