"""Small CPU stand-ins for the benchmark's cells: the cells' own mixes and
limits at a small model and short prompts, for the CPU tests."""
from __future__ import annotations

import dataclasses
import time

from perfbench import cell, manifest

SMALL = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
         "head_dim": 16, "vocab_size": 256, "num_experts": 8, "top_k": 2,
         "moe_d_ff": 32, "rope_theta": 10000.0, "norm_eps": 1e-6,
         "router_renorm": True, "act": "silu", "tie_embeddings": False,
         "dtype": "float32"}
MIX = {"lengths": {"kind": "fixed", "tokens": 32}, "batch_cap": 64,
       "clients": 6, "warmup_jobs": 3, "check_requests": 4,
       "rate_rps": 20.0, "lead_s": 0.3, "late_after_s": 30}


def small_model(plan) -> dict:
    m = dict(plan.config["model"])
    m.update(SMALL)
    return m


def small_plan(workload: str, **mix) -> manifest.Plan:
    plan = manifest.plan(workload)
    return dataclasses.replace(plan, traffic={**plan.traffic, **MIX, **mix})


def run(workload: str, seed: int = 7, seconds: float = 1.5,
        trace: bool = False, **mix):
    plan = small_plan(workload, **mix)
    return cell.execute(plan, seed, seconds, trace, "cpu", time.monotonic(),
                        model=small_model(plan), exact=False)
