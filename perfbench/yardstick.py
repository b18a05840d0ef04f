"""The benchmark's yardstick: the chip's peaks, the kernels' names, and the
operations and bytes each piece of work needs.

Frozen: a later change to the program is measured against these numbers,
so they never read the program.  Everything here is a function of a model
description (a configuration file's "model" object) and of shapes or counts
the run recorded.  A change of any formula is a change of the benchmark.
"""
from __future__ import annotations

import re
from typing import Iterable, Sequence

# One NVIDIA H100 SXM (data sheet, dense rates, at its 700 W limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}
DEFAULT_PEAK = PEAKS["NVIDIA H100 80GB HBM3"]

# The port's kernels by the names the profiler gives their launches.
SUPER_GMM = re.compile(r"super_gmm_\w*kernel")
FLASH = re.compile(r"flash_\w*kernel")
# The port's other hand-written kernels (not on these cells' path).
PORT_OTHER = re.compile(r"(dispatch_|combine_)\w*kernel")
# cuBLAS / CUTLASS matrix products (the projections, the router, the head).
CUBLAS = re.compile(r"(nvjet|gemm|cutlass|xmma|sm90_|sm80_|cublas)", re.I)


def peak(device_name: str) -> dict:
    return PEAKS.get(device_name, DEFAULT_PEAK)


def kernel_class(name: str) -> str:
    """'super_gmm', 'flash', 'port', 'cublas' or 'glue' for a device
    operation's name.  Copies (Memcpy / Memset) are glue: the model's code
    around the kernels makes them."""
    if SUPER_GMM.search(name):
        return "super_gmm"
    if FLASH.search(name):
        return "flash"
    if PORT_OTHER.search(name):
        return "port"
    if CUBLAS.search(name):
        return "cublas"
    return "glue"


def _bf16(n: float) -> float:
    return 2.0 * n


def _fp32(n: float) -> float:
    return 4.0 * n


def min_time_s(flops: float, nbytes: float, pk: dict) -> float:
    """The least time the chip needs: the larger of the compute bound and
    the memory bound."""
    return max(flops / pk["bf16_flops"], nbytes / pk["hbm_bytes_s"])


# ---------------------------------------------------------------------------
# The Super Kernel: one launch of each of the three projections
# ---------------------------------------------------------------------------


def super_gmm_launch_work(counts: Sequence[int], d: int, f: int):
    """[(flops, bytes)] of the three projections (gate, up, down) of one
    `super_moe_ffn` call, over the rows actually routed (`counts`: rows per
    held expert), not the capacity padding.  Only experts that received
    rows read their weights.  Each launch reads its input rows once and
    writes its output rows once: gate and up read bf16 x [n, d] and write
    fp32 [n, f]; down reads bf16 h [n, f] and writes fp32 [n, d]."""
    n = float(sum(int(c) for c in counts))
    used = sum(1 for c in counts if int(c) > 0)
    w = _bf16(used * d * f)
    up = (2.0 * n * d * f, _bf16(n * d) + w + _fp32(n * f))
    down = (2.0 * n * f * d, _bf16(n * f) + w + _fp32(n * d))
    return [up, up, down]


def super_gmm_min_time_s(launch_counts: Iterable[Sequence[int]], d: int,
                         f: int, pk: dict) -> float:
    return sum(min_time_s(fl, by, pk)
               for counts in launch_counts
               for fl, by in super_gmm_launch_work(counts, d, f))


# ---------------------------------------------------------------------------
# Causal flash attention
# ---------------------------------------------------------------------------


def causal_pairs(length: int) -> float:
    """Visible (query, key) pairs of one causal sequence."""
    return length * (length + 1) / 2.0


def flash_work(lengths: Sequence[int], heads: int, kv_heads: int,
               head_dim: int):
    """(flops, bytes) of causal attention over valid lengths: Q.K^T and P.V
    over the visible pairs; q, k, v read once and o written once (bf16)."""
    pairs = sum(causal_pairs(n) for n in lengths)
    tokens = float(sum(lengths))
    flops = 4.0 * pairs * heads * head_dim
    nbytes = _bf16(tokens * head_dim * (2 * heads + 2 * kv_heads))
    return flops, nbytes


def flash_min_time_s(batches: Iterable[Sequence[int]], heads: int,
                     kv_heads: int, head_dim: int, pk: dict) -> float:
    """One launch per batch-layer (the lengths of the batch's rows)."""
    return sum(min_time_s(*flash_work(b, heads, kv_heads, head_dim), pk)
               for b in batches)


# ---------------------------------------------------------------------------
# The whole model: FLOPs of a prompt
# ---------------------------------------------------------------------------


def layer_flops_per_token(m: dict) -> float:
    """Matrix FLOPs of one token in one layer, attention's S^2 term aside:
    q, k, v and o projections, the router, the top-k routed experts and
    the shared experts (three products each)."""
    d, hd = m["d_model"], m["head_dim"]
    q_dim, kv_dim = m["num_heads"] * hd, m["num_kv_heads"] * hd
    f = m["moe_d_ff"]
    proj = 2.0 * d * (q_dim + 2 * kv_dim) + 2.0 * q_dim * d
    router = 2.0 * d * m["num_experts"]
    experts = (m["top_k"] + m.get("num_shared_experts", 0)) * 3 * 2.0 * d * f
    return proj + router + experts


def prompt_flops(m: dict, length: int) -> float:
    """Model FLOPs of one prompt's prefill: every layer over every token,
    causal attention over the visible pairs, and the LM head for the one
    position whose first token is sampled."""
    L = m["num_layers"]
    attn = 4.0 * causal_pairs(length) * m["num_heads"] * m["head_dim"]
    head = 2.0 * m["d_model"] * m["vocab_size"]
    return L * (length * layer_flops_per_token(m) + attn) + head


def mfu_pct(m: dict, lengths: Sequence[int], window_s: float,
            pk: dict) -> float:
    """Share of the bf16 peak that the prompts completed in the window did
    as model FLOPs."""
    total = sum(prompt_flops(m, n) for n in lengths)
    return 100.0 * total / (window_s * pk["bf16_flops"])
