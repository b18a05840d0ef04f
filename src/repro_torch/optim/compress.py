"""Int8 gradient compression with error feedback (the reference's
`repro.optim.compress`), as tensor functions.

Per-tensor symmetric int8 quantization plus an error-feedback residual that
carries each step's quantization error into the next.  `compressed_psum`
is the data-parallel all-reduce of the compressed gradients
(`launch.steps.build_compressed_dp_step`).  As in the reference, the sum
runs over the dequantized fp32 values: the int8 codes and their scale are
the wire format it models, not the one it sends.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q int8, scale fp32 scalar)."""
    x32 = x.float()
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(grad: torch.Tensor, residual: torch.Tensor):
    """Error feedback: quantize (grad + residual), carry the quantization
    error.  Returns (q, scale, new_residual)."""
    g = grad.float() + residual
    q, scale = quantize_int8(g)
    return q, scale, g - dequantize_int8(q, scale)


def compressed_psum(grad: torch.Tensor, residual: torch.Tensor, group):
    """All-reduce the int8-compressed `grad` over the process group `group`:
    quantize grad + residual, sum the dequantized values over the group,
    divide by its size.  Returns (mean_grad fp32, new_residual)."""
    import torch.distributed as dist
    q, scale, new_residual = compress_with_feedback(grad, residual)
    total = dequantize_int8(q, scale)
    dist.all_reduce(total, group=group)
    return total / float(dist.get_world_size(group)), new_residual


def init_residuals(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
