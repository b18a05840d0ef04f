"""Int8 gradient compression with error feedback (the reference's
`repro.optim.compress`), as tensor functions.

Per-tensor symmetric int8 quantization plus an error-feedback residual that
carries each step's quantization error into the next.  The reference uses
it inside a data-parallel all-reduce (`compressed_psum`); that collective
waits for the port's multi-device slice, so here are the pieces it is built
from.
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


def init_residuals(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
