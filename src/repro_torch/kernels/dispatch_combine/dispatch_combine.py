"""Token dispatch/combine -- the capacity-mode MoE layer's payload movement.

    dispatch_scatter:  out[slot[i]] = x[token_of[i]]   (out starts as zeros)
    combine_gather:    out[i]       = yb[slot[i]]

`dispatch_scatter` and `combine_gather` are the wrappers of the CUDA kernels
in `csrc/dispatch_combine.cu`; they replace the TPU kernels of the same names
in `repro.kernels.dispatch_combine.dispatch_combine`, with the same
signatures.  The index vectors are device data read by the kernel; the
wrappers never read them back.  Row `rows_out - 1` of the scatter's output is
the trash row that dropped pairs point at: it stays zero.

On a CPU tensor each wrapper takes its plain version (`ref.py`); on a CUDA
tensor it launches its kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.dispatch_combine.ref import (combine_gather_ref,
                                                      dispatch_scatter_ref)

_ELEM_SIZE = {torch.float32: 4, torch.bfloat16: 2}


def _check_index(name: str, idx: torch.Tensor, n: int, device):
    if idx.dtype != torch.int32 or idx.shape != (n,) \
            or idx.device != device:
        raise ValueError(f"{name} must be a [{n}] int32 tensor on {device}")


def dispatch_scatter(token_of: torch.Tensor, slot: torch.Tensor,
                     x: torch.Tensor, *, rows_out: int) -> torch.Tensor:
    """token_of, slot: [N] int32; x: [T, d] -> out [rows_out, d], x's type."""
    if x.dim() != 2:
        raise ValueError(f"dispatch_scatter: x must be [T, d], got "
                         f"{tuple(x.shape)}")
    N = token_of.shape[0]
    _check_index("dispatch_scatter: token_of", token_of, N, x.device)
    _check_index("dispatch_scatter: slot", slot, N, x.device)
    if rows_out < 1:
        raise ValueError("dispatch_scatter: rows_out must be >= 1")
    if x.device.type == "cpu":
        return dispatch_scatter_ref(token_of, slot, x, rows_out)
    if not x.is_cuda or x.dtype not in _ELEM_SIZE:
        raise ValueError(f"dispatch_scatter: x must be a float32 or bfloat16 "
                         f"CUDA tensor, got {x.dtype} on {x.device}")
    x, token_of, slot = x.contiguous(), token_of.contiguous(), \
        slot.contiguous()
    T, d = x.shape
    out = torch.zeros((rows_out, d), dtype=x.dtype, device=x.device)
    if N == 0 or d == 0:
        return out  # nothing to copy: no launch
    lib = _build.load()
    code = lib.dispatch_scatter_launch(
        token_of.data_ptr(), slot.data_ptr(), x.data_ptr(), out.data_ptr(),
        N, d, _ELEM_SIZE[x.dtype], T, rows_out, _launch.stream_ptr(x.device))
    _launch.check(code, "dispatch_scatter")
    _launch.count_launch(dispatch_scatter)
    return out


def combine_gather(slot: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """slot: [N] int32; yb: [R, d] (row R-1 zeros, the drop target) ->
    out [N, d], yb's type."""
    if yb.dim() != 2:
        raise ValueError(f"combine_gather: yb must be [R, d], got "
                         f"{tuple(yb.shape)}")
    N = slot.shape[0]
    _check_index("combine_gather: slot", slot, N, yb.device)
    if yb.device.type == "cpu":
        return combine_gather_ref(slot, yb)
    if not yb.is_cuda or yb.dtype not in _ELEM_SIZE:
        raise ValueError(f"combine_gather: yb must be a float32 or bfloat16 "
                         f"CUDA tensor, got {yb.dtype} on {yb.device}")
    yb, slot = yb.contiguous(), slot.contiguous()
    R, d = yb.shape
    out = torch.empty((N, d), dtype=yb.dtype, device=yb.device)
    if N == 0 or d == 0:
        return out
    lib = _build.load()
    code = lib.combine_gather_launch(
        slot.data_ptr(), yb.data_ptr(), out.data_ptr(), N, d,
        _ELEM_SIZE[yb.dtype], R, _launch.stream_ptr(yb.device))
    _launch.check(code, "combine_gather")
    _launch.count_launch(combine_gather)
    return out


dispatch_scatter.launches = 0
combine_gather.launches = 0
