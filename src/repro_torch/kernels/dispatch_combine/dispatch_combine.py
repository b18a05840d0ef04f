"""Token dispatch/combine -- the capacity-mode MoE layer's payload movement.

Two wrappers of the CUDA kernels in `csrc/dispatch_combine.cu`, each with
two routes, counted in `launches_by_route`:

    dispatch_scatter   "scatter": out[slot[i]] = x[token_of[i]] (out starts
                       as zeros) -- the TPU kernel's signature
                       "whole":   the whole dispatch of `moe_dispatch` from the
                       router's ids (`dispatch_whole`), one launch
    combine_gather     "gather":  out[i] = yb[slot[i]] -- the TPU kernel's
                       signature
                       "weighted": out[t] = sum_k w[t, k] yb[pair_slot[t*K+k]]
                       (`combine_weighted`), one launch

`combine_weighted_bwd` is the gradient of the "weighted" route, its own
CUDA kernel in the same `.cu` (one launch writes dyb, zeros and all, and
dw), counted in `combine_weighted_bwd.launches`; the dispatch's gradient
needs no kernel of its own: it is the "weighted" route with unit weights
(`ops.py`).  The TPU kernels have no backward.

The "scatter" and "gather" routes replace the TPU kernels of the same names
in `repro.kernels.dispatch_combine.dispatch_combine`, with the same
signatures; the decode MoE layer runs the "whole" and "weighted" routes
(`ops.py`).  `launches` counts wrapper calls that launched their kernels,
one per call on every route.  The index vectors are device data read by the
kernels; the wrappers never read them back.  Row `rows_out - 1` of the
scatter's output is the trash row that dropped pairs point at: it stays
zero.

On a CPU tensor each wrapper takes its plain version (`ref.py`); on a CUDA
tensor it launches its kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.dispatch_combine.ref import (combine_gather_ref,
                                                      combine_weighted_bwd_ref,
                                                      combine_weighted_ref,
                                                      dispatch_scatter_ref,
                                                      dispatch_whole_ref)

_ELEM_SIZE = {torch.float32: 4, torch.bfloat16: 2}

# The most experts the "whole" route takes: its rank block keeps E + 1
# buckets in 48 KB of shared memory (WHOLE_MAX_EXPERTS in
# csrc/dispatch_combine.cu, which refuses more).
WHOLE_MAX_EXPERTS = 1116


def _check_index(name: str, idx: torch.Tensor, n: int, device):
    if idx.dtype != torch.int32 or idx.shape != (n,) \
            or idx.device != device:
        raise ValueError(f"{name} must be a [{n}] int32 tensor on {device}")


def _check_payload(name: str, t: torch.Tensor):
    if not t.is_cuda or t.dtype not in _ELEM_SIZE:
        raise ValueError(f"{name} must be a float32 or bfloat16 CUDA tensor, "
                         f"got {t.dtype} on {t.device}")


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
    _check_payload("dispatch_scatter: x", x)
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
    _launch.count_launch(dispatch_scatter, "scatter")
    return out


def _whole_args(x: torch.Tensor, idx: torch.Tensor):
    """x and idx as `dispatch_whole_launch` takes them: x a float32 or
    bfloat16 CUDA tensor with unit column stride, idx contiguous int32."""
    _check_payload("dispatch_whole: x", x)
    if x.stride(1) != 1:
        x = x.contiguous()
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        idx = idx.to(torch.int32).contiguous()
    return x, idx


def dispatch_whole(x: torch.Tensor, idx: torch.Tensor, num_experts: int,
                   capacity: int):
    """The "whole" route of `dispatch_scatter`: x [T, d]; idx [T, K] int32
    expert ids -> (xb [E*C, d] x's type, perm, slot, valid, group_sizes,
    pair_slot) -- `moe_dispatch`'s outputs bit for bit (perm, slot: [T*K]
    int64 in sorted pair order; valid [T*K] bool; group_sizes [E] int64),
    and pair_slot [T*K] int64, each pair's capacity row in pair order (E*C
    when dropped).  x may have any row stride."""
    if x.dim() != 2 or idx.dim() != 2 or idx.shape[0] != x.shape[0]:
        raise ValueError(f"dispatch_whole: x [T, d] and idx [T, K] expected, "
                         f"got {tuple(x.shape)} and {tuple(idx.shape)}")
    if idx.device != x.device:
        raise ValueError("dispatch_whole: x and idx on different devices")
    if x.device.type == "cpu":
        return dispatch_whole_ref(x, idx, num_experts, capacity)
    x, idx = _whole_args(x, idx)
    (T, d), K = x.shape, idx.shape[1]
    E, C, N = num_experts, capacity, T * K
    xb = torch.empty((E * C, d), dtype=x.dtype, device=x.device)
    meta = torch.empty(3 * N + E, dtype=torch.long, device=x.device)
    valid = torch.empty(N, dtype=torch.bool, device=x.device)
    code = _build.load().dispatch_whole_launch(
        idx.data_ptr(), x.data_ptr(), xb.data_ptr(), meta.data_ptr(),
        valid.data_ptr(), N, K, E, C, d, x.stride(0), _ELEM_SIZE[x.dtype],
        _launch.stream_ptr(x.device))
    _launch.check(code, "dispatch_scatter (whole)")
    _launch.count_launch(dispatch_scatter, "whole")
    perm, slot, pair_slot, group_sizes = meta.split((N, N, N, E))
    return xb, perm, slot, valid, group_sizes, pair_slot


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
    _check_payload("combine_gather: yb", yb)
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
    _launch.count_launch(combine_gather, "gather")
    return out


def combine_weighted(yb: torch.Tensor, pair_slot: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """The "weighted" route of `combine_gather`: yb [R, d]; pair_slot [T*K]
    int64 (a row outside yb adds nothing); weights [T, K] -> out [T, d],
    yb's type: sum over k = 0..K-1 in fp32 of the weight rounded to yb's
    type times the row, rounded once."""
    if yb.dim() != 2 or weights.dim() != 2:
        raise ValueError(f"combine_weighted: yb [R, d] and weights [T, K] "
                         f"expected, got {tuple(yb.shape)} and "
                         f"{tuple(weights.shape)}")
    T, K = weights.shape
    if pair_slot.dtype != torch.long or pair_slot.shape != (T * K,) \
            or pair_slot.device != yb.device or weights.device != yb.device:
        raise ValueError(f"combine_weighted: pair_slot must be a [{T * K}] "
                         f"int64 tensor and weights on {yb.device}")
    if yb.device.type == "cpu":
        return combine_weighted_ref(yb, pair_slot, weights)
    _check_payload("combine_weighted: yb", yb)
    yb, pair_slot = yb.contiguous(), pair_slot.contiguous()
    weights = weights.float().contiguous()
    R, d = yb.shape
    out = torch.empty((T, d), dtype=yb.dtype, device=yb.device)
    code = _build.load().combine_weighted_launch(
        pair_slot.data_ptr(), weights.data_ptr(), yb.data_ptr(),
        out.data_ptr(), T, K, R, d, _ELEM_SIZE[yb.dtype],
        _launch.stream_ptr(yb.device))
    _launch.check(code, "combine_gather (weighted)")
    _launch.count_launch(combine_gather, "weighted")
    return out


def combine_weighted_bwd(dout: torch.Tensor, yb: torch.Tensor,
                         pair_slot: torch.Tensor, weights: torch.Tensor):
    """The gradient of `combine_weighted`: dout [T, d] (yb's type), yb [R,
    d], pair_slot [T*K] int64, weights [T, K] -> (dyb [R, d] yb's type, dw
    [T, K] fp32).  dyb[pair_slot[t*K+k]] = w[t, k] dout[t] with w rounded
    to yb's type as the forward rounds it (each row is hit by at most one
    pair; rows no pair hits are zero); dw[t, k] = <yb[slot], dout[t]>
    summed in fp32 in a fixed order (0 for a dropped pair)."""
    if yb.dim() != 2 or weights.dim() != 2 or dout.dim() != 2:
        raise ValueError(f"combine_weighted_bwd: dout [T, d], yb [R, d] and "
                         f"weights [T, K] expected, got {tuple(dout.shape)}, "
                         f"{tuple(yb.shape)} and {tuple(weights.shape)}")
    T, K = weights.shape
    R, d = yb.shape
    if dout.shape != (T, d) or dout.dtype != yb.dtype \
            or pair_slot.dtype != torch.long or pair_slot.shape != (T * K,) \
            or not (pair_slot.device == dout.device == weights.device
                    == yb.device):
        raise ValueError(f"combine_weighted_bwd: dout must be [{T}, {d}] "
                         f"{yb.dtype}, pair_slot a [{T * K}] int64 tensor, "
                         f"all on {yb.device}")
    if yb.device.type == "cpu":
        return combine_weighted_bwd_ref(dout, yb, pair_slot, weights)
    _check_payload("combine_weighted_bwd: yb", yb)
    yb, dout, pair_slot = (t.contiguous() for t in (yb, dout, pair_slot))
    weights = weights.float().contiguous()
    dyb = torch.empty_like(yb)
    dw = torch.empty((T, K), dtype=torch.float32, device=yb.device)
    code = _build.load().combine_weighted_bwd_launch(
        pair_slot.data_ptr(), weights.data_ptr(), yb.data_ptr(),
        dout.data_ptr(), dyb.data_ptr(), dw.data_ptr(), T, K, R, d,
        _ELEM_SIZE[yb.dtype], _launch.stream_ptr(yb.device))
    _launch.check(code, "combine_weighted_bwd")
    _launch.count_launch(combine_weighted_bwd)
    return dyb, dw


dispatch_scatter.launches = 0
dispatch_scatter.launches_by_route = {"scatter": 0, "whole": 0}
combine_gather.launches = 0
combine_gather.launches_by_route = {"gather": 0, "weighted": 0}
combine_weighted_bwd.launches = 0
