"""MoE Super Kernel -- layer-oblivious grouped (batched-expert) matmul.

    out[e, c, n] = sum_k x[e, c, k] * w[layer_id[0], e, k, n]   (fp32 out)

`super_gmm` is the wrapper of the CUDA kernel in `csrc/super_gmm.cu`; it
replaces the TPU kernel `repro.kernels.super_gmm.super_gmm.super_gmm`.  The
kernel binds the FULL `[L, E, K, N]` weight stack, does the (layer, expert,
tile) address arithmetic itself, and reads the layer from the one-element
int32 DEVICE tensor `layer_id` -- the wrapper never reads that tensor, so one
launch signature serves every layer and no launch costs a host round trip.

`counts` (optional, [E] int32 on x's device) says how many leading rows of
each expert's capacity buffer are real; the rows beyond are padding and come
out as zeros.  The kernel skips tiles that are all padding, so its work
follows the rows that exist -- and, like the layer id, the counts are read on
the device only.

`super_gmm_ref` is the plain PyTorch version of the same function.  The
wrapper takes it only for tensors that lie on the CPU; for CUDA tensors it
launches the kernel or raises.

`route` picks one of three kernels by shape and the launch function runs
it: "wgmma" (bf16 that TMA can describe: the main path), "wmma" (other
bf16) and "fma" (fp32).  `super_gmm.launches` counts every launch and
`super_gmm.launches_by_route` splits them by route.

The wgmma kernel is instantiated at every (BM, BN) of `TILES` (BK fixed at
64); `tile` picks one per launch, `DEFAULT_TILE` when it is None.  No tile
changes any output element's K reduction order, so every tile gives the
same bits.  `super_gmm.launches_by_tile` counts the wgmma launches by tile
("128x256", ...).  A tuning table (`tuning.py`) chooses the tile per
capacity bucket through `ops.super_moe_ffn`.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build, _launch

# The most experts the wgmma kernel's shared-memory prefix sums hold.
MAX_EXPERTS = 1024
# The wgmma kernel's (BM, BN) instantiations, in the order of the `tile`
# index super_gmm_launch takes (csrc/super_gmm.cu: `if (tile == i) return
# wg::launch<BM, BN>`); the first is the default.  BK is 64 for all.
TILES = ((128, 256), (128, 128), (64, 256), (64, 128))
DEFAULT_TILE = TILES[0]
BK = 64


def tile_name(tile) -> str:
    return f"{tile[0]}x{tile[1]}"


def route(dtype: torch.dtype, E: int, K: int, N: int, ptrs: Sequence[int],
          w_strides: Sequence[int]) -> str:
    """The kernel `super_gmm_launch` runs, by shape: fp32 -> "fma"; bf16
    with K (> 0) and N multiples of 8, the bases of w and x (`ptrs`) 16-byte
    aligned, the weight stack's layer and expert strides (elements)
    multiples of 8 -- all as TMA needs -- and at most MAX_EXPERTS experts
    -> "wgmma"; any other bf16 -> "wmma"."""
    if dtype == torch.float32:
        return "fma"
    tma = (K > 0 and K % 8 == 0 and N % 8 == 0
           and all(p % 16 == 0 for p in ptrs)
           and all(s % 8 == 0 for s in w_strides) and E <= MAX_EXPERTS)
    return "wgmma" if tma else "wmma"


def super_gmm_ref(layer_id: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                  counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[e, c, n] = x[e, c, :] @ w[layer_id, e, :, :] (fp32 accumulate);
    rows c >= counts[e] are padding and give zeros."""
    wl = w.index_select(0, layer_id.reshape(1).long())[0]
    x = x.float()
    if counts is not None:
        real = torch.arange(x.shape[1], device=x.device)[None, :] \
            < counts[:, None]
        x = x * real[:, :, None]
    return torch.einsum("eck,ekn->ecn", x, wl.float())


def super_gmm(layer_id: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
              counts: Optional[torch.Tensor] = None,
              tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """layer_id: [1] int32 on x's device; w: [L, E, K, N]; x: [E, C, K];
    counts: None or [E] int32 on x's device; tile: None (the default) or a
    (BM, BN) of `TILES`, for the wgmma route only; returns [E, C, N]
    float32.  On a CPU tensor the plain version runs and the tile (checked
    against `TILES`) changes nothing."""
    if tile is not None:
        tile = tuple(tile)
        if tile not in TILES:
            raise ValueError(f"super_gmm: tile {tile} is not one of the "
                             f"instantiated (BM, BN) {TILES}")
    L, E, K, N = w.shape
    Ex, C, Kx = x.shape
    if (Ex, Kx) != (E, K):
        raise ValueError(f"super_gmm: x {tuple(x.shape)} does not match "
                         f"w {tuple(w.shape)}")
    if counts is not None and (counts.shape != (E,)
                               or counts.dtype != torch.int32
                               or counts.device != x.device):
        raise ValueError(f"super_gmm: counts must be [{E}] int32 on "
                         f"{x.device}")
    if x.device.type == "cpu":
        return super_gmm_ref(layer_id, w, x, counts)
    if not (x.is_cuda and w.device == x.device
            and layer_id.device == x.device):
        raise ValueError("super_gmm: layer_id, w and x must lie on one CUDA "
                         "device")
    if layer_id.dtype != torch.int32 or layer_id.numel() != 1:
        raise ValueError("super_gmm: layer_id must be a [1] int32 tensor")
    if x.dtype != w.dtype or x.dtype not in _launch.DTYPES:
        raise ValueError(f"super_gmm: x {x.dtype} / w {w.dtype} must both be "
                         f"float32 or bfloat16")
    if w.stride(3) != 1 or w.stride(2) != N:
        raise ValueError("super_gmm: each [K, N] weight matrix must be "
                         "contiguous")
    x = x.contiguous()
    out = torch.empty((E, C, N), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out  # no expert or no row: nothing to launch
    lib = _build.load()
    r = route(x.dtype, E, K, N, (w.data_ptr(), x.data_ptr()),
              (w.stride(0), w.stride(1)))
    if tile is not None and r != "wgmma":
        # a tuned run that silently ran another kernel would invalidate the
        # measurement
        raise ValueError(f"super_gmm: tile {tile} given, but these tensors "
                         f"take the {r!r} route; tiles are the wgmma "
                         f"route's")
    if r == "wgmma" and tile is None:
        tile = DEFAULT_TILE
    code = lib.super_gmm_launch(
        layer_id.data_ptr(),
        counts.data_ptr() if counts is not None else None,
        w.data_ptr(), x.data_ptr(), out.data_ptr(), _launch.ROUTES.index(r),
        TILES.index(tile) if tile is not None else 0,
        L, E, C, K, N, w.stride(0), w.stride(1), _launch.stream_ptr(x.device))
    _launch.check(code, "super_gmm")
    _launch.count_launch(super_gmm, r,
                         tile_name(tile) if tile is not None else None)
    return out


super_gmm.launches = 0
super_gmm.launches_by_route = dict.fromkeys(_launch.ROUTES, 0)
super_gmm.launches_by_tile = dict.fromkeys(map(tile_name, TILES), 0)
