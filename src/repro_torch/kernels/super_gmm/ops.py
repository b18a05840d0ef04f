"""Model integration of the MoE Super Kernel: the gated expert FFN on
capacity buffers, the `gmm` adapter that runs `lm_forward`'s MoE layers on
it, and the capacity-buffer packing around it.

The packing functions run on the device of the tensors they are given.  The
index arithmetic (stable sort by expert, slot = expert * C + position) runs
where `eids` lies and the row scatter/gather where `tokens` lies, so a caller
that keeps the small id arrays on the host (the threaded executor hands in
numpy arrays) pays no host sync: the capacity bucket comes from host counts.
With `eids` on a CUDA device, reading `counts.max()` for the bucket is the
one host sync.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _launch
from repro_torch.kernels.super_gmm import tuning
from repro_torch.kernels.super_gmm.super_gmm import super_gmm
from repro_torch.models.common import ModelConfig, act_fn


def super_moe_ffn(layer_id: torch.Tensor, experts: dict, xb: torch.Tensor,
                  cfg: ModelConfig,
                  counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gated expert FFN on capacity buffers via three super-GMM calls.

    xb: [E, C, d] -> [E, C, d] (fp32).  `layer_id` is a [1] int32 tensor on
    xb's device and stays runtime data: it is never read on the host.
    `counts` ([E] int32 on xb's device, or None) gives the real rows per
    expert; the kernel skips the padding beyond them.

    Every call consults the active tuning table (`tuning.lookup_blocks`, a
    host dict read): on a hit the gate and up launches take its up tile and
    the down launch its down tile; an entry that is not a tile of the kernel
    raises ValueError, also on the CPU; with no entry the default tile
    runs."""
    act = act_fn(cfg.act)
    E, C, d = xb.shape
    up = down = None
    tuned = tuning.lookup_blocks(E, d, experts["w_gate"].shape[-1], xb.dtype,
                                 C)
    if tuned is not None:
        up, down = (tuning.tile_of(b, xb.dtype) for b in tuned)
    g = super_gmm(layer_id, experts["w_gate"], xb, counts, tile=up)
    u = super_gmm(layer_id, experts["w_up"], xb, counts, tile=up)
    h = act(g).mul_(u).to(xb.dtype)  # in place: one [E, C, f] fp32 less
    return super_gmm(layer_id, experts["w_down"], h, counts, tile=down)


def make_super_kernel_gmm(stacked_experts: dict, cfg: ModelConfig
                          ) -> Callable:
    """Adapter for `lm_forward(gmm=...)`: signature (xb, experts_layer, cfg,
    layer_id) -> yb.  `experts_layer` (the layer's slice of the weights) is
    not used: the kernel reads the FULL [L, E, ...] stack and resolves the
    layer from `layer_id`, a [1] int32 tensor on xb's device (one view per
    layer into a `torch.arange(L)` the caller makes once).  Dense, as the
    reference's adapter: no per-expert counts."""
    del cfg  # the layer's cfg arrives with each call

    def gmm(xb, experts_layer, cfg_inner, layer_id):
        del experts_layer
        return super_moe_ffn(layer_id, stacked_experts, xb,
                             cfg_inner).to(xb.dtype)

    return gmm


# ---------------------------------------------------------------------------
# Capacity-buffer packing
# ---------------------------------------------------------------------------


def round_capacity(n: int, minimum: int = 8) -> int:
    """Round a per-expert row count up to the next power of two (>= minimum),
    so steady-state regions reuse O(log N) distinct [n_experts, C, d] buffer
    shapes."""
    return max(minimum, 1 << max(int(n) - 1, 0).bit_length())


def pack_capacity(tokens: torch.Tensor, eids, n_experts: int,
                  capacity: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Scatter N token rows into dropless [n_experts, C, d] capacity buffers.

    One stable sort by expert plus exclusive-prefix offsets: every row lands
    at slot ``expert * C + position_within_expert``; padding rows are zero.
    C defaults to the bucketed max per-expert count so nothing is dropped.

    `eids` is an integer tensor or a host (numpy) array.  Returns (xb
    [n_experts, C, d], order, slots, C); `order`/`slots` (int64, on eids'
    device) invert the packing in `unpack_capacity`.
    """
    n, d = tokens.shape
    eids = torch.as_tensor(eids).reshape(-1).long()
    counts = torch.bincount(eids, minlength=n_experts)
    if n:
        if counts.is_cuda:
            _launch.note_host_sync()
        cmax = int(counts.max())
    else:
        cmax = 1
    C = capacity if capacity is not None else round_capacity(cmax)
    if C < cmax:
        raise ValueError(f"capacity {C} drops rows (max count {cmax})")
    sorted_e, order = torch.sort(eids, stable=True)
    offsets = torch.cumsum(counts, 0) - counts  # exclusive prefix sum
    pos = torch.arange(n, device=eids.device) - offsets[sorted_e]
    slots = sorted_e * C + pos
    xb = torch.zeros((n_experts * C, d), dtype=tokens.dtype,
                     device=tokens.device)
    xb.index_copy_(0, slots.to(tokens.device),
                   tokens.index_select(0, order.to(tokens.device)))
    return xb.view(n_experts, C, d), order, slots, C


def unpack_capacity(yb: torch.Tensor, order: torch.Tensor,
                    slots: torch.Tensor, n: int) -> torch.Tensor:
    """Gather expert outputs back to the original row order (inverse of
    `pack_capacity`). yb: [n_experts, C, d] -> [n, d]."""
    d = yb.shape[-1]
    out = torch.empty((n, d), dtype=yb.dtype, device=yb.device)
    out.index_copy_(0, order.to(yb.device),
                    yb.reshape(-1, d).index_select(0, slots.to(yb.device)))
    return out


def pack_capacity_multi(token_list: Sequence[torch.Tensor],
                        eid_list: Sequence, n_experts: int,
                        capacity: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   int, torch.Tensor]:
    """Pack SEVERAL regions' rows into ONE shared capacity buffer: regions
    are concatenated row-major and packed with one `pack_capacity` call, so
    one `super_moe_ffn` launch serves them all.  `bounds` (cumulative row
    count per region, int64 on the host) keeps row provenance for
    `unpack_capacity_multi`.

    Bit-equality with the per-region path holds because every capacity-buffer
    row is an independent dot-product chain: merging regions (or growing C)
    changes WHERE a row sits, never its reduction order.

    Returns (xb, order, slots, C, bounds).
    """
    if len(token_list) != len(eid_list) or not token_list:
        raise ValueError("pack_capacity_multi: no regions, or tokens and "
                         "expert ids of different lengths")
    bounds = torch.cumsum(torch.tensor([len(t) for t in token_list]), 0)
    tokens = token_list[0] if len(token_list) == 1 \
        else torch.cat(list(token_list), 0)
    eids = eid_list[0] if len(eid_list) == 1 \
        else torch.cat([torch.as_tensor(e).reshape(-1) for e in eid_list], 0)
    xb, order, slots, C = pack_capacity(tokens, eids, n_experts, capacity)
    return xb, order, slots, C, bounds


def unpack_capacity_multi(yb: torch.Tensor, order: torch.Tensor,
                          slots: torch.Tensor, bounds: torch.Tensor
                          ) -> List[torch.Tensor]:
    """Split merged expert outputs back into per-region row blocks (inverse
    of `pack_capacity_multi`), in the region order the packer was given."""
    # sync-ok: bounds lies on the host (pack_capacity_multi sums the
    # regions' Python lengths): reading it waits on no device
    sizes = torch.diff(bounds, prepend=bounds.new_zeros(1)).tolist()
    # sync-ok: the same host tensor
    out = unpack_capacity(yb, order, slots, int(bounds[-1]))
    return list(torch.split(out, sizes))
