"""Plain PyTorch versions of the dispatch/combine kernels.

The same functions as `csrc/dispatch_combine.cu`, in torch ops that never
read an index back to the host.  The trash row `rows_out - 1` of
`dispatch_scatter_ref` stays zero, as in the kernel (the reference's scatter
writes the dropped pairs there and its callers ignore the row)."""
from __future__ import annotations

import torch


def dispatch_scatter_ref(token_of: torch.Tensor, slot: torch.Tensor,
                         x: torch.Tensor, rows_out: int) -> torch.Tensor:
    """out[slot[i]] = x[token_of[i]]; out: [rows_out, d], zeros elsewhere.
    Pairs aimed at the trash row or outside the table are dropped."""
    trash = rows_out - 1
    keep = (slot >= 0) & (slot < trash) & (token_of >= 0) \
        & (token_of < x.shape[0])
    dst = torch.where(keep, slot.long(), trash)
    src = x.index_select(0, torch.where(keep, token_of.long(), 0))
    out = torch.zeros((rows_out, x.shape[1]), dtype=x.dtype, device=x.device)
    out.index_copy_(0, dst, src)  # valid slots are unique
    out[trash] = 0  # whichever dropped pair landed there last
    return out


def combine_gather_ref(slot: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """out[i] = yb[slot[i]]; a slot outside yb gives a zero row."""
    R = yb.shape[0]
    ok = (slot >= 0) & (slot < R)
    rows = yb.index_select(0, torch.where(ok, slot.long(), 0))
    return torch.where(ok[:, None], rows, torch.zeros_like(rows))
