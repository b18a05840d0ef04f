"""Plain PyTorch oracle of the gated expert FFN over layer-indexed weights."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.super_gmm.super_gmm import super_gmm_ref

__all__ = ["super_gmm_ref", "super_moe_ffn_ref"]


def super_moe_ffn_ref(layer_id: torch.Tensor, experts: dict,
                      xb: torch.Tensor, act,
                      counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full gated expert FFN through the layer-indexed weights."""
    g = super_gmm_ref(layer_id, experts["w_gate"], xb, counts)
    u = super_gmm_ref(layer_id, experts["w_up"], xb, counts)
    h = (act(g) * u).to(xb.dtype)
    return super_gmm_ref(layer_id, experts["w_down"], h, counts)
