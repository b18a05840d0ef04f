"""Modality frontend stubs: the `[audio]` / `[vlm]` architectures specify the
transformer backbone only, and their inputs are precomputed frame or patch
embeddings.

Contract: a frontend maps raw modality input -> [B, S, d_model] embeddings.
Here: (a) the shape contract and (b) a synthetic embedding generator, so
end-to-end runs are possible without audio or vision towers.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig


def frontend_embedding_shape(cfg: ModelConfig, batch: int, seq: int):
    """Audio: seq == number of (already downsampled) frames. Vision: seq ==
    number of patch tokens (early-fusion VQ tokens are in-vocab for chameleon,
    so its frontend is only used when bypassing the VQ tokenizer)."""
    return (batch, seq, cfg.d_model)


def synthetic_embeddings(gen: torch.Generator, cfg: ModelConfig, batch: int,
                         seq: int) -> torch.Tensor:
    """Normal(0, 0.02) embeddings in the model's dtype, drawn from `gen` on
    its device."""
    shape = frontend_embedding_shape(cfg, batch, seq)
    return (torch.randn(shape, generator=gen, device=gen.device)
            * 0.02).to(cfg.dtype)
