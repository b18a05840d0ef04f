"""Parameter bridge between the JAX reference and the port.

The caller converts the reference's parameter pytree to numpy
(`jax.tree.map(np.asarray, params)`; bf16 leaves as float32, numpy has no
bf16) and hands it to `params_from_numpy`, which builds the port's nested
dict of tensors with the same keys and the same stacked `[L, ...]` layer
axis.  This module never imports jax.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.common import ModelConfig

_FP32_LEAVES = ("router",)  # the router stays fp32 whatever cfg.dtype says


def params_from_numpy(tree: Any, cfg: ModelConfig, device="cuda",
                      _key: str = "") -> Any:
    """numpy pytree (dicts / lists / arrays / None) -> tensors on `device`.
    Float leaves take `cfg.dtype` (the router float32), integer leaves keep
    their type."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, cfg, device, k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, cfg, device, _key) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr, dtype=np.float32))  # a copy
        dtype = torch.float32 if _key in _FP32_LEAVES else cfg.dtype
        return t.to(device=device, dtype=dtype)
    return torch.from_numpy(np.array(arr)).to(device)


def params_to_numpy(tree: Any) -> Any:
    """The inverse: tensors -> numpy arrays (bf16 leaves as float32)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
