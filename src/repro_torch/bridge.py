"""Parameter bridge between the JAX reference and the port.

The caller converts the reference's parameter pytree to numpy
(`jax.tree.map(np.asarray, params)`; bf16 leaves as float32, numpy has no
bf16) and hands it to `params_from_numpy`, which builds the port's nested
dict of tensors with the same keys and the same stacked `[L, ...]` layer
axis.  `opt_state_from_numpy` / `opt_state_to_numpy` carry the AdamW state
(step, m, v) both ways.  This module never imports jax.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import OptState
from repro_torch.tree import tree_map

# leaves the reference keeps fp32 whatever cfg.dtype says, by (parent key,
# key): the router, rwkv's decay base and bonus, mamba's A_log, dt_bias and
# D ("u" and "D" alone could name other leaves)
_FP32_LEAVES = {("*", "router"), ("time_mix", "w_base"), ("time_mix", "u"),
                ("mamba", "A_log"), ("mamba", "dt_bias"), ("mamba", "D")}


def _fp32_leaf(parent: str, key: str) -> bool:
    return ("*", key) in _FP32_LEAVES or (parent, key) in _FP32_LEAVES


def params_from_numpy(tree: Any, cfg: ModelConfig, device="cuda",
                      _key: str = "", _parent: str = "") -> Any:
    """numpy pytree (dicts / lists / arrays / None) -> tensors on `device`.
    Float leaves take `cfg.dtype` (those of `_FP32_LEAVES` float32), integer
    leaves keep their type."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, cfg, device, k, _key)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, cfg, device, _key, _parent)
                for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr, dtype=np.float32))  # a copy
        dtype = torch.float32 if _fp32_leaf(_parent, _key) else cfg.dtype
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


def opt_state_from_numpy(state: Any, device="cuda"):
    """The reference's AdamW state as numpy, (step, m, v) (its `OptState`
    mapped through `np.asarray`), -> the port's `OptState` on `device`:
    step an int32 scalar, the moments fp32 trees."""
    step, m, v = state

    def fp32(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return OptState(torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                 device=device),
                    tree_map(fp32, m), tree_map(fp32, v))


def opt_state_to_numpy(state) -> tuple:
    """The inverse: the port's `OptState` -> numpy (step, m, v)."""
    return (np.asarray(state.step.detach().cpu().numpy(), dtype=np.int32),
            params_to_numpy(state.m), params_to_numpy(state.v))
