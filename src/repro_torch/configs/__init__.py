"""Architecture registry.

`get_config(arch_id)` returns the full-size ModelConfig; `.smoke()` gives the
reduced same-family config for CPU tests.  The port carries the MoE
architectures the executor serves; the other families arrive with their
model code.
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCHS = [
    "qwen3_moe_235b_a22b",
    "dbrx_132b",
]

EXTRA_ARCHS = ["deepseek_v32"]  # the paper's own model

_ALIASES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "dbrx-132b": "dbrx_132b",
    "deepseek-v3.2": "deepseek_v32",
}


def get_config(arch: str) -> ModelConfig:
    mod_name = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    if mod_name not in ARCHS + EXTRA_ARCHS:
        raise ValueError(f"unknown architecture {arch!r}; the port has "
                         f"{ARCHS + EXTRA_ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG
