"""Architecture registry.

`get_config(arch_id)` returns the full-size ModelConfig; `.smoke()` gives the
reduced same-family config for CPU tests.  The port carries every
architecture of the reference's registry, in its order: the MoE
architectures the executor serves, the dense decoder families, the
recurrent (rwkv6), hybrid (zamba2) and encoder-decoder (seamless_m4t) ones.
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCHS = [
    "seamless_m4t_large_v2",
    "chameleon_34b",
    "zamba2_1p2b",
    "qwen2_1p5b",
    "deepseek_coder_33b",
    "gemma3_1b",
    "olmo_1b",
    "rwkv6_7b",
    "qwen3_moe_235b_a22b",
    "dbrx_132b",
]

EXTRA_ARCHS = ["deepseek_v32"]  # the paper's own model

_ALIASES = {
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "chameleon-34b": "chameleon_34b",
    "zamba2-1.2b": "zamba2_1p2b",
    "qwen2-1.5b": "qwen2_1p5b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "gemma3-1b": "gemma3_1b",
    "olmo-1b": "olmo_1b",
    "rwkv6-7b": "rwkv6_7b",
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
