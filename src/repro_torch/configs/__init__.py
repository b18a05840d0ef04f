"""Architecture registry.

`get_config(arch_id)` returns the full-size ModelConfig; `.smoke()` gives the
reduced same-family config for CPU tests.  The port carries every
architecture of the reference's registry, in its order: the MoE
architectures the executor serves, the dense decoder families, the
recurrent (rwkv6), hybrid (zamba2) and encoder-decoder (seamless_m4t) ones.
`SHAPES` is the assigned input-shape set; `cells()` enumerates the
(arch x shape) dry-run grid with the reference's skips.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

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


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic attention
LONG_CONTEXT_ARCHS = {"zamba2_1p2b", "rwkv6_7b", "gemma3_1b"}


def cell_supported(arch: str, shape: str) -> tuple[bool, Optional[str]]:
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, ("pure full-attention arch; long_500k needs "
                       "sub-quadratic attention")
    return True, None


def cells(include_extra: bool = False):
    """All (arch, shape) dry-run cells, with skips applied."""
    out = []
    for arch in ARCHS + (EXTRA_ARCHS if include_extra else []):
        for shape in SHAPES:
            if cell_supported(arch, shape)[0]:
                out.append((arch, shape))
    return out
