"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

94L d_model=4096 64H (GQA kv=4) d_ff=1536 (per expert) vocab=151936,
MoE 128e top-8 every layer, no shared expert. Primary ASAP technique carrier.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,            # per-expert ffn dim
    vocab_size=151_936,
    num_experts=128,
    top_k=8,
    moe_d_ff=1536,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)
