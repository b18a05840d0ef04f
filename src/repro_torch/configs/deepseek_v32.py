"""deepseek_v32 — the PAPER's own model (DeepSeek-V3.2 backbone geometry).

61L d_model=7168, 256 routed experts top-8 + 1 shared expert, expert
d_ff=2048, with a GQA attention backbone in place of MLA/DSA (orthogonal to
ASAP's contribution; GQA keeps the O(s^2) prefill term).  Head geometry
matches MLA's compute profile: 128 heads x 192 qk-dim.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek_v32",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=8,
    head_dim=192,
    d_ff=18432,           # dense-equivalent ffn (first layers in real model)
    vocab_size=129_280,
    num_experts=256,
    top_k=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    rope_theta=10_000.0,
    tie_embeddings=False,
)
