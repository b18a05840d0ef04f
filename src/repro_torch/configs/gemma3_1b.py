"""gemma3-1b [dense] — 5:1 local:global, 128k [hf:google/gemma-3-1b-pt; unverified].

26L d_model=1152 4H (GQA kv=1) head_dim=256 d_ff=6912 vocab=262144. 5
sliding-window (512) layers per global layer; 26 = 4×(5L+1G) superblocks + 2
local tail layers.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    window_size=512,
    local_per_global=5,
    rope_theta=1_000_000.0,
    scale_embeddings=True,
    qk_norm=True,
    tie_embeddings=True,
    act="gelu_tanh",
)
