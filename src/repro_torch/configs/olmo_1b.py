"""olmo-1b [dense] — non-parametric LN [arXiv:2402.00838; hf].

16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50_304,
    nonparametric_norm=True,
    tie_embeddings=True,
    act="silu",
)
