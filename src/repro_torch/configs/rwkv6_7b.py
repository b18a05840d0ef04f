"""rwkv6-7b [ssm] — Finch, data-dependent decay, attention-free [arXiv:2404.05892; hf].

32L d_model=4096 d_ff=14336 vocab=65536. 64 heads of size 64.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,       # wkv heads = d_model / ssm_head_dim
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65_536,
    ssm_head_dim=64,
    ssm_chunk=32,       # wkv chunk length (numerics-bounded, see rwkv6.py)
    tie_embeddings=False,
)
