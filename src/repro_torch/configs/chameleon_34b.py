"""chameleon-34b [vlm] — early-fusion, VQ image tokens [arXiv:2405.09818; unverified].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536. Image tokens are VQ
codes inside the shared 65536 vocab (early fusion), so the backbone consumes
plain token ids; the VQ tokenizer itself is the stubbed frontend.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="dense",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65_536,
    frontend="vision",
    qk_norm=True,           # chameleon uses qk-norm for stability
    tie_embeddings=False,
)
