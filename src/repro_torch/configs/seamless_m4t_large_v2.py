"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal [arXiv:2308.11596; hf].

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206. Interpreted as 24
encoder + 24 decoder layers (SeamlessM4T-v2-large geometry). The speech
frontend is a STUB: input_specs provides precomputed frame embeddings.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=48,          # 24 enc + 24 dec
    encoder_layers=24,
    decoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    frontend="audio",
    rope_theta=10_000.0,
    act="gelu",
    tie_embeddings=True,
)
