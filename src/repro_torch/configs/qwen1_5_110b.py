"""qwen1.5-110b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064: RMSNorm, QKV bias, rope (theta 1e6), SwiGLU, untied
embeddings.  The same configurations as ``repro.configs.qwen1_5_110b``."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=49152,
    vocab_size=152064, head_dim=128,
    qkv_bias=True, rope=True, rope_theta=1_000_000.0,
    activation="swiglu", tie_embeddings=False,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen1.5-110b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160,
    vocab_size=512, head_dim=8,
    qkv_bias=True, rope=True, activation="swiglu", tie_embeddings=False,
)
