"""yi-6b [dense] — 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000:
the llama architecture, RMSNorm, rope (theta 5e6), SwiGLU, untied
embeddings.  The same configurations as ``repro.configs.yi_6b``."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, d_ff=11008,
    vocab_size=64000, head_dim=128,
    rope=True, rope_theta=5_000_000.0,
    activation="swiglu", tie_embeddings=False,
)

SMOKE_CONFIG = ModelConfig(
    name="yi-6b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160,
    vocab_size=512, head_dim=8, rope=True,
    activation="swiglu", tie_embeddings=False,
)
