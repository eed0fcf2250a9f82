"""stablelm-1.6b [dense] — 24L d_model=2048 32H (MHA kv=32) d_ff=5632
vocab=100352: LayerNorm, rope, SwiGLU, untied embeddings.  The same
configurations as ``repro.configs.stablelm_1_6b``."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab_size=100352, head_dim=64,
    rope=True, norm_type="ln", activation="swiglu", tie_embeddings=False,
)

SMOKE_CONFIG = ModelConfig(
    name="stablelm-1.6b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=8, d_ff=160,
    vocab_size=512, head_dim=8,
    rope=True, norm_type="ln", activation="swiglu", tie_embeddings=False,
)
