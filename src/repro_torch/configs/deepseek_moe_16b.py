"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (MHA kv=16) expert
d_ff=1408 vocab=102400; fine-grained 64 routed experts top-6 + 2 shared.
The same configurations as ``repro.configs.deepseek_moe_16b``."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=102400, head_dim=128,
    rope=True,
    n_experts=64, n_shared_experts=2, moe_top_k=6, moe_every=1,
    capacity_factor=1.25,
    activation="swiglu", tie_embeddings=False,
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
    vocab_size=512, head_dim=16,
    n_experts=8, n_shared_experts=2, moe_top_k=3, moe_every=1,
    activation="swiglu", tie_embeddings=False,
)
