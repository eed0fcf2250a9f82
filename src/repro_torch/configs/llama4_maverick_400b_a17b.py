"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
vocab=202048; MoE 128 routed experts top-1 + 1 shared, interleaved every
other layer (dense layers d_ff=16384, expert d_ff=8192).  The same
configurations as ``repro.configs.llama4_maverick_400b_a17b``."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab_size=202048, head_dim=128,
    rope=True, rope_theta=500_000.0,
    n_experts=128, n_shared_experts=1, moe_top_k=1, moe_every=2,
    dense_d_ff=16384, capacity_factor=1.25,
    activation="swiglu", tie_embeddings=False,
)

SMOKE_CONFIG = ModelConfig(
    name="llama4-maverick-smoke", family="moe",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=512, head_dim=16,
    n_experts=8, n_shared_experts=1, moe_top_k=1, moe_every=2,
    dense_d_ff=192, activation="swiglu", tie_embeddings=False,
)
