"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064: QKV bias, rope (theta 1e6) with M-RoPE sections 16/24/24,
SwiGLU, RMSNorm, untied embeddings.  The vision frontend is a stub, as in
the reference: callers feed precomputed patch embeddings, which
``patch_proj`` maps into the first positions.  The same configurations
as ``repro.configs.qwen2_vl_7b`` [arXiv:2409.12191]."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab_size=152064, head_dim=128,
    qkv_bias=True, rope=True, rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24), patch_embed_input=True,
    activation="swiglu", tie_embeddings=False,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-vl-7b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=512, head_dim=16,
    qkv_bias=True, rope=True, mrope_sections=(2, 3, 3),
    patch_embed_input=True, activation="swiglu", tie_embeddings=False,
)
