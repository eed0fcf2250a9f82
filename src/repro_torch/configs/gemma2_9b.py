"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000, head dim 256: local and global attention alternating (window
4096), logit softcaps (attention 50, final 30), RMSNorm with sandwich
norms, GeGLU, tied embeddings scaled by sqrt(d_model).  The same
configurations as ``repro.configs.gemma2_9b``."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_ff=14336,
    vocab_size=256000, head_dim=256,
    rope=True, local_global_pattern="alternating", local_window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0, post_norms=True,
    activation="geglu", tie_embeddings=True, embed_scale=True,
)

SMOKE_CONFIG = ModelConfig(
    name="gemma2-9b-smoke", family="dense",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=512, head_dim=16,
    rope=True, local_global_pattern="alternating", local_window=16,
    attn_logit_softcap=50.0, final_logit_softcap=30.0, post_norms=True,
    activation="geglu", tie_embeddings=True, embed_scale=True,
)
