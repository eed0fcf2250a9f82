"""rwkv6-7b [ssm] — Finch: 32L d_model=4096 (attn-free, 64 heads x 64)
d_ff=14336 vocab=65536; data-dependent decay.  [arXiv:2404.05892; hf]
The same configurations as ``repro.configs.rwkv6_7b``."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="rwkv",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, d_ff=14336,
    vocab_size=65536, head_dim=64,
    rope=False, tie_embeddings=False,
)

SMOKE_CONFIG = ModelConfig(
    name="rwkv6-7b-smoke", family="rwkv",
    n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, d_ff=256,
    vocab_size=512, head_dim=64,
    rope=False, tie_embeddings=False,
)
