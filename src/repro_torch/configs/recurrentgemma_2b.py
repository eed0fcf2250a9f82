"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1, head 256)
d_ff=7680 vocab=256000; RG-LRU recurrent : local attention (window 2048)
at 2:1 (groups of rec,rec,attn; 26 = 8 groups + 2 tail recurrent).
[arXiv:2402.19427; hf]
The same configurations as ``repro.configs.recurrentgemma_2b``."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="griffin",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab_size=256000, head_dim=256,
    rope=True, local_window=2048, rnn_width=2560, conv_width=4,
    activation="geglu", tie_embeddings=True, embed_scale=True,
)

SMOKE_CONFIG = ModelConfig(
    name="recurrentgemma-smoke", family="griffin",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, d_ff=160,
    vocab_size=512, head_dim=16,
    rope=True, local_window=16, rnn_width=64, conv_width=4,
    activation="geglu", tie_embeddings=True, embed_scale=True,
)
