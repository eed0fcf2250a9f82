"""seamless-m4t-medium [audio] — encoder-decoder backbone: 12L encoder +
12L decoder, d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=256206 (padded
to 256,256).  The speech/text modality frontend is a stub, as in the
reference: the encoder takes precomputed frame embeddings (B, S_src,
d_model).  [arXiv:2308.11596; hf]
The same configurations as ``repro.configs.seamless_m4t_medium``."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_encoder_layers=12, d_model=1024, n_heads=16,
    n_kv_heads=16, d_ff=4096, vocab_size=256206, head_dim=64,
    rope=True, activation="gelu", tie_embeddings=True,
    frame_embed_input=True,
)

SMOKE_CONFIG = ModelConfig(
    name="seamless-m4t-smoke", family="encdec",
    n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, head_dim=16,
    rope=True, activation="gelu", tie_embeddings=True,
    frame_embed_input=True,
)
