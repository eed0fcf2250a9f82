"""The paper's own model family (Table 2): GPT-2 in the nanoGPT style —
learned positions, GELU, LayerNorm, tied embeddings, context 1024 — and
GPT-NeoX 1.5B/6.6B (rope, untied embeddings, context 2048).  The same
configurations as ``repro.configs.gpt2``; as there, the NeoX models are
not in ``ARCHS``."""
from ..models.common import ModelConfig


def _gpt2(name, d, L, H, ctx=1024, vocab=50304):
    return ModelConfig(
        name=name, family="dense", n_layers=L, d_model=d, n_heads=H,
        n_kv_heads=H, d_ff=4 * d, vocab_size=vocab,
        rope=False, learned_pos=True, max_position_embeddings=ctx,
        norm_type="ln", activation="gelu", tie_embeddings=True,
    )


def _neox(name, d, L, H, ctx=2048, vocab=50432):
    return ModelConfig(
        name=name, family="dense", n_layers=L, d_model=d, n_heads=H,
        n_kv_heads=H, d_ff=4 * d, vocab_size=vocab,
        rope=True, norm_type="ln", activation="gelu", tie_embeddings=False,
    )


GPT2_30M = _gpt2("gpt2-30m", 384, 6, 6)
GPT2_SMALL = _gpt2("gpt2-small-125m", 768, 12, 12)
GPT2_MEDIUM = _gpt2("gpt2-medium-355m", 1024, 24, 16)
GPT2_540M = _gpt2("gpt2-540m", 1152, 30, 18)
GPT2_LARGE = _gpt2("gpt2-large-770m", 1280, 36, 20)
NEOX_1_5B = _neox("neox-1.5b", 1536, 48, 24)
NEOX_6_6B = _neox("neox-6.6b", 4096, 32, 32)

# tiny variant for fast CPU tests
GPT2_TINY = _gpt2("gpt2-tiny", 128, 4, 4, ctx=256, vocab=512)

CONFIG = GPT2_SMALL
SMOKE_CONFIG = GPT2_TINY
