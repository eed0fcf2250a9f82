"""Model configuration shared by every architecture family (a copy of
``repro.models.common.ModelConfig`` with torch dtypes), and the check of
which of its fields the port implements."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's config type, field for field, so a config converts
    between the two packages by ``dataclasses.asdict``.  The port implements
    the dense family; :func:`check_supported` names the fields it
    refuses."""
    name: str
    family: str                       # dense | moe | rwkv | griffin | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // n_heads
    # attention options
    qkv_bias: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    learned_pos: bool = False         # GPT-2 family
    max_position_embeddings: int = 1 << 20
    local_window: Optional[int] = None
    local_global_pattern: Optional[str] = None  # "alternating"
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    attn_temperature_by_layer: bool = False
    # MLP
    activation: str = "swiglu"        # swiglu | gelu | geglu
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 1
    moe_every: int = 1
    dense_d_ff: Optional[int] = None
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # enc-dec
    n_encoder_layers: int = 0
    # VLM / multimodal
    mrope_sections: Optional[Tuple[int, ...]] = None
    patch_embed_input: bool = False
    frame_embed_input: bool = False
    # griffin
    rnn_width: Optional[int] = None
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = ()
    # embeddings / head
    tie_embeddings: bool = True
    embed_scale: bool = False
    # norms
    norm_type: str = "rms"            # rms | ln (GPT-2)
    post_norms: bool = False
    # numerics
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"
    norm_eps: float = 1e-6
    # serving KV cache storage: "bf16" stores entries in the compute dtype;
    # "int8" stores int8 payloads + one fp32 scale per written token
    kv_dtype: str = "bf16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128, as in the reference."""
        return -(-self.vocab_size // 128) * 128

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port does not
    implement yet, so that no such config is silently run as another.  The
    port implements the whole dense family: LayerNorm or RMSNorm (sandwich
    norms included), learned positions, rope or M-RoPE, QKV bias, GELU,
    SwiGLU or GeGLU, tied or untied embeddings, the embedding scale, and
    token or patch-embedding inputs.  The other families (moe, rwkv,
    griffin, encdec) are refused."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"config {cfg.name!r}: the port implements the dense family; "
            f"unsupported field: family ({cfg.family!r})")
    if cfg.norm_type not in ("ln", "rms"):
        raise ValueError(f"norm_type {cfg.norm_type!r} is not ln or rms")
    if cfg.activation not in ("gelu", "swiglu", "geglu"):
        raise ValueError(f"activation {cfg.activation!r} is not gelu, "
                         f"swiglu or geglu")
    if cfg.kv_dtype not in ("bf16", "int8"):
        raise ValueError(f"kv_dtype {cfg.kv_dtype!r} is not bf16 or int8")
    if (cfg.mrope_sections is not None
            and 2 * sum(cfg.mrope_sections) != cfg.hd):
        raise ValueError(f"mrope_sections {cfg.mrope_sections} do not cover "
                         f"the rotary half of head dim {cfg.hd}")
