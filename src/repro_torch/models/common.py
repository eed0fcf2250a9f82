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
    every family of the reference (dense, MoE, RWKV, Griffin and
    encoder-decoder); :func:`check_supported` names the fields it
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
        """bf16, fp64 for "float64" (a check of rounding, not a training
        dtype), fp32 otherwise."""
        return {"bfloat16": torch.bfloat16,
                "float64": torch.float64}.get(self.dtype, torch.float32)

    def param_count(self) -> int:
        """Analytic parameter count, the reference's ``param_count`` (every
        family's, so that a config of either package counts the same)."""
        D, H, Hkv, hd, F, V, L = (self.d_model, self.n_heads, self.n_kv_heads,
                                  self.hd, self.d_ff, self.vocab_size,
                                  self.n_layers)
        emb = V * D * (1 if self.tie_embeddings else 2)
        if self.family == "rwkv":
            per = 5 * D * D + 2 * (D * 64 + 64 * D) + 2 * D * F + 4 * D
            return emb + L * per
        if self.family == "griffin":
            # the reference's count leaves out each recurrent layer's w_a
            # and w_x (2 W^2); kept as it is, so both packages count alike
            W = self.rnn_width or D
            rec = 2 * D * W + W * D + 2 * W * self.conv_width + 4 * W
            att = D * (H * hd) + 2 * D * (Hkv * hd) + (H * hd) * D
            n_attn = L // 3
            return emb + (L - n_attn) * (rec + 3 * D * F) \
                + n_attn * (att + 3 * D * F)
        att = D * (H * hd) + 2 * D * (Hkv * hd) + (H * hd) * D
        mlp = (3 if self.activation in ("swiglu", "geglu") else 2) * D * F
        if self.family == "moe":
            n_moe = L // self.moe_every
            experts = (self.n_experts + self.n_shared_experts) * 3 * D * F
            dense = 3 * D * (self.dense_d_ff or F)
            return (emb + L * att + (L - n_moe) * dense
                    + n_moe * (experts + D * self.n_experts))
        if self.family == "encdec":
            # the reference's count leaves out frame_proj (D^2), the GELU
            # MLP's biases, the norms and the padded vocabulary rows; kept
            # as it is, so both packages count alike
            return emb + self.n_encoder_layers * (att + mlp) \
                + L * (2 * att + mlp)
        return emb + L * (att + mlp)

    def active_param_count(self) -> int:
        """Parameters a token passes through (the routed experts' top-k
        only), the reference's ``active_param_count``."""
        if self.family != "moe":
            return self.param_count()
        D, F, L, hd = self.d_model, self.d_ff, self.n_layers, self.hd
        att = (D * (self.n_heads * hd) + 2 * D * (self.n_kv_heads * hd)
               + (self.n_heads * hd) * D)
        emb = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        n_moe = L // self.moe_every
        active_mlp = (self.moe_top_k + self.n_shared_experts) * 3 * D * F
        return (emb + L * att + (L - n_moe) * 3 * D * (self.dense_d_ff or F)
                + n_moe * (active_mlp + D * self.n_experts))


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port does not
    implement yet, so that no such config is silently run as another.  The
    port implements the whole dense family: LayerNorm or RMSNorm (sandwich
    norms included), learned positions, rope or M-RoPE, QKV bias, GELU,
    SwiGLU or GeGLU, tied or untied embeddings, the embedding scale, and
    token or patch-embedding inputs; the MoE family on that trunk
    (``models/moe.py``: top-k routing, shared experts, a MoE layer in every
    layer or, with ``moe_every == 2``, every other one); the RWKV-6
    family (``models/rwkv.py``), whose trunk takes none of the dense
    trunk's norm, activation or rope fields; and the Griffin family
    (``models/griffin.py``: RG-LRU recurrent layers and local attention,
    whose norms are RMSNorm whatever ``norm_type`` says); and the
    encoder-decoder family (``models/encdec.py``: a bidirectional encoder
    over frame embeddings and a decoder with cross-attention, every norm
    RMSNorm).  A ``ValueError`` names a field the reference would fail on
    later."""
    if cfg.family not in ("dense", "moe", "rwkv", "griffin", "encdec"):
        raise NotImplementedError(
            f"config {cfg.name!r}: the port implements the dense, moe, "
            f"rwkv, griffin and encdec families; unsupported field: family "
            f"({cfg.family!r})")
    if cfg.kv_dtype not in ("bf16", "int8"):
        raise ValueError(f"kv_dtype {cfg.kv_dtype!r} is not bf16 or int8")
    if cfg.family == "rwkv":
        # the reference takes d_model // 64 heads of 64 (rwkv.py:39-40)
        # and ignores n_heads
        if cfg.d_model % 64:
            raise ValueError(f"d_model {cfg.d_model} is not a multiple of "
                             f"the RWKV head dim 64")
        return
    if cfg.family == "griffin":
        # the rolling window is the decode state's ring (griffin.py:
        # init_state), so it must exist; the conv carries its last
        # conv_width - 1 inputs, and at conv_width 1 the reference's
        # ``xp[:, -(cw - 1):]`` keeps the whole segment and its decode scan
        # fails on the shape
        if cfg.local_window is None or cfg.local_window < 1:
            raise ValueError(f"local_window {cfg.local_window} is below 1: "
                             f"griffin's decode ring needs a window")
        if cfg.conv_width < 2:
            raise ValueError(f"conv_width {cfg.conv_width} is below 2")
        # rnn_width None or 0 takes d_model, as the reference's rnn_width
        if cfg.rnn_width is not None and cfg.rnn_width < 0:
            raise ValueError(f"rnn_width {cfg.rnn_width} is below 0")
        if cfg.n_layers < 1:
            raise ValueError(f"n_layers {cfg.n_layers} is below 1")
        # griffin's embed passes no positions, which the reference's
        # learned-position table asserts on (layers.py:embed)
        if cfg.learned_pos:
            raise ValueError("learned_pos: griffin embeds no positions")
    if cfg.family == "encdec":
        # the encoder and the decoder are stacked trees of layers, which
        # the port carries as lists of at least one layer each
        for field in ("n_encoder_layers", "n_layers"):
            if getattr(cfg, field) < 1:
                raise ValueError(f"{field} {getattr(cfg, field)} is below "
                                 f"1: an encoder-decoder needs both stacks")
        # the decoder embeds no positions, which the reference's
        # learned-position table asserts on (layers.py:embed); its encoder
        # rotates by (B, S) positions, which M-RoPE's sections index as
        # (B, 3, S)
        if cfg.learned_pos:
            raise ValueError("learned_pos: the encoder-decoder embeds no "
                             "positions")
        if cfg.mrope_sections is not None:
            raise ValueError(f"mrope_sections {cfg.mrope_sections}: the "
                             f"encoder-decoder rotates by one position "
                             f"stream")
    if cfg.family == "moe":
        if cfg.n_experts < 1:
            raise ValueError(f"n_experts {cfg.n_experts} is below 1")
        if not 1 <= cfg.moe_top_k <= cfg.n_experts:
            raise ValueError(f"moe_top_k {cfg.moe_top_k} is outside "
                             f"1..{cfg.n_experts}")
        # the reference's grouped layers are one dense and one MoE layer
        # (transformer.py: one_group), so only 1 and 2 give n_layers layers
        if cfg.moe_every not in (1, 2):
            raise ValueError(f"moe_every {cfg.moe_every} is not 1 or 2")
        if cfg.n_layers % cfg.moe_every:
            raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                             f"moe_every {cfg.moe_every}")
    if (cfg.family not in ("griffin", "encdec")
            and cfg.norm_type not in ("ln", "rms")):
        raise ValueError(f"norm_type {cfg.norm_type!r} is not ln or rms")
    if cfg.activation not in ("gelu", "swiglu", "geglu"):
        raise ValueError(f"activation {cfg.activation!r} is not gelu, "
                         f"swiglu or geglu")
    if (cfg.mrope_sections is not None
            and 2 * sum(cfg.mrope_sections) != cfg.hd):
        raise ValueError(f"mrope_sections {cfg.mrope_sections} do not cover "
                         f"the rotary half of head dim {cfg.hd}")
