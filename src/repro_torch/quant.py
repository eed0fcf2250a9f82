"""int8 quantization of the serving KV cache: one block per written token.

The counterpart of the KV half of ``repro.quant`` (``quantize_kv``,
``dequantize_kv``, ``kv_bytes_per_token``).  Rounding is deterministic
round-to-nearest, ties to even (``torch.round``, like ``jnp.round``), so a
quantized token is a pure function of its content and the payloads are
bit-identical to the reference's.  The stochastic-rounding gradient
compressor that shares the reference module is not ported yet.
"""
from __future__ import annotations

import torch


def quantize_kv(x: torch.Tensor):
    """Per-token int8 KV quantization: x (..., Hkv, hd) -> (q int8 shaped
    like x, scales fp32 (...,)).  Each token's (Hkv, hd) slab is one block
    with scale ``max|x| / 127`` (floored at 1e-12), so the element-wise
    error is at most half that token's scale."""
    hkv, hd = x.shape[-2], x.shape[-1]
    blocks = x.to(torch.float32).reshape(-1, hkv * hd)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = scale.clamp_min(1e-12)
    q = torch.round(blocks / scale).clamp(-127, 127).to(torch.int8)
    return q.reshape(x.shape), scale.reshape(x.shape[:-2])


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype):
    """Inverse of :func:`quantize_kv`: int8 (..., Hkv, hd) + fp32 scales
    (...,) -> ``dtype``.  Dequantizes in fp32 (int8 * fp32 is exact) and
    rounds once into ``dtype``."""
    return (q.to(torch.float32) * scale[..., None, None]).to(dtype)


def kv_bytes_per_token(n_kv_heads: int, head_dim: int,
                       kv_dtype: str = "bf16") -> int:
    """Device-memory bytes of ONE cache entry (K + V) for one token in one
    layer: bf16 spends 2 bytes/element; int8 spends 1 byte/element plus one
    fp32 scale per token per K/V plane."""
    el = n_kv_heads * head_dim
    if kv_dtype == "int8":
        return 2 * (el + 4)
    return 2 * 2 * el
