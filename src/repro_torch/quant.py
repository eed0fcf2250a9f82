"""Shared int8 block quantization: the counterpart of ``repro/quant.py``.

Two consumers, as in the reference:

  * the data-parallel gradient compressor (``distributed/compression.py``):
    256-element blocks, stochastic rounding keyed by a counter-based hash
    of ``(seed, global element index)``, so the wire representation does
    not depend on how many ranks the shard is split over; the error
    feedback is carried by the caller;
  * the serving KV cache: one block per written token, deterministic
    round-to-nearest, ties to even (``torch.round``, like ``jnp.round``),
    so a quantized token is a pure function of its content and the
    payloads are bit-identical to the reference's.

The hash runs on uint32 values held in int64, masked to 32 bits after
every multiply and add: a product of two 32-bit values leaves int64's
sign bit, but its low 32 bits stay right.  ``_quantize`` works through
the shard in block-aligned chunks of at most ``QUANT_CHUNK`` elements, so
its int64 temporaries stay bounded (a whole GPT-2 small shard would take
~1 GB per temporary); the noise and the scales are keyed on the global
index (``offset``), so the chunking changes no bit.
"""
from __future__ import annotations

import numpy as np
import torch

_GOLDEN = 0x9E3779B9  # 2^32 / golden ratio; per-shard seed decorrelation
_M32 = 0xFFFFFFFF
QUANT_CHUNK = 1 << 24  # elements a chunk of _quantize (rounded to blocks)


def _as_seed(rng):
    """Normalize an integer seed to a uint32 value (a Python int), None
    (round-to-nearest) to None.  The reference also takes JAX keys; the
    port's callers pass the integer seeds they derive (``trainer``)."""
    if rng is None:
        return None
    if isinstance(rng, torch.Tensor):
        if rng.dim() != 0 or rng.dtype.is_floating_point:
            raise TypeError(f"a seed is an integer scalar, got {rng!r}")
        rng = int(rng)
    if isinstance(rng, bool) or not isinstance(rng, (int, np.integer)):
        raise TypeError(f"a seed is an integer, got {type(rng).__name__}")
    return int(rng) & _M32


def _uniform_noise(seed: int, idx: torch.Tensor) -> torch.Tensor:
    """Counter-based uniform noise in [-0.5, 0.5): a murmur3-style
    finalizer of ``idx * 2654435761 + seed`` (uint32 arithmetic), a pure
    function of ``(seed, global element index)``.  ``idx`` is an integer
    tensor of indices (taken mod 2^32)."""
    x = (idx.to(torch.int64) & _M32) * 2654435761
    x = (x + (int(seed) & _M32)) & _M32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _M32
    x = x ^ (x >> 16)
    return x.to(torch.float32) * (2.0 ** -32) - 0.5


def _quantize_blocks(blocks, seed, offset, q, scale, deq):
    """One chunk of :func:`_quantize`: ``blocks`` (nb, block) whose first
    element has global index ``offset``, written into ``q``, ``scale`` and
    ``deq`` (views of the outputs)."""
    s = blocks.abs().amax(dim=1, keepdim=True)
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python
    # scalar divisor, which rounds differently from the divide
    s = (s / torch.full_like(s, 127.0)).clamp_min(1e-12)
    scaled = blocks / s
    if seed is not None:
        idx = torch.arange(blocks.numel(), dtype=torch.int64,
                           device=blocks.device) + int(offset)
        scaled = scaled + _uniform_noise(seed, idx).view(blocks.shape)
    qc = torch.round(scaled).clamp_(-127, 127).to(torch.int8)
    q.copy_(qc)
    scale.copy_(s)
    deq.copy_(qc.to(torch.float32) * s)


def _quantize(x: torch.Tensor, block: int, seed=None, *, offset: int = 0):
    """int8 block quantization with per-block fp32 scales: the reference's
    ``_quantize`` bit for bit.

    ``seed`` None selects round-to-nearest (|deq - x| <= scale/2, and the
    fp32 residual ``x - deq`` is exact); an integer seed selects stochastic
    rounding driven by :func:`_uniform_noise` (|deq - x| <= scale).
    ``offset`` is the global element index of ``x[0]`` within its flat
    shard: it keys the noise, not the math.  The order of operations is
    the reference's: ``max|block| / 127``, floored at 1e-12, the divide,
    the noise, round half to even, the clamp to +-127, then int8.

    Returns (q int8 [nblocks, block], scales fp32 [nblocks, 1], deq fp32
    shaped like x)."""
    seed = _as_seed(seed)
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.view(-1, block)
    nb = blocks.shape[0]
    q = torch.empty((nb, block), dtype=torch.int8, device=x.device)
    scale = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
    deq = torch.empty((nb, block), dtype=torch.float32, device=x.device)
    step = max(1, QUANT_CHUNK // block)
    for b0 in range(0, nb, step):
        b1 = min(nb, b0 + step)
        _quantize_blocks(blocks[b0:b1], seed, int(offset) + b0 * block,
                         q[b0:b1], scale[b0:b1], deq[b0:b1])
    deq = deq.view(-1)[:n].view(x.shape)
    return q, scale, deq


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
