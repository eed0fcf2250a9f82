"""Shared layers of the dense family (LayerNorm or RMSNorm; learned
positions or rope; QKV bias; GELU, SwiGLU or GeGLU; tied or untied
embeddings, the embedding scale), as plain functions on tensors.

The counterpart of ``repro/models/layers.py``, with its conventions:

  * parameters are stored in fp32 and cast to the activation's compute
    dtype at each use (``p["wq"].to(dt)``);
  * norms, attention scores and softmax run in fp32; the unembedding
    accumulates in fp32 even for bf16 activations;
  * every init function takes an explicit ``torch.Generator`` and draws on
    that generator's device.

Training attention takes the flash kernels (``kernels/flash_attention.py``,
the reference's default route, ``fused_attn=True``), :func:`full_attention`,
which materializes the (S, S) scores in fp32 (the reference's
``fused_attn=False``), or :func:`chunked_attention`, the reference's online
softmax over KV blocks in plain PyTorch (above 4096 tokens on "auto").  Serving attention writes the slot cache
in place (the reference returns a new cache): decode writes one token per active slot, prefill one chunk of
one slot.  Decode attention goes through ``kernels/decode_attention.py``
with q pre-scaled in fp32 and rounded to its dtype, the convention of the
reference's Pallas route (``layers.py:489-496``), so the CUDA kernel and
the CPU's plain version compute one function.

Under rope every attention route rotates q and k by their absolute
positions before the scores (training: the (B, S) ``positions``, by
default 0..S-1; decode: each slot's position; prefill: the chunk's),
and the slot cache holds rotated keys, as the reference's does.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.decode_attention import NEG_INF, decode_attention, ring_mask
from ..kernels.flash_attention import flash_attention
from ..quant import dequantize_kv, quantize_kv
from .common import ModelConfig

# ---------------------------------------------------------------------------
# initializers


def dense_init(gen: torch.Generator, shape, in_axis=-2):
    """LeCun-normal (fan-in) initialization, fp32."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    x = torch.randn(shape, generator=gen, device=gen.device)
    return x / math.sqrt(fan_in)


def embed_init(gen: torch.Generator, shape):
    return torch.randn(shape, generator=gen, device=gen.device) * 0.02


# ---------------------------------------------------------------------------
# norms


def rms_norm(x, scale, eps=1e-6):
    """RMSNorm in fp32, ``x * rsqrt(mean(x^2) + eps) * (1 + scale)``, cast
    back to x's dtype (the scale is stored as an offset from 1)."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm in fp32 with the population variance, cast back to x's
    dtype."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps) * scale + bias
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device) -> torch.Tensor:
    return rope_freqs(head_dim, theta).to(device)


def rope_freqs(head_dim: int, theta: float) -> torch.Tensor:
    """``1 / theta ** (2i / head_dim)`` in fp32, on the CPU (bit for bit
    the reference's ``rope_freqs``)."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                            / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x (B, S, H, hd) rotated by positions (B, S): the angles, cos and sin
    in fp32, the halves ``[x1 cos - x2 sin, x2 cos + x1 sin]`` in fp32,
    cast back to x's dtype (the reference's ``apply_rope`` without
    M-RoPE).  The frequencies are computed once on the CPU and cached on
    each device, so every device rotates by the same fp32 values."""
    freqs = _rope_freqs_on(x.shape[-1], float(theta), x.device)
    angles = positions[..., None].to(torch.float32) * freqs   # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _train_positions(x, positions):
    """The training routes' positions: the given (B, S), else 0..S-1."""
    if positions is not None:
        return positions
    B, S = x.shape[0], x.shape[1]
    return torch.arange(S, device=x.device)[None].expand(B, S)


# ---------------------------------------------------------------------------
# attention


def init_attention(gen: torch.Generator, cfg: ModelConfig):
    """``wq``, ``wk``, ``wv``, ``wo``; with QKV bias also ``bq``, ``bk``,
    ``bv``, zeros (the reference's leaves)."""
    D, hd, H, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    p = {"wq": dense_init(gen, (D, H * hd)),
         "wk": dense_init(gen, (D, Hkv * hd)),
         "wv": dense_init(gen, (D, Hkv * hd)),
         "wo": dense_init(gen, (H * hd, D), in_axis=0)}
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", Hkv * hd),
                            ("bv", Hkv * hd)):
            p[name] = torch.zeros((width,), device=gen.device)
    return p


def _qkv(p, x, cfg: ModelConfig, positions=None):
    """q, k, v (B, S, heads, hd) in x's dtype: the projections, plus the
    biases in x's dtype with QKV bias; under rope q and k rotated by
    ``positions`` (B, S).  Every attention route (training, decode,
    prefill) projects here."""
    dt = x.dtype
    B, S, _ = x.shape
    q, k, v = (x @ p[w].to(dt) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = (t + p[b].to(dt) for t, b in ((q, "bq"), (k, "bk"),
                                                (v, "bv")))
    q = q.reshape(B, S, cfg.n_heads, cfg.hd)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.hd)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _softcap(scores, cap):
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def attention_scale(cfg: ModelConfig, layer_scale: float) -> float:
    """``layer_scale / sqrt(hd)`` rounded as the reference computes it: an
    fp32 layer scale divided in fp32."""
    return float(np.float32(layer_scale) / np.float32(math.sqrt(cfg.hd)))


def attention_scores_block(q, k, cfg: ModelConfig, scale):
    """q (B, Sq, H, hd), k (B, Sk, Hkv, hd) -> (B, Hkv, G, Sq, Sk) fp32
    scores (fp32 products of the operands, exact for bf16)."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    return _softcap(scores, cfg.attn_logit_softcap)


def _causal_window_mask(S, window, device):
    """(S, S) bool mask, True = attend; the window counts key distance."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    return m


def full_attention(p, x, cfg: ModelConfig, *, positions=None, window=None,
                   layer_scale=1.0):
    """Causal training attention with materialized scores, the reference's
    ``full_attention``: fp32 scores ``q.k * layer_scale / sqrt(hd)``,
    softcap, the causal (and window) mask at the -1e30 sentinel, fp32
    softmax cast to x's dtype, then ``w . v`` and the output projection.
    x (B, S, D) -> (B, S, D); ``positions`` (B, S) rotate q and k under
    rope (the training routes' default: 0..S-1)."""
    dt = x.dtype
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, _train_positions(x, positions))
    scale = attention_scale(cfg, layer_scale)
    scores = attention_scores_block(q, k, cfg, scale)      # (B,Hkv,G,S,S)
    mask = _causal_window_mask(S, window, x.device)
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(dt)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    out = out.reshape(B, S, cfg.n_heads * cfg.hd)
    return out @ p["wo"].to(dt)


def _flash_attention_proj(p, x, cfg: ModelConfig, *, positions=None,
                          window=None, layer_scale=1.0, use_jvp=False):
    """The reference's flash route (``layers.py:_flash_attention_proj``):
    qkv, heads to (B, H, S, hd), the flash kernels, back, then the output
    projection.  Its scale is ``layer_scale / sqrt(hd)`` in Python double
    (the kernel rounds it to fp32 once), and p stays in fp32 until o is
    rounded: in bf16 this route and :func:`full_attention`, which rounds
    the softmax weights before ``w . v``, differ by about an ulp.  Under
    rope q and k are rotated before the kernels."""
    dt = x.dtype
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, _train_positions(x, positions))
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True,
                        scale=float(layer_scale) / math.sqrt(cfg.hd),
                        window=window, softcap=cfg.attn_logit_softcap,
                        use_jvp=use_jvp)
    out = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.hd)
    return out @ p["wo"].to(dt)


def chunked_attention(p, x, cfg: ModelConfig, *, positions=None, window=None,
                      layer_scale=1.0, kv_block: int = 1024):
    """Causal training attention as an online softmax over KV blocks, the
    reference's ``chunked_attention``: the (S, S) scores never exist, the
    largest temporary is (B, Hkv, G, S, kv_block).  ``kv_block`` shrinks to
    the largest divisor of S at most the request; scores ``q.k * scale``
    in fp32 (scale ``layer_scale / sqrt(hd)`` in Python double, as the
    reference's), softcap, the causal (and window) mask at the -1e30
    sentinel, a running max from -inf, the block's weights cast to x's
    dtype before ``p . v``.  x (B, S, D) -> (B, S, D); ``positions`` as
    in :func:`full_attention`."""
    dt = x.dtype
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, _train_positions(x, positions))
    scale = layer_scale / math.sqrt(cfg.hd)
    Hkv, G, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    qg = q.reshape(B, S, Hkv, G, hd).to(torch.float32)
    kv_block = min(kv_block, S)           # short sequences: one block
    while S % kv_block:                   # largest divisor <= requested
        kv_block -= 1
    qpos = torch.arange(S, device=x.device)[:, None]
    f32 = dict(dtype=torch.float32, device=x.device)
    m_run = torch.full((B, Hkv, G, S), -math.inf, **f32)
    l_run = torch.zeros((B, Hkv, G, S), **f32)
    acc = torch.zeros((B, Hkv, G, S, hd), **f32)
    for start in range(0, S, kv_block):
        kb = k[:, start:start + kv_block]
        vb = v[:, start:start + kv_block]
        scores = torch.einsum("bskgh,btkh->bkgst", qg,
                              kb.to(torch.float32)) * scale
        scores = _softcap(scores, cfg.attn_logit_softcap)
        kpos = start + torch.arange(kv_block, device=x.device)[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask = mask & (kpos > qpos - window)
        scores = torch.where(mask[None, None, None], scores, NEG_INF)
        m_new = torch.maximum(m_run, scores.amax(-1))
        alpha = torch.exp(m_run - m_new)
        pexp = torch.exp(scores - m_new[..., None])
        l_run = l_run * alpha + pexp.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkh->bkgsh", pexp.to(dt), vb).to(torch.float32)
        m_run = m_new
    out = (acc / torch.clamp_min(l_run, 1e-30)[..., None]).to(dt)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, cfg.n_heads * cfg.hd)
    return out @ p["wo"].to(dt)


TRAIN_ATTN_IMPLS = ("auto", "full", "chunked", "flash", "flash_jvp")


def train_attention(p, x, cfg: ModelConfig, *, positions=None, window=None,
                    layer_scale=1.0, impl="auto"):
    """Route one training attention call: "flash" takes the flash kernels
    (:func:`_flash_attention_proj`), "flash_jvp" their twin of the
    Hutchinson HVP (the forward kernel, a backward that autograd can
    differentiate again), "chunked" :func:`chunked_attention`, "full"
    :func:`full_attention`; "auto" (and None) takes the chunked route above
    4096 tokens and the full one up to there, the reference's heuristic.
    ``positions`` (B, S) go to the route (rope)."""
    impl = impl or "auto"
    if impl not in TRAIN_ATTN_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl in ("flash", "flash_jvp"):
        return _flash_attention_proj(p, x, cfg, positions=positions,
                                     window=window, layer_scale=layer_scale,
                                     use_jvp=impl == "flash_jvp")
    if impl == "chunked" or (impl == "auto" and x.shape[1] > 4096):
        return chunked_attention(p, x, cfg, positions=positions,
                                 window=window, layer_scale=layer_scale)
    return full_attention(p, x, cfg, positions=positions, window=window,
                          layer_scale=layer_scale)


def ring_write(cache, val, positions, active=None):
    """cache (N, C, ...) <- val (N, 1, ...) at ``positions % C``, in place.
    Where ``active`` (N,) bool is False the slot keeps its entry: a slot
    that is mid-prefill or free must not get a token written into its
    ring (the reference computes every slot and keeps the old state of the
    inactive ones)."""
    N, C = cache.shape[0], cache.shape[1]
    rows = torch.arange(N, device=cache.device)
    idx = torch.remainder(positions.to(torch.int64), C)
    new = val[:, 0].to(cache.dtype)
    if active is not None:
        keep = active.reshape((N,) + (1,) * (new.dim() - 1))
        new = torch.where(keep, new, cache[rows, idx])
    cache[rows, idx] = new
    return cache


def kv_is_quantized(kv) -> bool:
    """True when a slot cache carries int8 payloads + scale planes."""
    return "k_scale" in kv


def decode_attention_slots(p, x, cfg: ModelConfig, kv, positions, *,
                           window: Optional[int] = None, layer_scale=1.0,
                           active=None):
    """Per-slot decode: x (N, 1, D); ``kv`` the per-layer slot cache —
    {"k", "v"} (N, C, Hkv, hd), plus {"k_scale", "v_scale"} (N, C) fp32
    for an int8 cache; positions (N,).  Writes each active slot's new K/V
    (under rope, k rotated by the slot's position) at its position (int8:
    round-to-nearest payload + per-token scale) and returns the attention
    output (N, 1, D)."""
    dt = x.dtype
    N = x.shape[0]
    q, k, v = _qkv(p, x, cfg, positions[:, None])
    if kv_is_quantized(kv):
        k8, ks = quantize_kv(k)                          # (N,1,Hkv,hd),(N,1)
        v8, vs = quantize_kv(v)
        for name, val in (("k", k8), ("v", v8), ("k_scale", ks),
                          ("v_scale", vs)):
            ring_write(kv[name], val, positions, active)
    else:
        ring_write(kv["k"], k, positions, active)
        ring_write(kv["v"], v, positions, active)
    scale = attention_scale(cfg, layer_scale)
    qs = (q[:, 0].to(torch.float32) * scale).to(q.dtype)
    out = decode_attention(qs, kv["k"], kv["v"], positions, scale=1.0,
                           window=window, softcap=cfg.attn_logit_softcap,
                           k_scale=kv.get("k_scale"),
                           v_scale=kv.get("v_scale"))
    out = out.reshape(N, 1, cfg.n_heads * cfg.hd).to(dt)
    return out @ p["wo"].to(dt)


def prefill_chunk_attention(p, h, cfg: ModelConfig, kv, slot: int,
                            start: int, qpos, *, window: Optional[int] = None,
                            layer_scale=1.0):
    """Chunk-prefill attention for one slot: h (1, P, D) normed chunk;
    ``kv`` the per-layer slot cache; qpos (P,) the chunk's absolute
    positions.  Writes the chunk's K/V at [slot, start:start+P] in place
    (int8 caches store payloads + per-token scales and the chunk attends
    the dequantized row, its own tokens included), then attends the chunk
    queries against the slot's whole ring row under :func:`ring_mask`;
    under rope q and k are rotated by ``qpos`` first.
    Entries past the chunk's valid tokens are written but stay masked until
    decode overwrites them.  Returns (1, P, D)."""
    dt = h.dtype
    P = h.shape[1]
    C = kv["k"].shape[1]
    quant = kv_is_quantized(kv)
    q, k, v = _qkv(p, h, cfg, qpos[None])
    rows = slice(start, start + P)
    if quant:
        k8, ks = quantize_kv(k)                          # (1,P,Hkv,hd),(1,P)
        v8, vs = quantize_kv(v)
        kv["k"][slot, rows] = k8[0]
        kv["v"][slot, rows] = v8[0]
        kv["k_scale"][slot, rows] = ks[0]
        kv["v_scale"][slot, rows] = vs[0]
        row_k = dequantize_kv(kv["k"][slot:slot + 1],
                              kv["k_scale"][slot:slot + 1], dt)
        row_v = dequantize_kv(kv["v"][slot:slot + 1],
                              kv["v_scale"][slot:slot + 1], dt)
    else:
        kv["k"][slot, rows] = k[0].to(kv["k"].dtype)
        kv["v"][slot, rows] = v[0].to(kv["v"].dtype)
        row_k, row_v = kv["k"][slot:slot + 1], kv["v"][slot:slot + 1]
    scale = attention_scale(cfg, layer_scale)
    scores = attention_scores_block(q, row_k, cfg, scale)   # (1,Hkv,G,P,C)
    mask = ring_mask(qpos, C, window)                       # (P, C)
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(dt)
    out = torch.einsum("bkgst,btkh->bskgh", w, row_v)
    out = out.reshape(1, P, cfg.n_heads * cfg.hd)
    return out @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# MLP


def init_mlp(gen: torch.Generator, cfg: ModelConfig):
    """GELU: ``w_up``, ``b_up``, ``w_down``, ``b_down``; SwiGLU and GeGLU:
    ``w_gate``, ``w_up``, ``w_down`` without biases (the reference's
    leaves)."""
    D, F_ = cfg.d_model, cfg.d_ff
    if cfg.activation in ("swiglu", "geglu"):
        return {"w_gate": dense_init(gen, (D, F_)),
                "w_up": dense_init(gen, (D, F_)),
                "w_down": dense_init(gen, (F_, D), in_axis=0)}
    return {"w_up": dense_init(gen, (D, F_)),
            "b_up": torch.zeros((F_,), device=gen.device),
            "w_down": dense_init(gen, (F_, D), in_axis=0),
            "b_down": torch.zeros((D,), device=gen.device)}


def mlp(p, x, cfg: ModelConfig):
    """SwiGLU ``(silu(x Wg) * (x Wu)) Wd``, GeGLU ``(gelu(x Wg) * (x Wu))
    Wd`` or the GELU MLP, in x's dtype; every GELU is the tanh
    approximation, ``jax.nn.gelu``'s default."""
    dt = x.dtype
    if cfg.activation in ("swiglu", "geglu"):
        g = x @ p["w_gate"].to(dt)
        g = F.silu(g) if cfg.activation == "swiglu" else F.gelu(
            g, approximate="tanh")
        return (g * (x @ p["w_up"].to(dt))) @ p["w_down"].to(dt)
    h = F.gelu(x @ p["w_up"].to(dt) + p["b_up"].to(dt), approximate="tanh")
    return h @ p["w_down"].to(dt) + p["b_down"].to(dt)


# ---------------------------------------------------------------------------
# embedding / unembedding


def init_embedding(gen: torch.Generator, cfg: ModelConfig):
    """``tok`` (Vp, D); ``unembed`` (D, Vp) only when untied; ``pos``
    (max_position_embeddings, D) only with learned positions (a rope
    config keeps the default 2^20 there, which no table is made for)."""
    p = {"tok": embed_init(gen, (cfg.padded_vocab, cfg.d_model))}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab))
    if cfg.learned_pos:
        p["pos"] = embed_init(gen, (cfg.max_position_embeddings,
                                    cfg.d_model))
    return p


def embed(p, tokens, cfg: ModelConfig, positions=None):
    """Gather from the fp32 table, cast to the compute dtype; with the
    embedding scale multiply by sqrt(d_model) rounded to that dtype first
    (the reference's ``jnp.asarray(sqrt(d), x.dtype)``); then, with
    learned positions, add the position row in that dtype.  A position
    past the table (only the zero-padded tail of a last prefill chunk,
    whose queries nothing reads) takes the last row instead of indexing
    out of bounds."""
    x = p["tok"][tokens.to(torch.int64)].to(cfg.compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    if not cfg.learned_pos:
        return x
    pos = positions.to(torch.int64).clamp(max=p["pos"].shape[0] - 1)
    return x + p["pos"][pos].to(x.dtype)


def unembed(p, x, cfg: ModelConfig):
    """hidden -> fp32 logits over ``padded_vocab``, the padding columns
    masked to -1e30: ``x . tok^T`` tied, ``x . unembed`` untied.  The
    weight is cast to x's dtype and the product accumulates in fp32:
    products of bf16 values are exact in fp32, as with the reference's
    ``preferred_element_type``."""
    if cfg.tie_embeddings:
        w = p["tok"].to(x.dtype).to(torch.float32).T
    else:
        w = p["unembed"].to(x.dtype).to(torch.float32)
    logits = x.to(torch.float32) @ w
    logits = _softcap(logits, cfg.final_logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        cols = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = torch.where(cols < cfg.vocab_size, logits, NEG_INF)
    return logits


# ---------------------------------------------------------------------------
# loss


def cross_entropy(logits, labels, mask=None):
    """Token-level CE of fp32 logits (..., V) against int labels (...):
    the masked mean ``sum(nll * mask) / max(sum(mask), 1)``, or the mean."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.to(torch.int64)[..., None])[..., 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1)
    return nll.mean()
