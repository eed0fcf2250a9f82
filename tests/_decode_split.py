"""Plain-PyTorch emulation of the CUDA decode-attention kernel's split
schedule (``src/repro_torch/kernels/csrc/decode_attention.cu``), for the CPU
tests: the port never calls it.

Each slot's ring walk covers ``n_rows = min(C, pos + 1)`` rows for
``0 <= pos < C`` and all ``C`` otherwise.  S splits take rows
``[ceil(i n / S), ceil((i + 1) n / S))`` each and hold an fp32 partial
(m, l, acc) per query head: masked rows score -1e30, rows past the walk are
not there at all, and a split with no rows holds m = -inf, l = 0, acc = 0.
The partials merge with the online softmax's rescale exp(m_s - M), a split
at m_s = -inf weighing exactly 0 (so M = -inf never meets exp(-inf + inf)).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.decode_attention import NEG_INF, ring_mask
from repro_torch.quant import dequantize_kv


def walk_rows(pos: int, C: int) -> int:
    return pos + 1 if 0 <= pos < C else C


def split_bounds(n_rows: int, S: int):
    """[(lo, hi)] of the S splits, lo = ceil(i n / S)."""
    return [(-(-i * n_rows // S), -(-(i + 1) * n_rows // S))
            for i in range(S)]


def decode_attention_split(q, k_cache, v_cache, positions, S, *, scale=None,
                           window=None, softcap=None, k_scale=None,
                           v_scale=None):
    """q (N, H, hd); k/v (N, C, Hkv, hd); positions (N,) -> (N, H, hd) in
    q's dtype, through S split partials per (slot, KV head)."""
    N, H, hd = q.shape
    C, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if k_scale is not None:
        k_cache = dequantize_kv(k_cache, k_scale, q.dtype)
        v_cache = dequantize_kv(v_cache, v_scale, q.dtype)
    k, v = k_cache.float(), v_cache.float()
    valid = ring_mask(positions, C, window)
    out = torch.empty((N, Hkv, G, hd), dtype=torch.float32)
    for n in range(N):
        qn = q[n].float().reshape(Hkv, G, hd)
        parts = []
        for lo, hi in split_bounds(walk_rows(int(positions[n]), C), S):
            if hi == lo:
                parts.append((torch.full((Hkv, G), -math.inf),
                              torch.zeros(Hkv, G), torch.zeros(Hkv, G, hd)))
                continue
            s = torch.einsum("kgd,tkd->kgt", qn, k[n, lo:hi]) * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            s = torch.where(valid[n, lo:hi], s, NEG_INF)
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1),
                          torch.einsum("kgt,tkd->kgd", p, v[n, lo:hi])))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        lsum = torch.zeros(Hkv, G)
        acc = torch.zeros(Hkv, G, hd)
        for m, l, a in parts:
            c = torch.where(m == -math.inf, 0.0, torch.exp(m - M))
            lsum = lsum + l * c
            acc = acc + a * c[..., None]
        out[n] = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out.reshape(N, H, hd).to(q.dtype)
