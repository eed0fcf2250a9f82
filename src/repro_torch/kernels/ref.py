"""Plain PyTorch copies of the reference's oracles
(``repro/kernels/ref.py``).

The Sophia step and the step with the Hessian-EMA refresh fused in, on
one flat tensor, are the optimizer engine's reference backend, the default
of the reference trainer (``fused_kernel=False``); the Pallas engine
kernels that compute the same functions (``sophia_update.py``, rows 2-4 of
the kernel table) come with the engine-kernel slice.  The flash-attention
oracles hold the plain versions of ``kernels/flash_attention.py`` and,
through them, its CUDA kernels."""
from __future__ import annotations

import math

import torch

_f32 = torch.float32


def sophia_fused_ref(p, m, h, g, *, lr, beta1, gamma, eps, weight_decay,
                     clip_threshold=1.0):
    """One Sophia step on a flat tensor; returns (p', m', n_clipped):

        m'  = beta1 m + (1-beta1) g
        u   = clip(m' / max(gamma h, eps), +-rho)
        p'  = p - lr wd p - lr u

    fp32 math, stored dtypes kept (bf16 state rounds once at the end)."""
    m_new = beta1 * m.to(_f32) + (1.0 - beta1) * g.to(_f32)
    raw = m_new / torch.clamp_min(gamma * h.to(_f32), eps)
    u = raw.clamp(-clip_threshold, clip_threshold)
    p_new = p.to(_f32) * (1.0 - lr * weight_decay) - lr * u
    n_clipped = (raw.abs() >= clip_threshold).sum(dtype=torch.int32)
    return p_new.to(p.dtype), m_new.to(m.dtype), n_clipped


def hessian_ema_ref(h, hhat, *, beta2, scale=1.0):
    """h' = beta2 h + (1-beta2) scale hhat (Algorithm 3 line 9), rounded
    through h's dtype; ``scale`` folds the GNB batch factor B in."""
    e = torch.as_tensor(scale, dtype=_f32) * hhat.to(_f32)
    return (beta2 * h.to(_f32) + (1.0 - beta2) * e).to(h.dtype)


def sophia_step_refresh_ref(p, m, h, g, e, *, lr, flag, scale, beta1, beta2,
                            gamma, eps, weight_decay, clip_threshold=1.0):
    """The Sophia step with the flag-gated Hessian-EMA refresh: when
    ``flag`` is set, h first absorbs ``scale * e`` (rounded through its
    dtype) and the update reads the refreshed h; when clear, h passes
    through.  Returns (p', m', h', n_clipped)."""
    h_sel = (hessian_ema_ref(h, e, beta2=beta2, scale=scale)
             if float(flag) > 0.5 else h)
    p2, m2, nclip = sophia_fused_ref(
        p, m, h_sel, g, lr=lr, beta1=beta1, gamma=gamma, eps=eps,
        weight_decay=weight_decay, clip_threshold=clip_threshold)
    return p2, m2, h_sel, nclip


# ---------------------------------------------------------------------------
# flash attention (rows 16-18 of the kernel table): the plain-softmax
# oracles, mirroring the kernels' fp32 rounding points


def _attn_mask_ref(Sq, Sk, *, causal, window, q_offset, device=None):
    """(Sq, Sk) bool attend-mask; the window counts key distance."""
    qpos = q_offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    return m


def _attn_probs_ref(q, k, *, causal, scale, window, softcap, q_offset):
    """Shared forward recompute: (s_raw, lse, p) with p row-normalized
    fp32 (mask at -1e30, denominator floored at 1e-30)."""
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kx = k.repeat_interleave(G, dim=1)
    s_raw = torch.einsum("bhqd,bhkd->bhqk", q.to(_f32), kx.to(_f32)) * scale
    s = softcap * torch.tanh(s_raw / softcap) if softcap is not None \
        else s_raw
    mask = _attn_mask_ref(Sq, Sk, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)[None, None]
    s = torch.where(mask, s, -1e30)
    m = s.amax(-1, keepdim=True)
    e = torch.where(mask, torch.exp(s - m), 0.0)
    l = torch.clamp_min(e.sum(-1, keepdim=True), 1e-30)
    lse = (m + torch.log(l))[..., 0]
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    return s_raw, lse, p


def flash_attention_ref(q, k, v, *, causal=True, scale=None, window=None,
                        softcap=None, q_offset=0):
    """Plain softmax attention oracle for the flash forward: q (B, H, Sq,
    hd), k and v (B, Hkv, Sk, hd) GQA -> (o in q's dtype, lse (B, H, Sq)
    fp32), the kernel's two outputs."""
    G = q.shape[1] // k.shape[1]
    _, lse, p = _attn_probs_ref(q, k, causal=causal, scale=scale,
                                window=window, softcap=softcap,
                                q_offset=q_offset)
    vx = v.repeat_interleave(G, dim=1).to(_f32)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vx)
    return o.to(q.dtype), lse


def flash_attention_grads_ref(q, k, v, g, *, causal=True, scale=None,
                              window=None, softcap=None, q_offset=0):
    """Closed-form (dq, dk, dv) oracle of the backward kernels' fp32 math:
    ``delta`` from the ROUNDED forward output (the kernel's residual),
    ``p = exp(z - lse)``, the softcap chain on the raw scores."""
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    s_raw, lse, p = _attn_probs_ref(q, k, causal=causal, scale=scale,
                                    window=window, softcap=softcap,
                                    q_offset=q_offset)
    kx = k.repeat_interleave(G, dim=1).to(_f32)
    vx = v.repeat_interleave(G, dim=1).to(_f32)
    o32 = torch.einsum("bhqk,bhkd->bhqd", p, vx)
    o_r = o32.to(q.dtype).to(_f32)
    do = g.to(_f32)
    delta = (do * o_r).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, vx) - delta)
    if softcap is not None:
        ds = ds * (1.0 - torch.tanh(s_raw / softcap) ** 2)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kx) * scale
    dkx = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(_f32)) * scale
    dvx = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dk = dkx.reshape(B, Hkv, G, Sk, hd).sum(2)
    dv = dvx.reshape(B, Hkv, G, Sk, hd).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
