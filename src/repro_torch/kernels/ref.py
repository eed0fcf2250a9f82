"""Plain PyTorch copies of the reference's oracles
(``repro/kernels/ref.py``).

The optimizer steps on one flat tensor (Sophia, its Hessian EMA and its
step with the refresh fused in; AdamW; AdaHessian and its refresh-fused
step; Lion; SignGD; SGD) are the optimizer engine's reference backend,
the default of the reference trainer (``fused_kernel=False``), and the
math of the plain versions of the engine kernels
(``kernels/sophia_update.py``, rows 2-10 of the kernel table).  The
flash-attention oracles hold the plain versions of
``kernels/flash_attention.py`` and, through them, its CUDA kernels; the
forward-mode oracle holds its ``flash_jvp`` twin.

The operation order is the reference's, one PyTorch operation per
rounding: the CUDA kernels repeat it operation for operation, so that on
the card they agree with these bit for bit."""
from __future__ import annotations

import math

import torch

_f32 = torch.float32


def sophia_update_ref(p, m, h, g, *, lr, beta1, gamma, eps, weight_decay,
                      clip_threshold=1.0):
    """One Sophia step on a flat tensor; returns (p', m', clipped), the
    last the bool mask |raw| >= rho that the clip counts sum:

        m'  = beta1 m + (1-beta1) g
        raw = m' / max(gamma h, eps);  u = clip(raw, +-rho)
        p'  = p (1 - lr wd) - lr u

    fp32 math, stored dtypes kept (bf16 state rounds once at the end)."""
    m_new = beta1 * m.to(_f32) + (1.0 - beta1) * g.to(_f32)
    raw = m_new / torch.clamp_min(gamma * h.to(_f32), eps)
    u = raw.clamp(-clip_threshold, clip_threshold)
    p_new = p.to(_f32) * (1.0 - lr * weight_decay) - lr * u
    return p_new.to(p.dtype), m_new.to(m.dtype), raw.abs() >= clip_threshold


def sophia_fused_ref(p, m, h, g, *, lr, beta1, gamma, eps, weight_decay,
                     clip_threshold=1.0):
    """One Sophia step on a flat tensor; returns (p', m', n_clipped), the
    count an int32 scalar (:func:`sophia_update_ref`)."""
    p_new, m_new, clipped = sophia_update_ref(
        p, m, h, g, lr=lr, beta1=beta1, gamma=gamma, eps=eps,
        weight_decay=weight_decay, clip_threshold=clip_threshold)
    return p_new, m_new, clipped.sum(dtype=torch.int32)


def hessian_ema_ref(h, hhat, *, beta2, scale=1.0, square=False):
    """h' = beta2 h + (1-beta2) scale hhat (Algorithm 3 line 9), rounded
    through h's dtype; ``scale`` folds the GNB batch factor B in;
    ``square=True`` gives the AdaHessian variant h' = b2 h + (1-b2)
    (scale hhat)^2."""
    e = torch.as_tensor(scale, dtype=_f32, device=hhat.device) \
        * hhat.to(_f32)
    if square:
        e = e * e
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


def adamw_fused_ref(p, m, v, g, *, lr, beta1, beta2, eps, weight_decay,
                    step):
    """One AdamW step on a flat tensor; returns (p', m', v').  The bias
    corrections 1 - beta**step are computed in fp32 from an fp32 ``step``,
    as XLA computes the reference's."""
    g32 = g.to(_f32)
    m_new = beta1 * m.to(_f32) + (1.0 - beta1) * g32
    v_new = beta2 * v.to(_f32) + (1.0 - beta2) * (g32 * g32)
    step = torch.as_tensor(step, dtype=_f32, device=g.device)
    bc1 = 1.0 - beta1 ** step
    bc2 = 1.0 - beta2 ** step
    u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    p_new = p.to(_f32) * (1.0 - lr * weight_decay) - lr * u
    return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)


def adahessian_fused_ref(p, m, v, g, *, lr, beta1, beta2, eps, weight_decay,
                         step):
    """One AdaHessian step: Adam-shaped, v (the EMA of squared Hessian
    estimates, refreshed out of band) read only; returns (p', m')."""
    m_new = beta1 * m.to(_f32) + (1.0 - beta1) * g.to(_f32)
    step = torch.as_tensor(step, dtype=_f32, device=g.device)
    bc1 = 1.0 - beta1 ** step
    bc2 = 1.0 - beta2 ** step
    u = (m_new / bc1) / (torch.sqrt(v.to(_f32) / bc2) + eps)
    p_new = p.to(_f32) * (1.0 - lr * weight_decay) - lr * u
    return p_new.to(p.dtype), m_new.to(m.dtype)


def adahessian_step_refresh_ref(p, m, v, g, e, *, lr, flag, scale, beta1,
                                beta2, eps, weight_decay, step):
    """The AdaHessian step with the flag-gated refresh: when ``flag`` is
    set, v first absorbs ``(scale * e)^2`` (``hessian_ema_ref`` with
    ``square=True``, rounded through v's dtype) and the step reads the new
    v; when clear, v passes through.  Returns (p', m', v')."""
    v_sel = (hessian_ema_ref(v, e, beta2=beta2, scale=scale, square=True)
             if float(flag) > 0.5 else v)
    p2, m2 = adahessian_fused_ref(p, m, v_sel, g, lr=lr, beta1=beta1,
                                  beta2=beta2, eps=eps,
                                  weight_decay=weight_decay, step=step)
    return p2, m2, v_sel


def sign(x):
    """``jnp.sign``: 1, -1, 0 at +-0, and NaN at NaN (``torch.sign`` gives
    0 there)."""
    return torch.where(x.isnan(), x, torch.sign(x))


def lion_fused_ref(p, m, g, *, lr, beta1, beta2, weight_decay):
    """One Lion step: the update is the sign of the beta1 interpolation of
    the OLD m and g; the stored m' is the beta2 EMA.  Returns (p', m').
    The sign is :func:`sign`'s: 0 at +-0, NaN at NaN."""
    g32 = g.to(_f32)
    m32 = m.to(_f32)
    u = sign(beta1 * m32 + (1.0 - beta1) * g32)
    p_new = p.to(_f32) * (1.0 - lr * weight_decay) - lr * u
    m_new = beta2 * m32 + (1.0 - beta2) * g32
    return p_new.to(p.dtype), m_new.to(m.dtype)


def signgd_fused_ref(p, m, g, *, lr, beta1, weight_decay):
    """One momentum SignSGD step (the paper's 'Clip' ablation): m' = beta1
    m + (1-beta1) g, p' = p (1 - lr wd) - lr sign(m').  Returns (p',
    m')."""
    m_new = beta1 * m.to(_f32) + (1.0 - beta1) * g.to(_f32)
    p_new = p.to(_f32) * (1.0 - lr * weight_decay) - lr * sign(m_new)
    return p_new.to(p.dtype), m_new.to(m.dtype)


def sgd_fused_ref(p, m, g, *, lr, momentum):
    """One SGD step with heavy-ball momentum and no weight decay: m' = mu
    m + g, p' = p - lr m'.  Returns (p', m')."""
    m_new = momentum * m.to(_f32) + g.to(_f32)
    p_new = p.to(_f32) - lr * m_new
    return p_new.to(p.dtype), m_new.to(m.dtype)


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


def flash_attention_jvp_ref(q, k, v, dq, dk, dv, *, causal=True, scale=None,
                            window=None, softcap=None, q_offset=0):
    """Forward-mode oracle of the attention output's tangent, all fp32:
    ``do = (p * dz) @ v - rowsum(p * dz) * o + p @ dv`` with ``dz = dcap *
    scale * (dq k^T + q dk^T)``; returns ``do`` in q's dtype."""
    B, H, Sq, hd = q.shape
    G = H // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    s_raw, _, p = _attn_probs_ref(q, k, causal=causal, scale=scale,
                                  window=window, softcap=softcap,
                                  q_offset=q_offset)
    kx = k.repeat_interleave(G, dim=1).to(_f32)
    vx = v.repeat_interleave(G, dim=1).to(_f32)
    dkx = dk.repeat_interleave(G, dim=1).to(_f32)
    dvx = dv.repeat_interleave(G, dim=1).to(_f32)
    q32, dq32 = q.to(_f32), dq.to(_f32)
    o32 = torch.einsum("bhqk,bhkd->bhqd", p, vx)
    dz = (torch.einsum("bhqd,bhkd->bhqk", dq32, kx)
          + torch.einsum("bhqd,bhkd->bhqk", q32, dkx)) * scale
    if softcap is not None:
        dz = dz * (1.0 - torch.tanh(s_raw / softcap) ** 2)
    pdz = p * dz
    do = (torch.einsum("bhqk,bhkd->bhqd", pdz, vx)
          - pdz.sum(-1, keepdim=True) * o32
          + torch.einsum("bhqk,bhkd->bhqd", p, dvx))
    return do.to(q.dtype)
