"""Plain PyTorch copies of the reference's optimizer oracles
(``repro/kernels/ref.py``): the Sophia step and the step with the
Hessian-EMA refresh fused in, on one flat tensor.  They are the optimizer
engine's reference backend, the default of the reference trainer
(``fused_kernel=False``); the Pallas engine kernels that compute the same
functions (``sophia_update.py``, rows 2-4 of the kernel table) come with
the engine-kernel slice."""
from __future__ import annotations

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
