"""Per-tensor harness over the engine kernels: the counterpart of
``repro/kernels/ops.py``, for tests and timings.

Each tensor of a tree is flattened to fp32, zero-padded to a multiple of
``block``, run through the wrapper of ``kernels/sophia_update.py`` (the
CUDA kernel on the GPU, its plain version on the CPU) and cut back to its
shape and dtype.  The pad is a fixed point of every update (p = m = h = g
= 0 stays 0 and counts no clip).  The engine (``core/engine.py``) does not
go through here: it ravels the whole tree into block-padded shards once.
"""
from __future__ import annotations

import torch

from ..core.types import Tree, flat_tensors, tree_unflatten
from .sophia_update import (BLOCK, adamw_fused_block, hessian_ema_block,
                            sophia_fused_block)

_f32 = torch.float32


def _flat_pad(x: torch.Tensor, block: int) -> torch.Tensor:
    flat = x.reshape(-1).to(_f32)
    pad = (-flat.numel()) % block
    return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat


def _unpad(flat: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return flat[:like.numel()].reshape(like.shape).to(like.dtype)


def sophia_fused_apply(params: Tree, m: Tree, h: Tree, grads: Tree, *, lr,
                       beta1: float, gamma: float, eps: float,
                       weight_decay: float, clip_threshold: float = 1.0,
                       block: int = BLOCK):
    """The Sophia step over a whole tree.  Returns (new_params, new_m,
    clip_fraction)."""
    new_p, new_m, clipped, total = [], [], [], 0
    for p_, m_, h_, g_ in zip(flat_tensors(params), flat_tensors(m),
                              flat_tensors(h), flat_tensors(grads)):
        p2, m2, nclip = sophia_fused_block(
            _flat_pad(p_, block), _flat_pad(m_, block), _flat_pad(h_, block),
            _flat_pad(g_, block), lr, beta1=beta1, gamma=gamma, eps=eps,
            weight_decay=weight_decay, clip_threshold=clip_threshold,
            block=block)
        new_p.append(_unpad(p2, p_))
        new_m.append(_unpad(m2, m_))
        clipped.append(nclip.to(_f32).sum())
        total += p_.numel()
    clip_fraction = (sum(clipped) / total).to(_f32)
    return (tree_unflatten(params, new_p), tree_unflatten(m, new_m),
            clip_fraction)


def hessian_ema_apply(h: Tree, est: Tree, *, beta2: float, scale=1.0,
                      block: int = BLOCK) -> Tree:
    """The Hessian-EMA refresh (Algorithm 3 line 9) over a whole tree."""
    out = [_unpad(hessian_ema_block(_flat_pad(h_, block),
                                    _flat_pad(e_, block), beta2=beta2,
                                    scale=scale, block=block), h_)
           for h_, e_ in zip(flat_tensors(h), flat_tensors(est))]
    return tree_unflatten(h, out)


def adamw_fused_apply(params: Tree, m: Tree, v: Tree, grads: Tree, *, lr,
                      step, beta1: float, beta2: float, eps: float,
                      weight_decay: float, block: int = BLOCK):
    """The AdamW step over a whole tree.  Returns (new_params, new_m,
    new_v)."""
    outs = ([], [], [])
    for p_, m_, v_, g_ in zip(flat_tensors(params), flat_tensors(m),
                              flat_tensors(v), flat_tensors(grads)):
        res = adamw_fused_block(
            _flat_pad(p_, block), _flat_pad(m_, block), _flat_pad(v_, block),
            _flat_pad(g_, block), lr, step, beta1=beta1, beta2=beta2,
            eps=eps, weight_decay=weight_decay, block=block)
        for out, flat, like in zip(outs, res, (p_, m_, v_)):
            out.append(_unpad(flat, like))
    return tuple(tree_unflatten(tree, out)
                 for tree, out in zip((params, m, v), outs))
