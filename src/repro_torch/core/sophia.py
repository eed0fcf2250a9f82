"""Sophia, Second-order Clipped Stochastic Optimization (Algorithm 3), as
per-leaf transformations: the counterpart of ``repro/core/sophia.py``.

    m_t = beta1 * m_{t-1} + (1 - beta1) * g_t
    if t % k == 1:  h_t = beta2 * h_{t-k} + (1 - beta2) * hhat_t   (out of band)
    theta <- theta - lr * weight_decay * theta                      (decoupled WD)
    theta <- theta - lr * clip(m_t / max(gamma * h_t, eps), 1)

The Hessian EMA is ``update_hessian``, which the caller invokes every k
steps with a fresh estimate from :mod:`repro_torch.core.estimators`
(Algorithm 3 lines 7-11).  The state carries ``clip_fraction``, the share
of coordinates whose update hit the clip, the quantity the paper tunes
``gamma`` by (Section 3.1, Figure 9a).

The trainer runs the same update over flat shards (``core/engine.py``);
these functions work leaf by leaf on a parameter tree (``core/types.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from .types import (GradientTransformation, HessianAwareTransformation,
                    Schedule, Tree, flat_tensors, tree_map,
                    tree_unflatten, tree_zeros_like)

_f32 = torch.float32


class SophiaState(NamedTuple):
    count: torch.Tensor          # int32: step counter t
    m: Tree                      # EMA of gradients
    h: Tree                      # EMA of diagonal-Hessian estimates
    hess_count: torch.Tensor     # int32: Hessian refreshes so far
    clip_fraction: torch.Tensor  # fp32: share of clipped coordinates, last step


def _device(params: Tree):
    tensors = flat_tensors(params)
    return tensors[0].device if tensors else "cpu"


def _lr_at(lr, step):
    return lr(step) if callable(lr) else lr


def scale_by_sophia(beta1: float = 0.96, beta2: float = 0.99,
                    gamma: float = 0.05, eps: float = 1e-12,
                    clip_threshold: float = 1.0,
                    state_dtype: torch.dtype = _f32
                    ) -> HessianAwareTransformation:
    """The preconditioning core of Sophia, without lr or weight decay (see
    :func:`sophia`)."""

    def init(params):
        dev = _device(params)
        return SophiaState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            m=tree_zeros_like(params, state_dtype),
            h=tree_zeros_like(params, state_dtype),
            hess_count=torch.zeros((), dtype=torch.int32, device=dev),
            clip_fraction=torch.zeros((), dtype=_f32, device=dev))

    def update(grads, state, params=None):
        del params
        m = tree_map(lambda m_, g: beta1 * m_ + (1.0 - beta1) * g.to(m_.dtype),
                     state.m, grads)
        updates, clipped, total = [], None, 0
        for m_, h_ in zip(flat_tensors(m), flat_tensors(state.h)):
            raw = m_ / torch.clamp_min(gamma * h_, eps)
            updates.append(-raw.clamp(-clip_threshold, clip_threshold))
            # counted in fp32: a model may hold more than 2^31 parameters
            n = (raw.abs() >= clip_threshold).sum(dtype=_f32)
            clipped = n if clipped is None else clipped + n
            total += m_.numel()
        new_state = SophiaState(
            count=state.count + 1, m=m, h=state.h,
            hess_count=state.hess_count,
            clip_fraction=(clipped / float(total)).to(_f32))
        return tree_unflatten(m, updates), new_state

    def update_hessian(hess_estimate, state):
        """EMA per eq. (5): h <- beta2 * h + (1 - beta2) * hhat."""
        h = tree_map(lambda h_, e: beta2 * h_ + (1.0 - beta2) * e.to(h_.dtype),
                     state.h, hess_estimate)
        return state._replace(h=h, hess_count=state.hess_count + 1)

    return HessianAwareTransformation(init=init, update=update,
                                      update_hessian=update_hessian)


class ScaleByLrState(NamedTuple):
    count: torch.Tensor


def scale_by_learning_rate(lr: Union[float, Schedule]
                           ) -> GradientTransformation:
    def init(params):
        return ScaleByLrState(count=torch.zeros((), dtype=torch.int32,
                                                device=_device(params)))

    def update(updates, state, params=None):
        del params
        step_lr = _lr_at(lr, state.count)
        return (tree_map(lambda u: step_lr * u, updates),
                ScaleByLrState(count=state.count + 1))

    return GradientTransformation(init=init, update=update)


class WeightDecayState(NamedTuple):
    count: torch.Tensor


def add_decayed_weights(weight_decay: float,
                        lr: Union[float, Schedule, None] = None
                        ) -> GradientTransformation:
    """Decoupled weight decay (AdamW-style): update -= lr * wd * theta.
    With ``lr`` given the decay is pre-multiplied by the schedule, so that
    it can sit after the lr scaling (Sophia line 12 decays with eta_t)."""

    def init(params):
        return WeightDecayState(count=torch.zeros((), dtype=torch.int32,
                                                  device=_device(params)))

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("weight decay needs params")
        step_lr = _lr_at(lr, state.count) if lr is not None else 1.0
        updates = tree_map(
            lambda u, p: u - step_lr * weight_decay * p.to(u.dtype),
            updates, params)
        return updates, WeightDecayState(count=state.count + 1)

    return GradientTransformation(init=init, update=update)


def sophia(learning_rate: Union[float, Schedule], *, beta1: float = 0.96,
           beta2: float = 0.99, gamma: float = 0.05, eps: float = 1e-12,
           weight_decay: float = 0.2, clip_threshold: float = 1.0,
           state_dtype: torch.dtype = _f32) -> HessianAwareTransformation:
    """The full Sophia optimizer (Algorithm 3), the estimator supplied by
    the caller::

        opt = sophia(lr_schedule, gamma=0.05)             # Sophia-G defaults
        state = opt.init(params)
        # every step:
        updates, state = opt.update(grads, state, params)
        params = apply_updates(params, updates)
        # every k steps (Algorithm 3 line 7):
        state = opt.update_hessian(gnb_estimator(...), state)
    """
    core = scale_by_sophia(beta1=beta1, beta2=beta2, gamma=gamma, eps=eps,
                           clip_threshold=clip_threshold,
                           state_dtype=state_dtype)

    def update(grads, state, params=None):
        updates, state = core.update(grads, state, params)
        # the lr of the pre-increment step index
        step_lr = _lr_at(learning_rate, state.count - 1)
        # decoupled weight decay, then the clipped update, scaled by lr
        updates = tree_map(
            lambda u, p: step_lr * (u - weight_decay * p.to(u.dtype)),
            updates, params)
        return updates, state

    return HessianAwareTransformation(init=core.init, update=update,
                                      update_hessian=core.update_hessian)


def sophia_h(learning_rate, *, gamma: float = 0.01, weight_decay: float = 0.2,
             **kw) -> HessianAwareTransformation:
    """Sophia with the paper's Sophia-H default gamma=0.01."""
    return sophia(learning_rate, gamma=gamma, weight_decay=weight_decay, **kw)


def sophia_g(learning_rate, *, gamma: float = 0.05, weight_decay: float = 0.2,
             **kw) -> HessianAwareTransformation:
    """Sophia with the paper's Sophia-G default gamma=0.05."""
    return sophia(learning_rate, gamma=gamma, weight_decay=weight_decay, **kw)
