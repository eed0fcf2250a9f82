"""The baseline optimizers of the paper's comparison (Section 3.1) as
per-leaf transformations: the counterpart of ``repro/core/baselines.py``.

AdamW (Loshchilov & Hutter), Lion (Chen et al. 2023), SignGD with momentum
(the paper's simplified Adam, the "Clip" ablation), AdaHessian (Yao et al.
2021: the EMA of *squared* Hessian estimates in the denominator) and plain
SGD, on the protocol of :mod:`repro_torch.core.types`.  A sign is
``jnp.sign``'s: NaN stays NaN (``kernels/ref.py:sign``).
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from ..kernels.ref import sign
from .sophia import _device, _lr_at
from .types import (GradientTransformation, HessianAwareTransformation,
                    Schedule, Tree, tree_map, tree_zeros_like)

_f32 = torch.float32


def _count(params):
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def _ema(beta, m_, g):
    return beta * m_ + (1 - beta) * g.to(_f32)


class AdamWState(NamedTuple):
    count: torch.Tensor
    m: Tree
    v: Tree


def adamw(learning_rate: Union[float, Schedule], *, beta1: float = 0.9,
          beta2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> GradientTransformation:
    """AdamW with the paper's LM defaults (b1=0.9, b2=0.95, wd=0.1)."""

    def init(params):
        return AdamWState(_count(params), tree_zeros_like(params, _f32),
                          tree_zeros_like(params, _f32))

    def update(grads, state, params=None):
        count = state.count + 1
        m = tree_map(lambda m_, g: _ema(beta1, m_, g), state.m, grads)
        v = tree_map(lambda v_, g: beta2 * v_ + (1 - beta2)
                     * g.to(_f32).square(), state.v, grads)
        c = count.to(_f32)
        bc1 = 1 - beta1 ** c
        bc2 = 1 - beta2 ** c
        lr = _lr_at(learning_rate, state.count)
        updates = tree_map(
            lambda m_, v_, p: -lr * ((m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
                                     + weight_decay * p.to(_f32)),
            m, v, params)
        return updates, AdamWState(count, m, v)

    return GradientTransformation(init=init, update=update)


class LionState(NamedTuple):
    count: torch.Tensor
    m: Tree


def lion(learning_rate: Union[float, Schedule], *, beta1: float = 0.95,
         beta2: float = 0.98, weight_decay: float = 0.2
         ) -> GradientTransformation:
    """Lion (the paper's LM tuning: b1=0.95, b2=0.98, wd=0.2)."""

    def init(params):
        return LionState(_count(params), tree_zeros_like(params, _f32))

    def update(grads, state, params=None):
        lr = _lr_at(learning_rate, state.count)
        updates = tree_map(
            lambda m_, g, p: -lr * (sign(_ema(beta1, m_, g))
                                    + weight_decay * p.to(_f32)),
            state.m, grads, params)
        m = tree_map(lambda m_, g: _ema(beta2, m_, g), state.m, grads)
        return updates, LionState(state.count + 1, m)

    return GradientTransformation(init=init, update=update)


class SignGDState(NamedTuple):
    count: torch.Tensor
    m: Tree


def signgd(learning_rate: Union[float, Schedule], *, beta1: float = 0.96,
           weight_decay: float = 0.0) -> GradientTransformation:
    """Stochastic momentum SignSGD: the 'Clip' ablation of Fig 8c and what
    Sophia reduces to where the curvature is not trusted."""

    def init(params):
        return SignGDState(_count(params), tree_zeros_like(params, _f32))

    def update(grads, state, params=None):
        m = tree_map(lambda m_, g: _ema(beta1, m_, g), state.m, grads)
        lr = _lr_at(learning_rate, state.count)
        updates = tree_map(
            lambda m_, p: -lr * (sign(m_) + weight_decay * p.to(_f32)),
            m, params)
        return updates, SignGDState(state.count + 1, m)

    return GradientTransformation(init=init, update=update)


class AdaHessianState(NamedTuple):
    count: torch.Tensor
    m: Tree
    v: Tree  # EMA of squared Hessian-diagonal estimates


def adahessian(learning_rate: Union[float, Schedule], *, beta1: float = 0.92,
               beta2: float = 0.99, eps: float = 1e-8,
               weight_decay: float = 0.0) -> HessianAwareTransformation:
    """AdaHessian: Adam-shaped, the denominator sqrt(EMA(hhat^2)).  The
    caller feeds it the same Hutchinson estimates as Sophia-H (the paper
    tunes b1=0.92, b2=0.99)."""

    def init(params):
        return AdaHessianState(_count(params), tree_zeros_like(params, _f32),
                               tree_zeros_like(params, _f32))

    def update(grads, state, params=None):
        count = state.count + 1
        m = tree_map(lambda m_, g: _ema(beta1, m_, g), state.m, grads)
        c = count.to(_f32)
        bc1 = 1 - beta1 ** c
        bc2 = 1 - beta2 ** c
        lr = _lr_at(learning_rate, state.count)
        updates = tree_map(
            lambda m_, v_, p: -lr * ((m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
                                     + weight_decay * p.to(_f32)),
            m, state.v, params)
        return updates, AdaHessianState(count, m, state.v)

    def update_hessian(hess, state):
        v = tree_map(lambda v_, h: beta2 * v_ + (1 - beta2)
                     * h.to(_f32).square(), state.v, hess)
        return state._replace(v=v)

    return HessianAwareTransformation(init=init, update=update,
                                      update_hessian=update_hessian)


class SGDState(NamedTuple):
    count: torch.Tensor
    m: Tree


def sgd(learning_rate: Union[float, Schedule], *, momentum: float = 0.0
        ) -> GradientTransformation:
    def init(params):
        return SGDState(_count(params), tree_zeros_like(params, _f32))

    def update(grads, state, params=None):
        del params
        m = tree_map(lambda m_, g: momentum * m_ + g.to(_f32), state.m, grads)
        lr = _lr_at(learning_rate, state.count)
        return (tree_map(lambda m_: -lr * m_, m),
                SGDState(state.count + 1, m))

    return GradientTransformation(init=init, update=update)
