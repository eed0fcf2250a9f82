"""Diagonal-Hessian estimators (paper Section 2.3): the counterpart of
``repro/core/estimators.py``, cut to the routes the trainer takes with
``fused_loss=True``.

* GNB (Algorithm 2): ``gnb_ghat_flat_from_loss`` takes a model-level
  sampled-label loss whose labels ŷ ~ softmax(logits) are drawn inside the
  fused CE forward sweep (``models/loss.py:lm_loss_sampled``),
  differentiates it and ravels ĝ into the engine's flat fp32 shards.  The
  trainer squares the shards and hands them with B = the sweep's
  valid-position count to the engine's fused Hessian EMA.
* Hutchinson (Algorithm 1): u ⊙ (H u) with u ~ N(0, I), unbiased for
  diag(H).  H u is taken forward-over-reverse, as the reference takes it
  (``jax.jvp`` of ``jax.grad``): ``torch.func.jvp`` of ``torch.func.grad``
  of a loss written as a function of the parameter tensors (the trainer
  builds it with ``torch.func.functional_call``).  The loss runs on the
  loss and attention twins (``fused_jvp``, ``flash_jvp``), whose backward
  and tangent rules are plain PyTorch.
* Empirical Fisher (the paper's Fig. 8b ablation): the squared gradient of
  the TRUE-label loss, B = the sub-batch's positions.

Each ``*_flat`` form emits the estimate as the engine's flat fp32 shards.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from .engine import ShardLayout, ravel_shards, unravel_shards
from .types import Tree, flat_tensors, tree_leaves, tree_unflatten

_f32 = torch.float32


def subsample_batch(batch: dict, n: int) -> dict:
    """First-n sub-batch for the estimator (paper Section 3.1)."""
    return {key: value[:n] for key, value in batch.items()}


def gnb_ghat_flat_from_loss(
    sampled_loss_fn: Callable[[], Tuple[torch.Tensor, torch.Tensor]],
    params: Tree,
    layout: ShardLayout,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """GNB ``(ghat shards, B)``: ``sampled_loss_fn() -> (mean_nll,
    n_valid)`` runs the model on ``params`` (a parameter tree) and draws
    its own labels; ĝ is its gradient with respect to every tensor of
    ``params``, raveled to flat fp32 shards; B is ``n_valid`` in fp32."""
    loss, n_valid = sampled_loss_fn()
    tensors = flat_tensors(params)
    grads = torch.autograd.grad(loss, tensors)
    g_sh = ravel_shards(layout, tree_unflatten(params, grads),
                        dtype=torch.float32)
    return g_sh, n_valid.to(torch.float32)


def _hvp(loss_fn: Callable[[Sequence[torch.Tensor]], torch.Tensor],
         tensors: List[torch.Tensor],
         u: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """H u, forward-over-reverse: the tangent along ``u`` of the gradient
    of ``loss_fn(tensors)``, one tensor per entry of ``tensors``; a tensor
    the loss does not depend on (a zero row of H) gets zeros."""
    primals = tuple(t.detach() for t in tensors)
    _, hv = torch.func.jvp(torch.func.grad(loss_fn), (primals,),
                           (tuple(u),))
    return list(hv)


class _Call(torch.nn.Module):
    """``fn(module)`` as a module's forward, for ``functional_call``."""

    def __init__(self, module: torch.nn.Module, fn: Callable):
        super().__init__()
        self.module = module
        self.fn = fn

    def forward(self):
        return self.fn(self.module)


def functional_loss(module: torch.nn.Module,
                    tensors: Sequence[torch.Tensor],
                    fn: Callable[[torch.nn.Module], torch.Tensor]
                    ) -> Callable[[Sequence[torch.Tensor]], torch.Tensor]:
    """``fn(module)`` as a function of the values of ``tensors``, which
    are parameters of ``module`` (each once): ``loss(values)`` runs ``fn``
    with ``torch.func.functional_call`` swapping them in, the form that
    ``torch.func.grad`` differentiates."""
    names = {id(p): f"module.{n}" for n, p in module.named_parameters()}
    keys = [names[id(t)] for t in tensors]
    call = _Call(module, fn)

    def loss(values: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.func.functional_call(call, dict(zip(keys, values)), ())
    return loss


def hutchinson_estimator(
        loss_fn: Callable[[Sequence[torch.Tensor]], torch.Tensor],
        params: Tree, u: Tree) -> Tree:
    """u ⊙ (H u) as a tree of fp32 tensors shaped like ``params``:
    ``loss_fn(tensors)`` is the scalar loss on the estimator sub-batch as a
    function of the tensors of ``params`` (in :func:`flat_tensors` order)
    and ``u`` a probe tree shaped like ``params`` in its dtypes (``u ~ N(0,
    I)`` makes the product an unbiased estimate of diag(H))."""
    tensors = flat_tensors(params)
    probe = flat_tensors(u)
    hv = _hvp(loss_fn, tensors, probe)
    return tree_unflatten(params, [(v * h).to(_f32)
                                   for v, h in zip(probe, hv)])


def hutchinson_estimator_flat(
        loss_fn: Callable[[Sequence[torch.Tensor]], torch.Tensor],
        params: Tree, u_sh: Sequence[torch.Tensor], layout: ShardLayout
) -> Tuple[torch.Tensor, ...]:
    """:func:`hutchinson_estimator` on flat shards: the probe shards
    ``u_sh`` are unraveled through the layout (cast to the leaf dtypes)
    for the HVP, and u ⊙ (H u) is raveled back to fp32 shards, so the tail
    pad, whose probe noise no parameter sees, stays zero."""
    values = unravel_shards(layout, tuple(u_sh))
    probe = [part for leaf, value in zip(tree_leaves(params), values)
             for part in (value.unbind(0) if isinstance(leaf, (list, tuple))
                          else (value,))]
    hv = _hvp(loss_fn, flat_tensors(params), probe)
    prod = [v.to(_f32) * h.to(_f32) for v, h in zip(probe, hv)]
    return ravel_shards(layout, tree_unflatten(params, prod), dtype=_f32)


def empirical_fisher_ghat_flat(loss_fn: Callable[[], torch.Tensor],
                               params: Tree, layout: ShardLayout
                               ) -> Tuple[torch.Tensor, ...]:
    """The gradient of the TRUE-label loss ``loss_fn()`` as flat fp32
    shards, before squaring."""
    grads = torch.autograd.grad(loss_fn(), flat_tensors(params))
    return ravel_shards(layout, tree_unflatten(params, grads), dtype=_f32)


def empirical_fisher_estimator_flat(loss_fn: Callable[[], torch.Tensor],
                                    params: Tree, layout: ShardLayout
                                    ) -> Tuple[torch.Tensor, ...]:
    """E-F's g ⊙ g as flat fp32 shards; the batch factor B is left to
    the engine's Hessian EMA (its ``scale``), as GNB's is."""
    return tuple(g * g for g in
                 empirical_fisher_ghat_flat(loss_fn, params, layout))
