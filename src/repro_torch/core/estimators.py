"""The GNB diagonal-Hessian estimator (Algorithm 2, paper Section 2.3):
the counterpart of ``repro/core/estimators.py``, cut to the logits-free
route the trainer takes with ``fused_loss=True``.

``gnb_ghat_flat_from_loss`` takes a model-level sampled-label loss whose
labels ŷ ~ softmax(logits) are drawn inside the fused CE forward sweep
(``models/loss.py:lm_loss_sampled``), differentiates it and ravels ĝ into
the engine's flat fp32 shards.  The trainer squares the shards and hands
them with B = the sweep's valid-position count to the engine's fused
Hessian EMA.  The Hutchinson and empirical-Fisher estimators come with a
later slice.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from .engine import ShardLayout, ravel_shards
from .types import Tree, flat_tensors, tree_unflatten


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
