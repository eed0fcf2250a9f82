"""Global-norm gradient clipping with trigger telemetry (paper Fig 7a): the
counterpart of ``repro/core/clipping.py``.

The paper clips every optimizer's gradient at norm 1.0 and reports how
often the clip triggers; the state keeps the running trigger count and the
last pre-clip norm for the trainer's metrics."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .types import GradientTransformation, flat_tensors, global_norm, \
    tree_map


class ClipState(NamedTuple):
    count: torch.Tensor       # int32: steps seen
    triggers: torch.Tensor    # int32: cumulative number of clipped steps
    last_norm: torch.Tensor   # fp32: the last step's pre-clip norm


def clip_by_global_norm(max_norm: float = 1.0) -> GradientTransformation:
    """``init(params) -> ClipState`` on the params' device; ``update(grads,
    state, params=None) -> (grads, state)`` with the grads scaled to fp32
    norm <= ``max_norm``."""

    def init(params):
        tensors = flat_tensors(params)
        device = tensors[0].device if tensors else "cpu"
        return ClipState(torch.zeros((), dtype=torch.int32, device=device),
                         torch.zeros((), dtype=torch.int32, device=device),
                         torch.zeros((), dtype=torch.float32, device=device))

    def update(grads, state, params=None):
        del params
        norm = global_norm(grads)
        trigger = norm > max_norm
        scale = torch.where(trigger, max_norm / (norm + 1e-16),
                            torch.ones_like(norm))
        grads = tree_map(lambda g: g.to(torch.float32) * scale, grads)
        return grads, ClipState(state.count + 1,
                                state.triggers + trigger.to(torch.int32),
                                norm)

    return GradientTransformation(init=init, update=update)


def clip_trigger_rate(state: ClipState) -> torch.Tensor:
    return state.triggers / torch.clamp_min(state.count, 1)
