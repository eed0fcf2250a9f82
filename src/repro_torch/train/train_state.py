"""The training state: the counterpart of ``repro/train/train_state.py``."""
from __future__ import annotations

from typing import Any, NamedTuple

from ..core.clipping import ClipState
from ..core.engine import EngineState


class TrainState(NamedTuple):
    step: int                  # steps taken
    params: Any                # models.Transformer (updated in place)
    opt_state: EngineState     # flat dtype-homogeneous optimizer shards
    clip_state: ClipState      # global-norm clip telemetry (paper Fig 7a)
    rng: int                   # the seed the per-step noise streams derive
    #                            from (the reference holds a JAX key here)
    comp_state: tuple = ()     # gradient-compression state (not ported)
