"""The training state: the counterpart of ``repro/train/train_state.py``,
and the reference's PRNG key in numpy."""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

from ..core.clipping import ClipState
from ..core.engine import EngineState

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


class TrainState(NamedTuple):
    step: int                  # steps taken
    params: Any                # models.Transformer (updated in place)
    opt_state: EngineState     # flat dtype-homogeneous optimizer shards
    clip_state: ClipState      # global-norm clip telemetry (paper Fig 7a)
    rng: Tuple[int, int]       # the key's two uint32 words, the reference's
    #                            ``split(PRNGKey(seed))[1]``; the per-step
    #                            noise streams derive from them
    comp_state: Any = ()       # distributed.FlatCompressionState: the
    #                            error feedback (this rank's segments) with
    #                            compress_grads, else ()


def threefry2x32(key: Tuple[int, int], x0: int, x1: int) -> Tuple[int, int]:
    """The Threefry-2x32 block cipher (20 rounds) of one counter pair under
    ``key``, on uint32 values held in Python ints: JAX's ``threefry2x32``
    bit for bit."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def train_key(seed: int) -> Tuple[int, int]:
    """The reference trainer's rng leaf for ``seed``:
    ``jax.random.split(jax.random.PRNGKey(seed))[1]`` (threefry, the
    partitionable split JAX uses by default), as two ints."""
    return threefry2x32(((seed >> 32) & _M32, seed & _M32), 0, 1)
