"""Carry parameters and optimizer state of the JAX reference across to
the port through numpy.

``torch.Generator`` cannot reproduce ``jax.random`` draws, so the tests that
hold the port against the reference build the weights once with the
reference's ``init_params`` and hand them over as numpy arrays, whatever
leaves the config gives the tree (``embed/pos`` with learned positions,
``embed/unembed`` when untied, ``mlp/w_gate`` with SwiGLU).  The engine's
flat shards share the reference's layout (``core/engine.py:build_layout``
over the same sorted leaves), so its state carries over as a plain copy.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.engine import EngineState, ShardLayout, dtype_name
from .models.common import ModelConfig
from .models.transformer import Transformer


def _array_to_torch(arr, device) -> torch.Tensor:
    arr = np.array(arr, copy=True)
    if arr.dtype.name == "bfloat16":      # ml_dtypes' bf16: carry the bits
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {name: _to_torch(leaf, device) for name, leaf in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(leaf, device) for leaf in tree]
    return _array_to_torch(tree, device)


def params_from_jax(np_params, cfg: ModelConfig, device="cpu") -> Transformer:
    """The reference's ``init_params`` tree as numpy arrays (for example
    ``jax.tree.map(np.asarray, params)``) -> the port's module.  The stacked
    leaves under ``"layers"`` carry a leading ``n_layers`` axis; they are
    split into one parameter set per layer."""
    stacked = np_params["layers"]

    def layer(i):
        return {group: {name: leaf[i] for name, leaf in leaves.items()}
                for group, leaves in stacked.items()}

    tree = {"embed": np_params["embed"],
            "final_norm": np_params["final_norm"],
            "layers": [layer(i) for i in range(cfg.n_layers)]}
    return Transformer(cfg, _to_torch(tree, device))


def engine_state_from_jax(np_state, layout: ShardLayout,
                          device="cpu") -> EngineState:
    """The reference's ``EngineState`` with numpy leaves (for example
    ``jax.tree.map(np.asarray, state)``) -> the port's.  The flat m/h
    shards are copied as they are; ``layout`` (the port engine's layout of
    the same parameters) checks their sizes and dtypes."""
    def shards(name):
        out = tuple(_array_to_torch(a, device) for a in getattr(np_state, name))
        if (tuple(t.shape[0] for t in out) != layout.shard_sizes
                or len(out) != layout.n_shards):
            raise ValueError(f"{name} shards {[t.shape for t in out]} do not "
                             f"match the layout {layout.shard_sizes}")
        return out

    m, h = shards("m"), shards("h")
    if len({dtype_name(t.dtype) for t in m + h}) != 1:
        raise ValueError("m and h shards must share one dtype")
    return EngineState(
        count=_array_to_torch(np.asarray(np_state.count, np.int32), device),
        m=m, h=h,
        hess_count=_array_to_torch(np.asarray(np_state.hess_count, np.int32),
                                   device),
        clip_fraction=_array_to_torch(
            np.asarray(np_state.clip_fraction, np.float32), device))
