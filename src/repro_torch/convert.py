"""Carry parameters and optimizer state of the JAX reference across to
the port through numpy.

``torch.Generator`` cannot reproduce ``jax.random`` draws, so the tests that
hold the port against the reference build the weights once with the
reference's ``init_params`` and hand them over as numpy arrays, whatever
leaves the config gives the tree (``embed/pos`` with learned positions,
``embed/unembed`` when untied, ``mlp/w_gate`` with SwiGLU, the top-level
``patch_proj`` with patch-embedding inputs, the nested ``moe`` group of a
MoE layer, the RWKV family's ``tm``/``cm`` groups, the Griffin family's
``groups`` and ``tail``, the encoder-decoder's ``frame_proj``,
``encoder``, ``enc_norm`` and ``decoder``).  The engine's
flat shards share the reference's layout (``core/engine.py:build_layout``
over the same sorted leaves), so its state carries over as a plain copy.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.engine import EngineState, ShardLayout, dtype_name
from .models.common import ModelConfig
from .models.encdec import EncDec
from .models.griffin import Griffin, n_groups, n_tail
from .models.rwkv import RWKV
from .models.transformer import Transformer, unstack_layers

# each family's top-level parameter groups, in the reference's order
TOP_LEVEL_KEYS = {"dense": ("embed", "final_norm", "layers", "patch_proj"),
                  "moe": ("embed", "final_norm", "layers", "patch_proj"),
                  "rwkv": ("embed", "final_norm", "layers"),
                  "griffin": ("embed", "final_norm", "groups", "tail"),
                  "encdec": ("embed", "frame_proj", "encoder", "enc_norm",
                             "decoder", "final_norm")}


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


def _leading(tree) -> set:
    return {n for v in tree.values()
            for n in (_leading(v) if isinstance(v, dict) else {v.shape[0]})}


def unstack(stacked, n: int) -> list:
    """A tree of arrays with a leading axis of ``n`` -> ``n`` trees; a
    leaf with another leading axis raises."""
    if _leading(stacked) - {n}:
        raise ValueError(f"stacked leaves lead with {sorted(_leading(stacked))}"
                         f" layers, not {n}")

    def take(tree, i):
        return {name: take(leaf, i) if isinstance(leaf, dict) else leaf[i]
                for name, leaf in tree.items()}
    return [take(stacked, i) for i in range(n)]


def params_from_jax(np_params, cfg: ModelConfig, device="cpu"):
    """The reference's ``init_params`` tree as numpy arrays (for example
    ``jax.tree.map(np.asarray, params)``) -> the port's module of the
    config's family (``Transformer``, ``RWKV``, ``Griffin`` or
    ``EncDec``).  The
    stacked leaves under ``"layers"`` carry a leading ``n_layers`` axis;
    they are split into one parameter set per layer
    (``transformer.unstack_layers``: with ``moe_every == 2`` they are
    stacked over the (dense, MoE) groups).  Griffin's ``groups`` lead with
    the group axis and ``tail`` with the tail layers': each is split into
    a list, one tree a group or tail layer (``Griffin.param_tree`` stacks
    them back as lists, the checkpoint as arrays); so are the
    encoder-decoder's ``encoder`` and ``decoder``, by their layer counts.
    A key the port does not know raises, rather than being dropped: a
    top-level one here, one inside a layer (or a shape) in the module."""
    keys = TOP_LEVEL_KEYS.get(cfg.family, ())
    unknown = sorted(set(np_params) - set(keys))
    if unknown:
        raise ValueError(f"reference params have top-level keys the port "
                         f"does not carry: {unknown}")
    if cfg.family == "griffin":
        tree = dict(np_params,
                    groups=unstack(np_params["groups"], n_groups(cfg)),
                    tail=(unstack(np_params["tail"], n_tail(cfg))
                          if "tail" in np_params else []))
        return Griffin(cfg, _to_torch(tree, device))
    if cfg.family == "encdec":
        tree = dict(np_params,
                    encoder=unstack(np_params["encoder"],
                                    cfg.n_encoder_layers),
                    decoder=unstack(np_params["decoder"], cfg.n_layers))
        return EncDec(cfg, _to_torch(tree, device))
    tree = dict(np_params, layers=unstack_layers(cfg, np_params["layers"]))
    module = RWKV if cfg.family == "rwkv" else Transformer
    return module(cfg, _to_torch(tree, device))


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


def shard_params(full, grid, cfg: ModelConfig = None):
    """One rank's parameters on ``grid`` (``distributed/sharding.py``):
    ``full`` a port module or the reference's numpy tree (with ``cfg``),
    sliced along each leaf's model entry to the rank's block.  The module
    carries its placement tree as ``placements`` (computed on the whole
    shapes) for the trainer and the checkpoints.  Raises ``ValueError``
    where the model axis does not divide a leaf that the layers split
    (``sharding.check_splits``)."""
    from .distributed.sharding import (check_splits, partition_params,
                                       shard_tree)
    from .models.transformer import unstack_layers
    if not hasattr(full, "param_tree"):
        full = params_from_jax(full, cfg)
    placements = partition_params(full, grid)
    if grid is not None:
        check_splits(placements, grid)
    if grid is None or grid.model <= 1:
        local = full
    else:
        tree = shard_tree(full.param_tree(), placements, grid)
        tree = dict(tree, layers=unstack_layers(full.cfg, tree["layers"]))
        local = Transformer(full.cfg, tree)
    local.placements = placements
    local.grid = grid
    return local


def gather_params(local, grid) -> dict:
    """The inverse of :func:`shard_params` (collective over the model
    group): the whole tree, the reference's layout, each stacked leaf one
    tensor with its leading layer axis."""
    from .distributed.sharding import gather_leaf

    def build(tree, pl):
        if isinstance(tree, dict):
            return {k: build(tree[k], pl[k]) for k in sorted(tree)}
        leaf = gather_leaf(tree, pl, grid)
        return torch.stack(leaf) if isinstance(leaf, list) else leaf

    return build(local.param_tree(), local.placements)
