"""Carry parameters of the JAX reference across to the port through numpy.

``torch.Generator`` cannot reproduce ``jax.random`` draws, so the tests that
hold the port against the reference build the weights once with the
reference's ``init_params`` and hand them over as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.common import ModelConfig
from .models.transformer import Transformer


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {name: _to_torch(leaf, device) for name, leaf in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(leaf, device) for leaf in tree]
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


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
