"""Parameter trees and their helpers: the counterpart of
``repro/core/types.py``, cut to what the training slice needs.

A parameter tree is a nested dict whose values are tensors or *stacked
leaves*: lists of same-shaped tensors, one per layer, standing for the
reference's leaves with a leading ``n_layers`` axis.  :func:`tree_leaves`
yields the leaves in the order of ``jax.tree.flatten`` on the reference's
params dict: keys sorted at every level, a stacked leaf as one leaf whose
layer 0 comes first when it is raveled.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple, Union

import torch

Leaf = Union[torch.Tensor, List[torch.Tensor]]
Tree = Any


def tree_leaves(tree: Tree) -> List[Leaf]:
    """The leaves of ``tree`` in sorted-key order."""
    if isinstance(tree, dict):
        out: List[Leaf] = []
        for key in sorted(tree):
            out.extend(tree_leaves(tree[key]))
        return out
    return [tree]


def leaf_parts(leaf: Leaf) -> List[torch.Tensor]:
    """The tensors of one leaf: the layers of a stacked leaf, in order."""
    return list(leaf) if isinstance(leaf, (list, tuple)) else [leaf]


def leaf_shape(leaf: Leaf) -> Tuple[int, ...]:
    """The reference's shape of the leaf (a stacked leaf leads with its
    layer count)."""
    if isinstance(leaf, (list, tuple)):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def flat_tensors(tree: Tree) -> List[torch.Tensor]:
    """Every tensor of ``tree``, leaf by leaf, layers in order."""
    return [t for leaf in tree_leaves(tree) for t in leaf_parts(leaf)]


def tree_unflatten(like: Tree, tensors: Sequence[torch.Tensor]) -> Tree:
    """A tree shaped like ``like`` holding ``tensors`` (in the order of
    :func:`flat_tensors`)."""
    it = iter(tensors)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [next(it) for _ in node]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more tensors than the tree has leaves")
    return out


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Tree) -> Tree:
    return tree_unflatten(tree, [fn(t) for t in flat_tensors(tree)])


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in fp32
    (a stacked leaf's sum runs over its layers)."""
    total = None
    for leaf in tree_leaves(tree):
        s = sum(t.to(torch.float32).square().sum() for t in leaf_parts(leaf))
        total = s if total is None else total + s
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)
