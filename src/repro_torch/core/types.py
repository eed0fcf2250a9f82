"""Parameter trees, their helpers and the optax-style optimizer protocol:
the counterpart of ``repro/core/types.py``.

A parameter tree is a nested dict whose values are tensors or *stacked
leaves*: lists of same-shaped tensors, one per layer, standing for the
reference's leaves with a leading ``n_layers`` axis.  :func:`tree_leaves`
yields the leaves in the order of ``jax.tree.flatten`` on the reference's
params dict: keys sorted at every level, a stacked leaf as one leaf whose
layer 0 comes first when it is raveled.

The optimizer protocol is the reference's: a :class:`GradientTransformation`
is a pair of plain functions ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``; updates are *added*
to the parameters by :func:`apply_updates` (they carry the minus sign).  A
:class:`HessianAwareTransformation` also has ``update_hessian(hess,
state) -> state``, which folds a diagonal-Hessian estimate into its state
out of band (every k steps).  The functions run where the tensors are and
build an autograd graph only from tensors that require one (call them
under ``torch.no_grad()`` on a model's parameters).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, \
    Tuple, Union

import torch

Leaf = Union[torch.Tensor, List[torch.Tensor]]
Tree = Any
Schedule = Callable[[Any], torch.Tensor]  # step -> lr


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


def tree_map(fn: Callable[..., torch.Tensor], tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the tensors of ``tree`` and, tensor by tensor, of the
    trees ``rest`` shaped like it; a tree shaped like ``tree``."""
    cols = [flat_tensors(t) for t in (tree,) + rest]
    return tree_unflatten(tree, [fn(*ts) for ts in zip(*cols)])


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


# ---------------------------------------------------------------------------
# the optimizer protocol


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    """A pair of plain functions ``(init, update)``."""

    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Optional[Tree]], tuple]


@dataclasses.dataclass(frozen=True)
class HessianAwareTransformation(GradientTransformation):
    """A :class:`GradientTransformation` that also consumes diagonal-Hessian
    estimates: ``update_hessian(hess_estimate, state) -> state`` folds a
    fresh estimate into the state (the EMA of Sophia's eq. (5))."""

    update_hessian: Callable[[Tree, Any], Any] = None


class EmptyState(NamedTuple):
    pass


def tree_zeros_like(params: Tree, dtype: Optional[torch.dtype] = None
                    ) -> Tree:
    return tree_map(lambda p: torch.zeros_like(p, dtype=dtype or p.dtype),
                    params)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``params + updates`` as a new tree in the params' dtypes (the
    updates may be fp32)."""
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """Compose transforms left to right (``optax.chain``); the state is the
    tuple of the members' states.  ``update_hessian`` is forwarded to every
    member that has one, and the chain is hessian-aware when any member
    is."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    def update_hessian(hess, state):
        return tuple(
            t.update_hessian(hess, s)
            if isinstance(t, HessianAwareTransformation)
            and t.update_hessian is not None else s
            for t, s in zip(transforms, state))

    if any(isinstance(t, HessianAwareTransformation) for t in transforms):
        return HessianAwareTransformation(init=init, update=update,
                                          update_hessian=update_hessian)
    return GradientTransformation(init=init, update=update)
