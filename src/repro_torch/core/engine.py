"""Flat-buffer optimizer engine: the counterpart of ``repro/core/engine.py``
for every optimizer family of the reference: Sophia (G and H), AdamW,
AdaHessian, Lion, SignGD and SGD.

The engine keeps the optimizer state as a few dtype-homogeneous flat
shards, one per parameter dtype, each tail-padded to a multiple of
``BLOCK``.  A static :class:`ShardLayout` maps a parameter tree
(``core/types.py``) to the flat view.  The layout reproduces the
reference's exactly: the leaves in ``jax.tree.flatten`` order (sorted keys,
a stacked leaf raveled layer 0 first), the same offsets and the same tail
pad, so the flat ``m``/``h`` shards of the two packages can be exchanged
as they are (``convert.engine_state_from_jax``).

Each step ravels the parameters and the fp32 gradients, runs the update
per shard and writes the new parameters back into the tree's tensors in
place (the reference returns a new pytree).  Padded elements are fixed
points of the update (p = m = h = g = 0 stays 0).

Backends:
    * ``reference`` -- the plain copy of the reference oracles in
      ``kernels/ref.py``, the reference trainer's default
      (``fused_kernel=False``);
    * ``fused`` -- the engine kernels of ``kernels/sophia_update.py`` (the
      reference's ``backend="pallas"``, ``fused_kernel=True``): one launch
      per shard, the clip counts computed in the kernel.  On a CPU shard
      they compute their plain versions, the same operations as
      ``reference``, so the two backends agree bit for bit there.

Lion, SignGD and SGD keep no curvature shards (``h`` is empty, as in the
reference); Sophia and AdaHessian refresh theirs out of band.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels import ref as kref
from ..kernels import sophia_update as kblk
from .types import Tree, leaf_parts, leaf_shape, tree_leaves

BLOCK = kblk.BLOCK   # the reference's kernel block: every shard pads to it

#: trainer-level optimizer names -> engine family (the reference's table)
FAMILIES = {
    "sophia_g": "sophia",
    "sophia_h": "sophia",
    "adamw": "adamw",
    "lion": "lion",
    "signgd": "signgd",
    "adahessian": "adahessian",
    "sgd": "sgd",
}
_CURVATURE_FAMILIES = ("sophia", "adamw", "adahessian")
_HESSIAN_AWARE = ("sophia", "adahessian")
BACKENDS = ("reference", "fused")


def hessian_aware_optimizer(optimizer: str) -> bool:
    """True for optimizer names whose curvature refreshes out-of-band."""
    return FAMILIES.get(optimizer) in _HESSIAN_AWARE


def dtype_name(dt: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"``, the reference's spelling."""
    return str(dt).removeprefix("torch.")


# ---------------------------------------------------------------------------
# static layout


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Static map between a parameter tree and its flat dtype shards."""

    leaf_shapes: Tuple[Tuple[int, ...], ...]
    leaf_dtypes: Tuple[torch.dtype, ...]
    leaf_shard: Tuple[int, ...]    # which shard each leaf lives in
    leaf_offset: Tuple[int, ...]   # element offset of the leaf in its shard
    shard_dtypes: Tuple[torch.dtype, ...]
    shard_sizes: Tuple[int, ...]   # padded: multiples of ``block``
    shard_used: Tuple[int, ...]    # true element counts (pad excluded)
    block: int

    @property
    def n_shards(self) -> int:
        return len(self.shard_sizes)

    @property
    def n_params(self) -> int:
        return sum(self.shard_used)

    def bucket_slices(self, bucket_elems: int, *,
                      align: int = 256) -> Tuple[Tuple[Tuple[int, int], ...],
                                                 ...]:
        """Per-shard bucket views (:func:`bucket_slices`): the static
        slice table the bucketed compressed all-reduce
        (``distributed/overlap.py``) iterates, one tuple of (start, stop)
        pairs per flat shard."""
        return tuple(bucket_slices(int(n), bucket_elems, align=align)
                     for n in self.shard_sizes)

    def manifest(self) -> dict:
        """JSON summary (stored in checkpoint manifests), field for field
        the reference's."""
        return {
            "block": self.block,
            "n_leaves": len(self.leaf_shapes),
            "n_params": self.n_params,
            "shards": [{"dtype": dtype_name(d), "size": int(s),
                        "used": int(u)}
                       for d, s, u in zip(self.shard_dtypes, self.shard_sizes,
                                          self.shard_used)],
        }


def bucket_slices(n: int, bucket_elems: int, *,
                  align: int = 256) -> Tuple[Tuple[int, int], ...]:
    """Static (start, stop) views partitioning a flat shard into buckets.

    ``bucket_elems`` is rounded up to a multiple of ``align`` (the
    quantization block, times the number of ranks so that every rank's
    segment stays block-aligned); the last bucket takes the remainder.
    ``bucket_elems <= 0`` means one bucket, the monolithic view, and so
    does a shard that ``align`` does not divide.  Every boundary is a
    multiple of ``align``, which keeps bucketed quantization bit-identical
    to whole-shard quantization."""
    if n <= 0:
        return ()
    if bucket_elems <= 0 or bucket_elems >= n:
        return ((0, n),)
    b = -(-bucket_elems // align) * align
    if b <= 0 or n % align != 0:
        return ((0, n),)
    edges = list(range(0, n, b)) + [n]
    return tuple((edges[i], edges[i + 1]) for i in range(len(edges) - 1))


def build_layout(params: Tree, *, block: int = BLOCK) -> ShardLayout:
    """Group leaves into dtype-homogeneous shards, assign static offsets."""
    leaves = tree_leaves(params)
    shapes = tuple(leaf_shape(leaf) for leaf in leaves)
    dtypes = tuple(leaf_parts(leaf)[0].dtype for leaf in leaves)
    shard_dtypes: list = []
    used: list = []
    leaf_shard, leaf_offset = [], []
    for shape, dt in zip(shapes, dtypes):
        if dt not in shard_dtypes:
            shard_dtypes.append(dt)
            used.append(0)
        si = shard_dtypes.index(dt)
        leaf_shard.append(si)
        leaf_offset.append(used[si])
        used[si] += math.prod(shape)
    sizes = tuple(-(-u // block) * block for u in used)
    return ShardLayout(leaf_shapes=shapes, leaf_dtypes=dtypes,
                       leaf_shard=tuple(leaf_shard),
                       leaf_offset=tuple(leaf_offset),
                       shard_dtypes=tuple(shard_dtypes), shard_sizes=sizes,
                       shard_used=tuple(used), block=block)


def ravel_shards(layout: ShardLayout, tree: Tree, *,
                 dtype: Optional[torch.dtype] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """Tree -> flat shards, one concatenate per shard with the zero tail
    pad as its last operand.  ``dtype`` overrides the shard dtype
    (gradients and estimates ravel to fp32)."""
    leaves = tree_leaves(tree)
    parts: list = [[] for _ in layout.shard_sizes]
    device = leaf_parts(leaves[0])[0].device
    for leaf, si in zip(leaves, layout.leaf_shard):
        tdt = dtype if dtype is not None else layout.shard_dtypes[si]
        parts[si].extend(t.reshape(-1).to(tdt) for t in leaf_parts(leaf))
    out = []
    for si, chunks in enumerate(parts):
        tdt = dtype if dtype is not None else layout.shard_dtypes[si]
        pad = layout.shard_sizes[si] - layout.shard_used[si]
        if pad:
            chunks = chunks + [torch.zeros((pad,), dtype=tdt, device=device)]
        out.append(torch.cat(chunks))
    return tuple(out)


def unravel_shards(layout: ShardLayout,
                   shards: Tuple[torch.Tensor, ...]) -> list:
    """Flat shards -> one tensor per leaf in the reference's leaf shape
    (a stacked leaf as one (n_layers, ...) view), in the leaf dtype."""
    out = []
    for shape, dt, si, off in zip(layout.leaf_shapes, layout.leaf_dtypes,
                                  layout.leaf_shard, layout.leaf_offset):
        n = math.prod(shape)
        out.append(shards[si][off:off + n].reshape(shape).to(dt))
    return out


@torch.no_grad()
def write_shards(layout: ShardLayout, shards: Tuple[torch.Tensor, ...],
                 tree: Tree) -> None:
    """Copy flat shards into the tree's tensors, in place."""
    for leaf, value in zip(tree_leaves(tree), unravel_shards(layout, shards)):
        parts = leaf_parts(leaf)
        if isinstance(leaf, (list, tuple)):
            for t, v in zip(parts, value):
                t.copy_(v)
        else:
            parts[0].copy_(value)


# ---------------------------------------------------------------------------
# engine state


class EngineState(NamedTuple):
    """Optimizer state over flat shards (lives flat across the whole run).
    ``m`` is the first moment; ``h`` the curvature / second-moment slot
    (Sophia's diagonal-Hessian EMA, AdamW's and AdaHessian's v; empty for
    Lion, SignGD and SGD)."""

    count: torch.Tensor           # int32: step counter t
    m: Tuple[torch.Tensor, ...]
    h: Tuple[torch.Tensor, ...]
    hess_count: torch.Tensor      # int32: Hessian refreshes so far
    clip_fraction: torch.Tensor   # fp32 telemetry (paper Fig 9a)


# ---------------------------------------------------------------------------
# the engine


class OptimizerEngine:
    """One update path over flat shards::

        eng = OptimizerEngine("sophia_g", hypers=dict(beta1=.96, beta2=.99,
                              gamma=.05, eps=1e-12, weight_decay=.2,
                              clip_threshold=1.0))
        state = eng.init(tree)
        tree, state = eng.step_shards(state, tree, eng.ravel_grads(tree, g),
                                      lr)
        tree, state = eng.step_with_refresh(state, tree, g_sh, lr, est_sh,
                                            scale, do_refresh)
        state = eng.update_hessian(state, est_sh, scale=B, params=tree)

    ``tree`` is a parameter tree (``Transformer.param_tree()`` or a plain
    dict); its tensors are updated in place and the tree is returned.
    """

    def __init__(self, optimizer: str, *, hypers: dict,
                 backend: str = "reference", block: int = BLOCK,
                 state_dtype: torch.dtype = torch.float32):
        if optimizer not in FAMILIES:
            raise ValueError(f"unknown optimizer {optimizer!r}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r} (the port's are "
                             f"{BACKENDS}; 'fused' runs the CUDA kernels)")
        self.optimizer = optimizer
        self.family = FAMILIES[optimizer]
        self.hypers = dict(hypers)
        self.backend = backend
        self.block = block
        self.state_dtype = state_dtype
        self._layouts: dict = {}

    @property
    def needs_curvature(self) -> bool:
        return self.family in _CURVATURE_FAMILIES

    @property
    def hessian_aware(self) -> bool:
        return self.family in _HESSIAN_AWARE

    @property
    def tracks_clip_fraction(self) -> bool:
        return self.family == "sophia"

    def layout(self, params: Tree) -> ShardLayout:
        leaves = tree_leaves(params)
        key = tuple((leaf_shape(leaf), leaf_parts(leaf)[0].dtype)
                    for leaf in leaves)
        lay = self._layouts.get(key)
        if lay is None:
            lay = build_layout(params, block=self.block)
            self._layouts[key] = lay
        return lay

    def describe(self, params: Tree) -> dict:
        return self.layout(params).manifest()

    def init(self, params: Tree) -> EngineState:
        lay = self.layout(params)
        device = leaf_parts(tree_leaves(params)[0])[0].device

        def zeros():
            return tuple(torch.zeros((s,), dtype=self.state_dtype,
                                     device=device)
                         for s in lay.shard_sizes)

        scalar = dict(device=device)
        return EngineState(
            count=torch.zeros((), dtype=torch.int32, **scalar),
            m=zeros(), h=zeros() if self.needs_curvature else (),
            hess_count=torch.zeros((), dtype=torch.int32, **scalar),
            clip_fraction=torch.zeros((), dtype=torch.float32, **scalar))

    def ravel_grads(self, params: Tree,
                    grads: Tree) -> Tuple[torch.Tensor, ...]:
        """Grads tree -> fp32 flat shards in this engine's layout."""
        return ravel_shards(self.layout(params), grads, dtype=torch.float32)

    def step_shards(self, state: EngineState, params: Tree,
                    g_sh: Tuple[torch.Tensor, ...], lr) -> tuple:
        """One optimizer step from fp32 gradient shards.  ``lr`` is a
        0-dim fp32 tensor (the schedule's value).  Returns ``(params,
        new_state)``; ``params`` is updated in place."""
        return self._apply_shards(state, params, g_sh, lr, None, None, None)

    def step_with_refresh(self, state: EngineState, params: Tree,
                          g_sh: Tuple[torch.Tensor, ...], lr, est, scale,
                          do_refresh) -> tuple:
        """One step with the Hessian-EMA refresh fused in: when
        ``do_refresh`` is set, each curvature shard absorbs ``scale *
        est`` (Algorithm 3 line 9; ``scale`` is the GNB batch factor B)
        before the update reads it.  ``est`` is a tuple of flat fp32
        shards in this engine's layout."""
        if not self.hessian_aware:
            raise ValueError(
                f"step_with_refresh requires a hessian-aware family, "
                f"got {self.family!r} (use step_shards)")
        e_sh = self._est_shards(self.layout(params), est)
        flag = float(do_refresh)
        scale = torch.as_tensor(scale, dtype=torch.float32)
        return self._apply_shards(state, params, g_sh, lr, e_sh, flag, scale)

    @staticmethod
    def _est_shards(lay: ShardLayout, est) -> Tuple[torch.Tensor, ...]:
        if (len(est) != lay.n_shards
                or any(e.shape != (s,) for e, s in zip(est, lay.shard_sizes))):
            raise ValueError("est must be flat shards in the engine layout")
        return tuple(e.to(torch.float32) for e in est)

    def _apply_shards(self, state: EngineState, params: Tree, g_sh, lr,
                      e_sh, flag, scale) -> tuple:
        """Shared shard loop for the plain step (``e_sh is None``) and the
        step with the refresh fused in."""
        lay = self.layout(params)
        lr = torch.as_tensor(lr, dtype=torch.float32)
        c1 = (state.count + 1).to(torch.float32)   # bias-correction step
        p_sh = ravel_shards(lay, params)
        new_p, new_m, new_h = [], [], []
        nclip = None
        for i in range(lay.n_shards):
            h_i = state.h[i] if self.needs_curvature else None
            e_i = e_sh[i] if e_sh is not None else None
            p2, m2, h2, n_i = self._step_shard(
                p_sh[i], state.m[i], h_i, g_sh[i], e_i, lr, c1, flag, scale)
            new_p.append(p2)
            new_m.append(m2)
            if h2 is not None:
                new_h.append(h2)
            if n_i is not None:
                n_i = n_i.to(torch.float32)
                nclip = n_i if nclip is None else nclip + n_i
        write_shards(lay, tuple(new_p), params)
        hess_count = state.hess_count
        if flag is not None:
            hess_count = hess_count + int(flag > 0.5)
        clip_fraction = (state.clip_fraction if nclip is None
                         else (nclip / lay.n_params).to(torch.float32))
        new_state = EngineState(
            count=state.count + 1, m=tuple(new_m), h=tuple(new_h),
            hess_count=hess_count, clip_fraction=clip_fraction)
        return params, new_state

    def _step_shard(self, p, m, h, g, e, lr, c1, flag, scale):
        """One flat shard on the backend: the plain update when ``e`` is
        None, the update with the refresh fused in otherwise (the family
        dispatch of the reference's ``core/engine.py:391-442``).  Returns
        (p', m', h' or None, clip count or None)."""
        hp = self.hypers
        fused = self.backend == "fused"
        kw = dict(block=self.block) if fused else {}
        fam = self.family
        if fam == "sophia":
            args = dict(beta1=hp["beta1"], gamma=hp["gamma"], eps=hp["eps"],
                        weight_decay=hp["weight_decay"],
                        clip_threshold=hp["clip_threshold"])
            if e is not None:
                if fused:
                    p2, m2, h2, nclip = kblk.sophia_refresh_fused_block(
                        p, m, h, g, e, lr, flag, scale, beta2=hp["beta2"],
                        **args, **kw)
                    return p2, m2, h2, nclip.sum(dtype=torch.int32)
                return kref.sophia_step_refresh_ref(
                    p, m, h, g, e, lr=lr, flag=flag, scale=scale,
                    beta2=hp["beta2"], **args)
            if fused:
                p2, m2, nclip = kblk.sophia_fused_block(p, m, h, g, lr,
                                                        **args, **kw)
                return p2, m2, h, nclip.sum(dtype=torch.int32)
            p2, m2, nclip = kref.sophia_fused_ref(p, m, h, g, lr=lr, **args)
            return p2, m2, h, nclip
        if fam in ("adamw", "adahessian"):     # h holds v
            args = dict(beta1=hp["beta1"], beta2=hp["beta2"], eps=hp["eps"],
                        weight_decay=hp["weight_decay"])
            if fam == "adamw":
                if fused:
                    return kblk.adamw_fused_block(p, m, h, g, lr, c1, **args,
                                                  **kw) + (None,)
                return kref.adamw_fused_ref(p, m, h, g, lr=lr, step=c1,
                                            **args) + (None,)
            if e is not None:
                if fused:
                    return kblk.adahessian_refresh_fused_block(
                        p, m, h, g, e, lr, flag, scale, c1, **args,
                        **kw) + (None,)
                return kref.adahessian_step_refresh_ref(
                    p, m, h, g, e, lr=lr, flag=flag, scale=scale, step=c1,
                    **args) + (None,)
            if fused:
                p2, m2 = kblk.adahessian_fused_block(p, m, h, g, lr, c1,
                                                     **args, **kw)
            else:
                p2, m2 = kref.adahessian_fused_ref(p, m, h, g, lr=lr,
                                                   step=c1, **args)
            return p2, m2, h, None
        # Lion, SignGD, SGD: no curvature, no clip fraction
        if fam == "lion":
            args = dict(beta1=hp["beta1"], beta2=hp["beta2"],
                        weight_decay=hp["weight_decay"])
            step, plain = kblk.lion_fused_block, kref.lion_fused_ref
        elif fam == "signgd":
            args = dict(beta1=hp["beta1"], weight_decay=hp["weight_decay"])
            step, plain = kblk.signgd_fused_block, kref.signgd_fused_ref
        elif fam == "sgd":
            args = dict(momentum=hp.get("momentum", 0.0))
            step, plain = kblk.sgd_fused_block, kref.sgd_fused_ref
        else:
            raise ValueError(fam)
        p2, m2 = (step(p, m, g, lr, **args, **kw) if fused
                  else plain(p, m, g, lr=lr, **args))
        return p2, m2, None, None

    def update_hessian(self, state: EngineState, est, *, scale=1.0,
                       params: Tree) -> EngineState:
        """Fold a fresh diagonal-Hessian estimate into the curvature
        shards out of band: h' = beta2 h + (1-beta2) scale est per shard
        (``est`` flat fp32 shards in this engine's layout, ``scale`` GNB's
        B); AdaHessian squares the scaled estimate (its v is an EMA of
        squared estimates).  The trainer fuses this into
        :meth:`step_with_refresh`; this form is for tests and tooling.  A
        family without out-of-band curvature returns the state
        unchanged."""
        if not self.hessian_aware:
            return state
        e_sh = self._est_shards(self.layout(params), est)
        kw = dict(beta2=self.hypers["beta2"], scale=scale,
                  square=self.family == "adahessian")
        if self.backend == "fused":
            new_h = tuple(kblk.hessian_ema_block(h, e, block=self.block,
                                                 **kw)
                          for h, e in zip(state.h, e_sh))
        else:
            new_h = tuple(kref.hessian_ema_ref(h, e, **kw)
                          for h, e in zip(state.h, e_sh))
        return state._replace(h=new_h, hess_count=state.hess_count + 1)
