"""Sharding rules over a ``(data, model)`` grid: the counterpart of
``repro/distributed/sharding.py``.

One table maps parameter-tree paths to a :data:`Placement`, one entry per
dim of the leaf: ``"model"`` (tensor or expert parallelism), ``"data"``
(the reference's FSDP axis) or ``None`` (replicated).  The table is the
reference's (``_rules``), copied as data, with its stacked-axis prefix
(``_STACK_KEYS``: a leaf under ``layers``, ``groups``, ``tail``,
``encoder`` or ``decoder`` leads with its layer axis, which is never
split) and its divisibility fallback: an axis whose size the grid's axis
does not divide is replicated.

What the port holds.  A rank keeps each parameter's block along its
``"model"`` entry (the rank's model coordinate); the ``"data"`` entries
are reported, as the reference's table gives them, but parameters stay
whole across the data axis (ZeRO-3 is not ported).  The optimizer's flat
m/h shards are what the data axis splits (``core/engine.py``).

Where the port's placement differs from the reference's, and why (both
sets are listed in :data:`PORT_LEAVES`):

  * attention leaves (``wq``/``bq``/``wo`` by query heads, ``wk``/``bk``/
    ``wv``/``bv`` by KV heads).  The reference splits the ``H * hd``
    columns element-wise, which can cut through a head; the port splits
    only by whole heads, and replicates where the heads do not divide
    (:func:`attention_split`): with ``H % M == 0`` but ``Hkv % M != 0``
    and ``M % Hkv == 0`` the KV projections are replicated and each rank
    takes its query heads' one KV head; otherwise the whole attention
    block is replicated.
  * the routed experts' ``w_gate``/``w_up``/``w_down`` under ``moe``.  The
    reference's first-match rule lets the dense MLP's ``w_gate``/``w_up``
    patterns shadow its expert rules, which puts the model axis on D of
    ``w_gate``/``w_up`` and on E of ``w_down``.  The port applies the
    expert rules its table states (E over model: expert parallelism).

The reference pins activations with ``constrain`` (a sharding constraint
for GSPMD).  It has no counterpart here: the collectives are explicit
(``distributed/tensor_parallel.py``), so the residual stream's placement
(replicated over model, rows over data) is set by the layers.  Its
``set_sequence_sharding``/``residual_axes`` (Megatron sequence
parallelism) are not ported.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from ..core.types import leaf_parts, leaf_shape

Placement = Tuple[Optional[str], ...]
AXES = ("data", "model")

# ---------------------------------------------------------------------------
# the grid


@dataclasses.dataclass(frozen=True, eq=False)
class Grid:
    """A rank's view of a ``(data, model)`` grid of processes: ranks are
    numbered model-fastest, ``rank = d * M + m`` (the reference's device
    order under ``jax.make_mesh``).  ``data_group`` joins the ranks of this
    rank's model coordinate (its data-parallel peers), ``model_group`` those
    of its data coordinate (its tensor-parallel peers); both are None on
    one process (``torch.distributed``'s default group)."""

    shape: Tuple[int, int]
    rank: int
    data_group: Any = None
    model_group: Any = None

    @property
    def data(self) -> int:
        return self.shape[0]

    @property
    def model(self) -> int:
        return self.shape[1]

    @property
    def coords(self) -> Tuple[int, int]:
        return divmod(self.rank, self.model)

    @property
    def d(self) -> int:
        return self.coords[0]

    @property
    def m(self) -> int:
        return self.coords[1]


_ACTIVE = {"grid": None}


def set_grid(grid: Optional[Grid]) -> None:
    """Install the grid the model's layers split over (None: one
    process's layers)."""
    _ACTIVE["grid"] = grid


def active_grid() -> Optional[Grid]:
    return _ACTIVE["grid"]


def resolve_grid(grid=None, group=None) -> Optional[Grid]:
    """The grid a trainer runs on: ``grid``; else, in an initialized
    process group of W > 1 ranks, the pure data-parallel (W, 1) grid over
    ``group`` (the default group when None); else None (one process)."""
    if grid is not None:
        return grid
    if not (dist.is_available() and dist.is_initialized()):
        return None
    ndev, rank = dist.get_world_size(group), dist.get_rank(group)
    if ndev <= 1:
        return None
    return Grid(shape=(ndev, 1), rank=rank,
                data_group=group if group is not None else dist.group.WORLD)


def model_parallel() -> int:
    """The model axis's size of the active grid (1 without one)."""
    grid = active_grid()
    return 1 if grid is None else grid.model


def _axis_size(grid, ax) -> int:
    if ax is None:
        return 1
    shape = dict(zip(AXES, grid.shape)) if isinstance(grid, Grid) \
        else dict(grid)
    return shape[ax]


# ---------------------------------------------------------------------------
# the rule table: (path regex, placement) with "model", "fsdp" or None;
# paths look like "['layers']['attn']['wq']" (the reference's keystr)

RULES = (
    # embeddings: vocab over TP, d_model over FSDP
    (r"\['embed'\]\['tok'\]$", ("model", "fsdp")),
    (r"\['embed'\]\['unembed'\]$", ("fsdp", "model")),
    (r"\['embed'\]\['pos'\]$", (None, "fsdp")),
    # attention
    (r"\['wq'\]$", ("fsdp", "model")),
    (r"\['wk'\]$", ("fsdp", "model")),
    (r"\['wv'\]$", ("fsdp", "model")),
    (r"\['wo'\]$", ("model", "fsdp")),
    (r"\['b[qkv]'\]$", ("model",)),
    # dense MLP / shared experts / rwkv channel-mix
    (r"\['w_gate'\]$", ("fsdp", "model")),
    (r"\['w_up'\]$", ("fsdp", "model")),
    (r"\['w_down'\]$", ("model", "fsdp")),
    (r"\['b_up'\]$", ("model",)),
    (r"\['b_down'\]$", ()),
    # MoE experts: E over TP (expert parallelism)
    (r"\['moe'\]\['router'\]$", ("fsdp", None)),
    (r"\['moe'\]\['w_gate'\]$", ("model", "fsdp", None)),
    (r"\['moe'\]\['w_up'\]$", ("model", "fsdp", None)),
    (r"\['moe'\]\['w_down'\]$", ("model", None, "fsdp")),
    # rwkv time-mix
    (r"\['tm'\]\['w[rkvg]'\]$", ("fsdp", "model")),
    (r"\['tm'\]\['wo'\]$", ("model", "fsdp")),
    (r"\['tm'\]\['wa'\]$", ("fsdp", None)),
    (r"\['tm'\]\['wb'\]$", (None, "model")),
    (r"\['tm'\]\['w0'\]$", ("model",)),
    (r"\['tm'\]\['u'\]$", ("model", None)),
    (r"\['tm'\]\['mu'\]$", (None, None)),
    (r"\['cm'\]\['wk'\]$", ("fsdp", "model")),
    (r"\['cm'\]\['wv'\]$", ("model", "fsdp")),
    (r"\['cm'\]\['wr'\]$", ("fsdp", "model")),
    # griffin RG-LRU
    (r"\['w_in'\]$", ("fsdp", "model")),
    (r"\['conv_k'\]$", (None, "model")),
    (r"\['conv_b'\]$", ("model",)),
    (r"\['lam'\]$", ("model",)),
    (r"\['w_[ax]'\]$", (None, "model")),
    (r"\['b_[ax]'\]$", ("model",)),
    (r"\['w_out'\]$", ("model", "fsdp")),
    # frontends
    (r"\['patch_proj'\]$", ("fsdp", None)),
    (r"\['frame_proj'\]$", ("fsdp", None)),
)

_STACK_KEYS = ("layers", "groups", "tail", "encoder", "decoder")

#: the leaves whose placement the port sets itself (module docstring):
#: attention leaves by whole heads, routed experts by the expert rules
PORT_LEAVES = {
    "heads": ("wq", "wk", "wv", "wo", "bq", "bk", "bv"),
    "experts": ("w_gate", "w_up", "w_down"),
}
_EXPERT_RULES = {"w_gate": ("model", "fsdp", None),
                 "w_up": ("model", "fsdp", None),
                 "w_down": ("model", None, "fsdp")}
_QUERY_SIDE = ("wq", "bq", "wo")


def _fit(dims, shape, n_prefix: int, grid) -> Placement:
    """A rule's placement over a leaf: "fsdp" the data axis (the
    reference's ``fsdp_axis``; its composite ``("pod", "data")`` has no
    counterpart, a grid has no pod axis), the stacked prefix prepended,
    non-dividing axes replicated, trailing Nones dropped."""
    dims = ["data" if ax == "fsdp" else ax for ax in dims]
    dims = [None] * n_prefix + dims + [None] * (len(shape) - n_prefix
                                                 - len(dims))
    dims = dims[:len(shape)]
    fixed = [ax if ax is None or s % _axis_size(grid, ax) == 0 else None
             for ax, s in zip(dims, shape)]
    while fixed and fixed[-1] is None:
        fixed.pop()
    return tuple(fixed)


def reference_placement(path: str, shape, n_prefix: int, grid
                        ) -> Placement:
    """The reference's ``_spec_for``: the first rule whose regex matches
    the path, else replicated."""
    for pat, dims in RULES:
        if re.search(pat, path):
            break
    else:
        dims = ()
    return _fit(dims, shape, n_prefix, grid)


def attention_split(cfg, M: int) -> str:
    """How attention splits over ``M`` model ranks: "heads" (query and KV
    heads both), "query" (query heads; the KV heads replicated, each rank
    taking its query heads' one KV head), or "none" (replicated)."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    if M <= 1 or (H % M == 0 and Hkv % M == 0):
        return "heads"
    if H % M == 0 and M % Hkv == 0:
        return "query"
    return "none"


def port_placement(path: str, names: Tuple[str, ...], shape, n_prefix: int,
                   grid, cfg) -> Placement:
    """The port's placement of one leaf: the reference's, but by whole
    heads on attention leaves and by experts on the routed experts'
    (:data:`PORT_LEAVES`).  ``names`` are the path's keys."""
    leaf, parent = names[-1], names[-2] if len(names) > 1 else None
    if parent == "moe" and leaf in PORT_LEAVES["experts"]:
        return _fit(_EXPERT_RULES[leaf], shape, n_prefix, grid)
    spec = reference_placement(path, shape, n_prefix, grid)
    if (cfg is not None and parent in ("attn", "xattn", "cross")
            and leaf in PORT_LEAVES["heads"]):
        split = attention_split(cfg, _axis_size(grid, "model"))
        keep = split == "heads" or (split == "query"
                                    and leaf in _QUERY_SIDE)
        if not keep:
            spec = tuple(None if ax == "model" else ax for ax in spec)
            while spec and spec[-1] is None:
                spec = spec[:-1]
    return spec


def _walk(tree, names=()):
    """(names, leaf) of every leaf of a nested dict, sorted keys."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _walk(tree[key], names + (key,))
    else:
        yield names, tree


def _keystr(names) -> str:
    return "".join(f"['{n}']" for n in names)


def _shape(leaf) -> Tuple[int, ...]:
    if isinstance(leaf, (list, tuple)):
        return leaf_shape(leaf)
    return tuple(leaf.shape)


def partition_params(params, grid, *, cfg=None):
    """The placement tree of ``params`` (a model with ``param_tree()`` and
    ``cfg``, or a nested dict of leaves with ``.shape``, a stacked leaf a
    list of per-layer tensors; ``cfg`` then names the heads) on ``grid``
    (a :class:`Grid`, or a mapping of axis sizes)."""
    if hasattr(params, "param_tree"):
        cfg = cfg if cfg is not None else params.cfg
        params = params.param_tree()

    def build(tree, names):
        if isinstance(tree, dict):
            return {k: build(tree[k], names + (k,)) for k in sorted(tree)}
        n_prefix = 1 if any(k in _STACK_KEYS for k in names) else 0
        return port_placement(_keystr(names), names, _shape(tree), n_prefix,
                              grid, cfg)

    return build(params, ())


#: the leaves that the layers split over the model axis by its size alone:
#: the MLPs' and shared experts' (``w_gate``/``w_up``/``b_up`` by columns,
#: ``w_down`` by rows), the routed experts' and the vocabulary's (``tok``,
#: ``unembed``).  Attention follows :func:`attention_split`, as its
#: placements do.
SPLIT_LEAVES = ("w_gate", "w_up", "b_up", "w_down", "tok", "unembed")


def check_splits(placements, grid) -> None:
    """Raise ``ValueError`` where the placement table replicates a leaf of
    :data:`SPLIT_LEAVES` on a model axis above one (its axis not a multiple
    of the model axis): the layers would split it all the same."""
    M = _axis_size(grid, "model")
    if M <= 1:
        return
    bad = [_keystr(names) for names, pl in _walk(placements)
           if names[-1] in SPLIT_LEAVES and "model" not in pl]
    if bad:
        raise ValueError(
            f"a model axis of {M} does not divide the split axis of "
            f"{len(bad)} leaves (d_ff, the vocabulary or the experts): "
            f"{bad[:4]}{' ...' if len(bad) > 4 else ''}")


def model_dim(placement: Placement) -> Optional[int]:
    """The dim a placement splits over the model axis, or None."""
    return placement.index("model") if "model" in placement else None


# ---------------------------------------------------------------------------
# batch / cache placements


def batch_specs(batch, grid):
    """The leading (batch) dim of every input over the data axis where it
    divides, else replicated."""
    D = _axis_size(grid, "data")

    def spec(leaf):
        if leaf.dim() == 0:
            return ()
        if leaf.shape[0] % D:
            return (None,) * leaf.dim()
        return ("data",) + (None,) * (leaf.dim() - 1)

    return {k: spec(v) for k, v in batch.items()}


def cache_specs(cache, grid):
    """KV caches (L, B, S, Hkv, hd): batch over data, the first dim after
    it that the model axis divides over model (the reference's layout,
    data only here: the port serves on one process)."""
    D, M = _axis_size(grid, "data"), _axis_size(grid, "model")

    def spec(leaf):
        if leaf.dim() == 0:
            return ()
        dims = [None] * leaf.dim()
        bdim = 1 if leaf.dim() >= 3 else 0
        if leaf.shape[bdim] % D == 0:
            dims[bdim] = "data"
        for d in range(bdim + 1, leaf.dim()):
            if leaf.shape[d] % M == 0:
                dims[d] = "model"
                break
        return tuple(dims)

    return {k: spec(v) for k, v in cache.items()}


# ---------------------------------------------------------------------------
# a rank's blocks of a leaf, and back


def block(t: torch.Tensor, dim: Optional[int], m: int, M: int
          ) -> torch.Tensor:
    """Rank ``m``'s block of ``t`` along ``dim`` (a copy), or ``t``."""
    if dim is None or M <= 1:
        return t
    n = t.shape[dim] // M
    return t.narrow(dim, m * n, n).clone()


def shard_tree(tree, placements, grid: Grid):
    """The rank's blocks of every leaf of ``tree`` (a stacked leaf as a
    list of per-layer blocks) by the model entries of ``placements``."""
    out = {}
    for key in sorted(tree):
        sub, pl = tree[key], placements[key]
        if isinstance(sub, dict):
            out[key] = shard_tree(sub, pl, grid)
            continue
        dim = model_dim(pl)
        if isinstance(sub, (list, tuple)):
            out[key] = [block(t, None if dim is None else dim - 1, grid.m,
                              grid.model) for t in sub]
        else:
            out[key] = block(sub, dim, grid.m, grid.model)
    return out


def gather_block(t: torch.Tensor, dim: Optional[int], grid: Grid
                 ) -> torch.Tensor:
    """The whole tensor from every model rank's block of it along ``dim``
    (collective over the model group), or ``t``."""
    if dim is None or grid is None or grid.model <= 1:
        return t
    parts = [torch.empty_like(t) for _ in range(grid.model)]
    dist.all_gather(parts, t.contiguous(), group=grid.model_group)
    return torch.cat(parts, dim=dim)


def gather_leaf(leaf, placement: Placement, grid: Grid):
    """A leaf (a tensor or a stacked list) whole from its blocks."""
    dim = model_dim(placement)
    if isinstance(leaf, (list, tuple)):
        return [gather_block(t.detach(), None if dim is None else dim - 1,
                             grid) for t in leaf_parts(leaf)]
    return gather_block(leaf.detach(), dim, grid)
