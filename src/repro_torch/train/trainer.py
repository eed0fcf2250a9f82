"""Training loop, Algorithm 3 with the refresh at ``t % k == 0``: the
counterpart of ``repro/train/trainer.py`` for every optimizer of the
paper's comparison (Sophia-G and Sophia-H, AdamW, Lion, SignGD, SGD,
AdaHessian) and the GNB, Hutchinson and empirical-Fisher estimators, on
every training-attention route (flash attention with ``fused_attn``, the
default; ``attn_impl`` "full" or "chunked"), both loss routes (the
logits-free fused CE with ``fused_loss``, the default, else the plain
chunked sweep), every remat policy and, with ``fused_kernel``, the engine
kernels.

Every step:
  grad accumulation over microbatches -> global-norm clip (threshold 1.0,
  trigger telemetry) -> ravel to flat fp32 shards -> engine update.
On a refresh step of a hessian-aware optimizer (Sophia, AdaHessian) the
engine update is ``step_with_refresh``: before it, the estimate is taken
on the first ``hess_subbatch`` rows of the batch from the pre-update
parameters and folds into the Hessian EMA with its scale.
  * GNB with ``fused_loss`` draws ŷ inside the fused CE forward sweep and
    takes ĝ by autograd, B = the sweep's valid-position count; without it,
    the sub-batch's logits are materialized (``logits_fn``) and one chunked
    sweep draws ŷ and forms the log-sum-exp (``gnb_ghat_flat``), B = the
    valid positions.  ĝ is squared in flat space.
  * Hutchinson takes u ⊙ Hu forward-over-reverse (``torch.func.jvp`` of
    ``torch.func.grad`` of the loss as a function of the parameters)
    through the loss twin ("fused_jvp", or the chunked loss without
    ``fused_loss``) and the attention twin ("flash_jvp"), scale 1.  Its
    trunk runs without remat: ``torch.utils.checkpoint`` does not compose
    with ``torch.func`` (the reference remats there; remat changes memory,
    not values).
  * The empirical Fisher squares the true-label gradient, B = the
    sub-batch's positions.
The reference makes this one compiled program under a traced flag; the
port runs eagerly and branches in Python on the same flag.

The state's ``rng`` is the reference's key, ``split(PRNGKey(seed))[1]``
(``train_state.train_key``), so that the two packages' checkpoints carry
the same leaf.  The reference draws the refresh's randomness from its JAX
key stream (``fold_in(fold_in(rng, RNG_TAG_HESS), step)``), which PyTorch
cannot reproduce; the port derives its own from ``(rng, RNG_TAG_HESS,
step)`` with numpy, the key's two words as the seed: GNB's noise seed of
the fused sweep (:func:`hess_seed`), and a ``torch.Generator`` seeded from
it (:func:`hess_generator`) for Hutchinson's probe (:func:`hess_probe`) and
the Gumbel noise of the chunked GNB sweep.  A restored key (the port's or
the reference's) continues that stream.  ``hess_seed_fn(step)``,
``probe_fn(step, layout)`` and ``noise_fn(step, shape)`` replace those
draws; the parity tests use them to pass in the reference's.

With ``compress_grads`` the flat gradient shards go through the int8
error-feedback reduction (``distributed/compression.py``), bucketed by
``comm_bucket_elems``; with ``compress_hess`` the refresh's gradient-
valued pieces do too, stateless (GNB's and the empirical Fisher's ĝ
before squaring, Hutchinson's u ⊙ Hu); ``comm_telemetry`` adds
``comm_seconds``, ``step_seconds`` and ``exposed_comm_fraction`` to the
metrics.  Their stochastic rounding draws from seeds the port derives
from ``(rng, tag, step)`` with numpy (:func:`compress_seed`; tags
``RNG_TAG_COMPRESS`` and ``RNG_TAG_HESS_COMPRESS``, the reference's);
``compress_seed_fn(tag, step)`` replaces them.

Across processes.  On a ``(data, model)`` grid (``launch/mesh.py:
make_mesh``; with a process group and no grid, the pure data-parallel (W,
1) grid over it) each rank trains on the rows of its data coordinate
(``data.host_slice``), holds its blocks of the parameters along the model
axis (``convert.shard_params``: tensor parallelism in the dense trunk,
expert parallelism in the MoE FFN, ``distributed/tensor_parallel.py``)
and its slices of the flat m/h shards along the data axis (the engine's
``data``); parameters stay whole across data within a model block.  Each
rank's loss is its local token sum over the GLOBAL valid-token count (an
all-reduced count over data; the model ranks of one data coordinate see
the same rows), so the reduced gradient is the single process's.  One
path serves every grid, the reference's order: the raveled, unclipped
local gradients are reduced over data (reduce-scattered to the rank's
slice where the engine splits a shard, else all-reduced in fp32; or the
compressed pipeline's reduce-scatter), the global norm is taken from the
reduced values (squares summed over data for the slices, over model for
the leaves split there, a replicated leaf counted once) and clips them
(:func:`clip_reduced`), and only then are they quantized.  The engine
updates its slices and all-gathers the parameters over data.  The
refresh's sub-batch is the first ``hess_subbatch`` rows of the global
batch, split over the data ranks the same way; each runs the estimator on
its own rows only, and GNB's labels are drawn at each position's row in
the global sub-batch (the fused route's hash keyed on ``row_ids``, the
chunked route's generator draws kept at those rows), so a rank's draws
are the single process's.  A MoE model's default dispatch routes in the
global batch's groups and computes the global batch's load-balance term
on every rank (``models/moe.py``), scaled by the rank's share like its
CE: the shares sum to one, and the term's backward sums the data ranks'
shares, so the objective and its gradient are the single process's.  The
all-to-all dispatch's term is the reference's mean over the ranks of
each rank's own.  The Hutchinson HVP does not run on a model axis
(:func:`check_grid`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core import (OptimizerEngine, clip_by_global_norm, constant,
                    empirical_fisher_ghat_flat, functional_loss,
                    gnb_ghat_flat, gnb_ghat_flat_from_loss,
                    hessian_aware_optimizer, hutchinson_estimator_flat,
                    linear_warmup_cosine, subsample_batch)
from ..core.clipping import ClipState
from ..core.types import flat_tensors, leaf_parts, tree_leaves, \
    tree_unflatten
from ..data import host_slice
from ..convert import shard_params
from ..distributed import GradCompressor, world
from ..distributed.overlap import delta_seconds, stamp
from ..distributed.sharding import model_dim, resolve_grid, set_grid
from ..models import ModelConfig, get_model
from ..models.moe import MOE_IMPLS, set_moe_impl
from ..models.layers import TRAIN_ATTN_IMPLS
from ..models.transformer import REMATS
from ..serve.engine import resolve_device
from .train_state import TrainState, train_key

RNG_TAG_HESS = 1           # estimator label sampling (the reference's tag)
RNG_TAG_COMPRESS = 2       # gradient-compression stochastic rounding
RNG_TAG_HESS_COMPRESS = 3  # estimator-compression stochastic rounding
ESTIMATORS = ("gnb", "hutchinson", "empirical_fisher")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    optimizer: str = "sophia_g"
    peak_lr: float = 4e-4
    total_steps: int = 10_000
    warmup_steps: int = 2_000
    schedule: str = "cosine"           # cosine | constant
    weight_decay: float = 0.2
    beta1: float = 0.96
    beta2: float = 0.99
    gamma: float = 0.05
    eps: float = 1e-12
    hess_interval: int = 10            # k in Algorithm 3
    hess_subbatch: int = 240           # paper: 240/480 (G)
    estimator: str = "gnb"
    grad_clip: float = 1.0
    clip_threshold: float = 1.0        # Sophia rho
    grad_accum: int = 1
    remat: str = "none"                # none | full | dots | scan2
    attn_impl: str = "auto"
    fused_attn: bool = True            # flash attention (rows 16-18) while
    #                                    attn_impl is "auto"; False trains
    #                                    on the materialized-scores route
    fused_kernel: bool = False         # engine kernels (rows 2-10):
    #                                    the engine's "fused" backend
    fused_loss: bool = True            # the logits-free fused CE kernels;
    #                                    False: the plain chunked sweep
    compress_grads: bool = False       # int8 + error feedback
    compress_hess: bool = False        # int8 for the estimator's gradient-
    #                                    valued pieces too (stateless)
    comm_bucket_elems: Optional[int] = None  # gradient-collective buckets
    #                                    (distributed/overlap.py): None =
    #                                    roofline (one bucket on one rank),
    #                                    0 = one bucket, N = elements
    comm_telemetry: bool = False       # comm_seconds / step_seconds /
    #                                    exposed_comm_fraction metrics
    state_dtype: str = "float32"       # optimizer m/h dtype
    moe_impl: str = "gspmd"            # MoE dispatch on a model axis:
    #                                    "gspmd" or "a2a" (models/moe.py)
    seed: int = 0


def check_ported(tc: TrainerConfig) -> None:
    """Raise ``ValueError`` for an unknown option, rather than quietly
    running something else."""
    if tc.attn_impl not in TRAIN_ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {tc.attn_impl!r}")
    if tc.remat not in REMATS:
        raise ValueError(f"unknown remat {tc.remat!r} (one of {REMATS})")
    if tc.state_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"state_dtype {tc.state_dtype!r}")
    if tc.estimator not in ESTIMATORS:
        raise ValueError(f"unknown estimator {tc.estimator!r}")
    if tc.moe_impl not in MOE_IMPLS:
        raise ValueError(f"moe_impl {tc.moe_impl!r} is not one of "
                         f"{MOE_IMPLS}")


#: what a grid's model axis runs (ROADMAP A5b-rest names the rest)
MODEL_AXIS_FAMILIES = ("dense", "moe")


def check_grid(cfg: ModelConfig, tc: TrainerConfig, grid) -> None:
    """Raise ``NotImplementedError`` before the first step for what a grid
    with a model axis above one does not take: a family other than the
    dense and MoE ones (tensor parallelism for RWKV, Griffin and the
    encoder-decoder is ROADMAP A5b-rest), and the Hutchinson HVP, whose
    ``torch.func`` transforms do not run through the model axis's
    collectives."""
    if grid is None or grid.model <= 1:
        return
    if cfg.family not in MODEL_AXIS_FAMILIES:
        raise NotImplementedError(
            f"config {cfg.name!r}: family {cfg.family!r} has no tensor "
            f"parallelism (a model axis of {grid.model}); the grid splits "
            f"the {MODEL_AXIS_FAMILIES} families (ROADMAP A5b-rest: tensor "
            f"parallelism for RWKV, Griffin and the encoder-decoder)")
    if tc.estimator == "hutchinson":
        raise NotImplementedError(
            "the Hutchinson estimator on a model axis (torch.func's jvp of "
            "grad through the model axis's collectives is not ported)")


def make_schedule(tc: TrainerConfig):
    if tc.schedule == "constant":
        return constant(tc.peak_lr)
    return linear_warmup_cosine(tc.peak_lr, tc.total_steps, tc.warmup_steps)


def make_engine(tc: TrainerConfig, grid=None) -> OptimizerEngine:
    """Engine for ``tc.optimizer`` with the paper's per-optimizer hypers
    (the reference's table, ``trainer.py:133-155``), on the ``fused``
    backend (the engine kernels) with ``tc.fused_kernel`` and the
    ``reference`` backend without; on a ``grid`` its flat shards split over
    the data axis."""
    name = tc.optimizer
    if name in ("sophia_g", "sophia_h"):
        hypers = dict(beta1=tc.beta1, beta2=tc.beta2, gamma=tc.gamma,
                      eps=tc.eps, weight_decay=tc.weight_decay,
                      clip_threshold=tc.clip_threshold)
    elif name == "adamw":
        hypers = dict(beta1=0.9, beta2=0.95, eps=1e-8,
                      weight_decay=tc.weight_decay)
    elif name == "lion":
        hypers = dict(beta1=0.95, beta2=0.98, weight_decay=tc.weight_decay)
    elif name == "signgd":
        hypers = dict(beta1=tc.beta1, weight_decay=tc.weight_decay)
    elif name == "adahessian":
        hypers = dict(beta1=0.92, beta2=0.99, eps=1e-8,
                      weight_decay=tc.weight_decay)
    elif name == "sgd":
        hypers = dict(momentum=0.0)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    sdt = torch.bfloat16 if tc.state_dtype == "bfloat16" else torch.float32
    data = (None if grid is None
            else (grid.data, grid.d, grid.data_group))
    return OptimizerEngine(tc.optimizer, hypers=hypers,
                           backend="fused" if tc.fused_kernel
                           else "reference", state_dtype=sdt, data=data)



def _stream(rng, step: int, tag: int = RNG_TAG_HESS) -> np.random.Generator:
    """numpy's generator of stream ``tag`` at ``step``, seeded with
    ``(rng, tag, step)``; ``rng`` an int seed or a key's two words."""
    words = tuple(int(w) for w in np.atleast_1d(np.asarray(rng)))
    return np.random.default_rng(words + (tag, step))


def compress_seed(rng, tag: int, step: int) -> int:
    """The port's stochastic-rounding seed of stream ``tag``
    (``RNG_TAG_COMPRESS`` or ``RNG_TAG_HESS_COMPRESS``) at ``step``: one
    uint32 from numpy's generator seeded with ``(rng, tag, step)``."""
    return int(_stream(rng, step, tag).integers(0, 1 << 32, dtype=np.uint64))


def hess_seed(rng, step: int):
    """The port's noise seed of the refresh at ``step``: two uint32 values
    from numpy's generator seeded with ``(rng, RNG_TAG_HESS, step)``,
    ``rng`` an int seed or the state's key words."""
    bits = _stream(rng, step).integers(0, 1 << 32, size=2, dtype=np.uint64)
    return int(bits[0]), int(bits[1])


def hess_generator(rng, step: int, device) -> torch.Generator:
    """The port's generator of the refresh at ``step``: a
    ``torch.Generator`` on ``device`` seeded from numpy with ``(rng,
    RNG_TAG_HESS, step)``."""
    gen_seed = int(_stream(rng, step).integers(0, 1 << 63, dtype=np.int64))
    return torch.Generator(device=device).manual_seed(gen_seed)


def hess_probe(rng, step: int, layout, device):
    """The port's Hutchinson probe u ~ N(0, I) of the refresh at ``step``:
    one fp32 draw per flat shard (as the reference draws it, per shard)
    from :func:`hess_generator`."""
    gen = hess_generator(rng, step, device)
    return tuple(torch.randn((n,), generator=gen, dtype=torch.float32,
                             device=device) for n in layout.shard_sizes)


def to_device_batch(batch: dict, device) -> dict:
    return {key: torch.as_tensor(np.asarray(value)).to(device)
            for key, value in batch.items()}


def _count(batch: dict) -> torch.Tensor:
    """The batch's valid-token count (fp64): the mask's sum, or every
    position."""
    if "mask" in batch:
        return batch["mask"].to(torch.float64).sum()
    return torch.tensor(float(batch["tokens"].numel()), dtype=torch.float64,
                        device=batch["tokens"].device)


def _all_reduce(tensors, group) -> None:
    """In-place SUM all-reduce of each tensor, issued together; nothing
    on one rank."""
    if world(group)[0] <= 1:
        return
    works = [dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group,
                             async_op=True) for t in tensors]
    for w in works:
        w.wait()


def norm_parts(layout, tree):
    """Where each leaf's parts (a stacked leaf's layers, else the leaf)
    lie in the flat shards, in the tree's order: one list a leaf of
    ``(shard, start, stop)``, the order in which
    ``core.types.global_norm`` sums the squares."""
    out = []
    for leaf, si, off in zip(tree_leaves(tree), layout.leaf_shard,
                             layout.leaf_offset):
        parts = []
        for t in leaf_parts(leaf):
            parts.append((si, off, off + t.numel()))
            off += t.numel()
        out.append(parts)
    return out


def clip_reduced(pieces, parts, state: ClipState, max_norm: float,
                 group=None, split=None, model_group=None) -> ClipState:
    """The global-norm clip on reduced flat gradients, in place.
    ``pieces`` ``[(tensor, segmented, shard, offset)]`` cover the reduced
    shards, ``tensor`` holding elements ``offset + [0, n)`` of shard
    ``shard``: a segmented piece is this rank's part of the reduced values
    (its squares are summed over the ranks), any other is the same on
    every rank.  The squares are summed part by part in the order of
    ``parts`` (:func:`norm_parts`), so that where each part lies in one
    piece the norm is ``clip_by_global_norm``'s on the tree bit for bit.
    Scales every piece by ``max_norm / norm`` when the norm exceeds
    ``max_norm`` (the reference's rule) and returns the clip state with
    the global norm.

    On a model axis (``split`` one flag a leaf, ``model_group``) a leaf
    split over model sums its squares over the model ranks, and a
    replicated one counts once."""
    flat = [rng for leaf in parts for rng in leaf]
    by_shard: dict = {}
    for k, (si, a, b) in enumerate(flat):
        by_shard.setdefault(si, []).append((k, a, b))
    sq_seg = [[] for _ in flat]
    sq_all = [[] for _ in flat]
    for t, seg, si, lo in pieces:
        hi = lo + t.numel()
        for k, a, b in by_shard.get(si, ()):
            a, b = max(a, lo), min(b, hi)
            if a < b:
                (sq_seg if seg else sq_all)[k].append(
                    t[a - lo:b - lo].square().sum())
    if any(seg for _, seg, _, _ in pieces):
        zero = torch.zeros((), dtype=torch.float32,
                           device=pieces[0][0].device)
        vec = torch.stack([sum(x[1:], x[0]) if x else zero for x in sq_seg])
        _all_reduce([vec], group)
        for k, x in enumerate(vec.unbind(0)):
            sq_all[k].append(x)
    sums, k = [], 0
    for leaf in parts:
        s = 0
        for _ in leaf:
            x = sq_all[k]
            s = s + sum(x[1:], x[0])
            k += 1
        sums.append(s)
    if split is not None and any(split):
        # the split leaves' squares summed over the model ranks
        flags = torch.tensor(split, device=pieces[0][0].device)
        vec = torch.stack([torch.as_tensor(x, dtype=torch.float32,
                                           device=flags.device)
                           for x in sums])
        part = torch.where(flags, vec, torch.zeros_like(vec))
        _all_reduce([part], model_group)
        sums = list(torch.where(flags, part, vec).unbind(0))
    total = None
    for s in sums:
        total = s if total is None else total + s
    norm = torch.sqrt(total)
    trigger = norm > max_norm
    scale = torch.where(trigger, max_norm / (norm + 1e-16),
                        torch.ones_like(norm))
    for t, *_ in pieces:
        t.mul_(scale)
    return ClipState(state.count + 1,
                     state.triggers + trigger.to(torch.int32), norm)


def make_train_fns(cfg: ModelConfig, tc: TrainerConfig, *, device=None,
                   hess_seed_fn: Optional[Callable] = None,
                   probe_fn: Optional[Callable] = None,
                   noise_fn: Optional[Callable] = None,
                   compress_seed_fn: Optional[Callable] = None,
                   group=None, grid=None):
    """Returns ``(init_fn, train_step)``.  ``hess_seed_fn(step)`` replaces
    GNB's noise seed of the fused sweep, ``probe_fn(step, layout)``
    Hutchinson's probe shards (:func:`hess_seed`, :func:`hess_probe`),
    ``noise_fn(step, shape)`` the Gumbel noise of the chunked GNB sweep
    (``fused_loss=False``): the whole (B, S, Vp) tensor of the sub-batch's
    logits, in place of draws from :func:`hess_generator` on the state's
    key, and ``compress_seed_fn(tag, step)`` the stochastic-rounding seeds
    (:func:`compress_seed`).

    ``group``: the process group of a data-parallel run (the default
    group when one is initialized); each rank then passes ``train_step``
    its rows of the global batch (``data.host_slice``).  ``grid``: a
    ``(data, model)`` grid (``launch/mesh.py:make_mesh``) in its place:
    each rank passes the rows of its data coordinate, holds its blocks of
    the parameters along the model axis and its slices of the flat
    optimizer shards along the data axis.

    ``init_fn(params=None) -> TrainState``: random parameters from a
    ``torch.Generator`` seeded with ``tc.seed`` on the device, or the given
    ``Transformer``, the whole tree in both cases (on a grid the rank keeps
    its blocks, ``convert.shard_params``, so every grid trains the weights
    one process would); the key ``train_key(tc.seed)``.
    ``train_step(state, batch, do_refresh) -> (state, metrics)``: one step
    on a batch of device tensors; the parameters are updated in place."""
    check_ported(tc)
    grid = resolve_grid(grid, group)
    check_grid(cfg, tc, grid)
    set_moe_impl(tc.moe_impl)
    device = resolve_device(device)
    model = get_model(cfg)
    engine = make_engine(tc, grid)
    schedule = make_schedule(tc)
    clipper = clip_by_global_norm(tc.grad_clip)
    compressor = GradCompressor() if tc.compress_grads else None
    hess_compressor = GradCompressor() if tc.compress_hess else None
    # the data axis: its size, this rank's coordinate, its group (the
    # rows, the loss scale and the gradient reduction); model ranks of one
    # data coordinate see the same rows
    ndev, rank = (grid.data, grid.d) if grid is not None else (1, 0)
    group = grid.data_group if grid is not None else None
    model_group = grid.model_group if grid is not None else None
    set_grid(grid)
    # fused_attn applies only while attn_impl is "auto"; an explicit impl
    # wins (the reference's mapping, trainer.py:216-221)
    attn_impl = (tc.attn_impl if tc.attn_impl != "auto"
                 else ("flash" if tc.fused_attn else "auto"))
    # the HVP differentiates twice (forward over reverse): it takes the
    # attention and loss twins, as the reference does (trainer.py:222,278)
    hvp_attn_impl = "flash_jvp" if attn_impl == "flash" else attn_impl
    loss_impl = "fused" if tc.fused_loss else "chunked"
    hvp_loss_impl = "fused_jvp" if tc.fused_loss else "chunked"

    def cseed(state, tag):
        if compress_seed_fn is not None:
            return compress_seed_fn(tag, state.step)
        return compress_seed(state.rng, tag, state.step)

    def init_fn(params=None) -> TrainState:
        if params is None:
            gen = torch.Generator(device=device).manual_seed(tc.seed)
            params = model.init_params(cfg, gen)
        if grid is not None:
            params = shard_params(params, grid)
        tree = params.param_tree()
        comp = (compressor.init_shards(engine.layout(tree), device=device,
                                       group=group)
                if compressor is not None else ())
        return TrainState(step=0, params=params, opt_state=engine.init(tree),
                          clip_state=clipper.init(tree),
                          rng=train_key(tc.seed), comp_state=comp)

    def grads_of(params, batch):
        """(loss, metrics, grads as a flat tensor list): the mean over
        ``tc.grad_accum`` microbatches.  Data parallel, each microbatch's
        loss is scaled by this rank's share of the global valid tokens,
        and the loss and metrics are all-reduced (the gradients are not:
        the caller reduces them)."""
        tensors = flat_tensors(params.param_tree())
        n = tc.grad_accum
        micro = ([batch] if n <= 1 else
                 [{k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                   for k, v in batch.items()} for i in range(n)])
        share = None
        if ndev > 1:
            local = torch.stack([_count(mb) for mb in micro])
            total = local.clone()
            _all_reduce([total], group)
            share = (local / total).to(torch.float32)
        loss_sum, met_sum, g_sum = None, None, None
        for i, mb in enumerate(micro):
            loss, met = model.loss_fn(cfg, params, mb, attn_impl=attn_impl,
                                      remat=tc.remat, loss_impl=loss_impl)
            if share is not None:
                loss = loss * share[i]
                met = {k: v * share[i] for k, v in met.items()}
            # zeros for a parameter the batch does not reach (patch_proj
            # on a text-only batch), as from jax.grad
            g = torch.autograd.grad(loss, tensors, materialize_grads=True)
            loss = loss.detach()
            met = {k: v.detach() for k, v in met.items()}
            if loss_sum is None:
                loss_sum, met_sum, g_sum = loss, met, list(g)
            else:
                loss_sum = loss_sum + loss
                met_sum = {k: met_sum[k] + met[k] for k in met}
                g_sum = [a + b for a, b in zip(g_sum, g)]
        if ndev > 1:
            keys = sorted(met_sum)
            vec = torch.stack([loss_sum] + [met_sum[k] for k in keys])
            _all_reduce([vec], group)
            loss_sum = vec[0]
            met_sum = {k: vec[1 + j] for j, k in enumerate(keys)}
        if n <= 1:
            return loss_sum, met_sum, g_sum
        inv = 1.0 / n
        return (loss_sum * inv, {k: v * inv for k, v in met_sum.items()},
                [g * inv for g in g_sum])

    def reduce_shards(g_sh):
        """(the rank's reduced shards, their clip pieces): the fp32
        reduction over the data axis, reduce-scattered to the rank's slice
        where the engine splits a shard, all-reduced where it does not."""
        out, pieces = [], []
        for i, g in enumerate(g_sh):
            a, b = engine.data_slice(g.numel())
            if (a, b) == (0, g.numel()):
                _all_reduce([g], group)
                out.append(g)
                pieces.append((g, False, i, 0))
                continue
            seg = torch.empty((b - a,), dtype=g.dtype, device=g.device)
            dist.reduce_scatter_tensor(seg, g.contiguous(), group=group)
            out.append(seg)
            pieces.append((seg, True, i, a))
        return tuple(out), pieces

    def own_slices(g_sh):
        """The rank's data slice of each whole reduced shard."""
        return tuple(g[slice(*engine.data_slice(g.numel()))] for g in g_sh)

    def split_leaves(params):
        """One flag a leaf: whether it is split over the model axis."""
        if grid is None or grid.model <= 1:
            return None
        return [model_dim(p) is not None
                for p in tree_leaves(params.placements)]

    def reduce_estimate(g_sh, share, state):
        """The refresh's gradient-valued pieces, scaled by this rank's
        share and reduced over the data axis (int8 and stateless with
        ``compress_hess``), the rank's slices of them; unchanged on one
        process without it."""
        if ndev > 1:
            g_sh = tuple(g * share for g in g_sh)
        if hess_compressor is not None:
            return own_slices(hess_compressor.allreduce_shards_stateless(
                g_sh, cseed(state, RNG_TAG_HESS_COMPRESS), group=group,
                bucket_elems=tc.comm_bucket_elems))
        return reduce_shards(g_sh)[0]

    def global_share(local):
        """(this rank's share of the global count, the global count)."""
        if ndev <= 1:
            return 1.0, local
        total = local.to(torch.float64).clone()
        _all_reduce([total], group)
        return (local / total).to(torch.float32), total.to(torch.float32)

    def estimate_flat(params, batch, state):
        """(estimate shards, scale) on the estimator sub-batch, dispatched
        on ``tc.estimator`` (the reference's ``_estimate_flat``), with the
        refresh's randomness from the state's key."""
        step, rng = state.step, state.rng
        tree = params.param_tree()
        lay = engine.layout(tree)
        # data parallel: this rank's rows of the global sub-batch are rows
        # rank, rank + W, ... of it (data.host_slice); row_ids is each of
        # their positions' row in the flattened global sub-batch
        row_ids, hs = None, None
        if ndev > 1:
            hs = tc.hess_subbatch or len(batch["tokens"]) * ndev
            if hs % ndev:
                raise ValueError(f"hess_subbatch {hs} is not a multiple of "
                                 f"the {ndev} ranks")
            sub = subsample_batch(batch, hs // ndev)
            S = sub["tokens"].shape[1]
            index = torch.arange(rank, hs, ndev, device=device)
            row_ids = (index[:, None] * S
                       + torch.arange(S, device=device)).reshape(-1)
        else:
            sub = (subsample_batch(batch, tc.hess_subbatch)
                   if tc.hess_subbatch else batch)
        if tc.estimator == "gnb" and tc.fused_loss:
            def sampled_loss():
                seed = (hess_seed_fn(step) if hess_seed_fn
                        else hess_seed(rng, step))
                draws = {} if row_ids is None else {"row_ids": row_ids}
                return model.sampled_loss_fn(cfg, params, sub, seed,
                                             attn_impl=attn_impl,
                                             remat=tc.remat, **draws)

            g_sh, n_valid = gnb_ghat_flat_from_loss(sampled_loss, tree, lay)
            share, total = global_share(n_valid)
            g_sh = reduce_estimate(g_sh, share, state)
            return tuple(g * g for g in g_sh), total
        if tc.estimator == "gnb":
            # the sub-batch's logits materialized, one chunked sweep
            def logits(_):
                return model.logits_fn(cfg, params, sub, attn_impl=attn_impl,
                                       remat=tc.remat)

            lead = tuple(sub["tokens"].shape)
            draw_rows = None
            if noise_fn:
                noise = noise_fn(step, (hs or lead[0],) + lead[1:]
                                 + (cfg.padded_vocab,))
                if row_ids is not None:
                    noise = noise.reshape(-1, cfg.padded_vocab)[
                        row_ids.to(noise.device)].reshape(
                            lead + (cfg.padded_vocab,))
                gen = None
            else:
                noise, gen = None, hess_generator(rng, step, device)
                if row_ids is not None:
                    draw_rows = (hs * lead[1], row_ids)
            g_sh, n_valid = gnb_ghat_flat(logits, tree, gen, lay,
                                          mask=sub.get("mask"), noise=noise,
                                          draw_rows=draw_rows)
            share, total = global_share(n_valid)
            g_sh = reduce_estimate(g_sh, share, state)
            return tuple(g * g for g in g_sh), total
        share, _ = global_share(_count(sub).to(torch.float32))
        if tc.estimator == "hutchinson":
            # no remat under torch.func (see the module docstring)
            loss = functional_loss(
                params, flat_tensors(tree),
                lambda m: model.loss_fn(cfg, m, sub, attn_impl=hvp_attn_impl,
                                        remat="none",
                                        loss_impl=hvp_loss_impl)[0])
            probe = (probe_fn(step, lay) if probe_fn
                     else hess_probe(rng, step, lay, device))
            est = hutchinson_estimator_flat(loss, tree, probe, lay)
            return reduce_estimate(est, share, state), 1.0
        # empirical Fisher: B counts the sub-batch's positions
        def loss():
            return model.loss_fn(cfg, params, sub, attn_impl=attn_impl,
                                 remat=tc.remat, loss_impl=loss_impl)[0]

        lead = sub[sorted(sub)[0]]
        n = lead.shape[0] * (lead.shape[1] if lead.dim() > 1 else 1) * ndev
        g_sh = reduce_estimate(empirical_fisher_ghat_flat(loss, tree, lay),
                               share, state)
        return tuple(g * g for g in g_sh), float(n)

    def reduce_grads(state, tree, g_flat):
        """(gradient shards, clip state, compression state, telemetry):
        the unclipped local gradients raveled and reduced, then clipped on
        the reduced values (the compressed pipeline runs the clip between
        its reduce-scatter and its quantize)."""
        comp_state, tele, clipped = state.comp_state, None, []
        parts = norm_parts(engine.layout(tree), tree)

        def clip(pieces):
            clipped.append(clip_reduced(pieces, parts, state.clip_state,
                                        tc.grad_clip, group,
                                        split_leaves(state.params),
                                        model_group))

        g_sh = engine.ravel_grads(tree, tree_unflatten(tree, g_flat))
        if compressor is None:
            g_sh, pieces = reduce_shards(g_sh)
            clip(pieces)
            return g_sh, clipped[0], comp_state, tele
        out = compressor.allreduce_shards(
            g_sh, comp_state, cseed(state, RNG_TAG_COMPRESS), group=group,
            bucket_elems=tc.comm_bucket_elems,
            telemetry=tc.comm_telemetry, before_quantize=clip)
        if tc.comm_telemetry:
            g_sh, comp_state, tele = out
        else:
            g_sh, comp_state = out
        return own_slices(g_sh), clipped[0], comp_state, tele

    def train_step(state: TrainState, batch, do_refresh=False):
        """One step (Algorithm 3 lines 6-13, the refresh on the flag)."""
        # the layers read the grid and the dispatch from module state,
        # which another trainer in the process may have set
        set_grid(grid)
        set_moe_impl(tc.moe_impl)
        t_step0 = stamp(device) if tc.comm_telemetry else None
        params = state.params
        tree = params.param_tree()
        loss, metrics, g_flat = grads_of(params, batch)
        g_sh, clip_state, comp_state, tele = reduce_grads(state, tree,
                                                          g_flat)
        del g_flat
        # the shards carry the gradient from here: the trees go before the
        # refresh and the update allocate theirs (two parameter-sized
        # buffers, ~12 GB at 1.5 B parameters)
        lr = schedule(state.opt_state.count)
        if do_refresh and engine.hessian_aware:
            est_sh, scale = estimate_flat(params, batch, state)
            _, opt_state = engine.step_with_refresh(
                state.opt_state, tree, g_sh, lr, est_sh, scale, True)
        else:
            _, opt_state = engine.step_shards(state.opt_state, tree, g_sh,
                                              lr)
        metrics = dict({"loss": loss}, **metrics,
                       grad_norm=clip_state.last_norm,
                       clip_triggers=clip_state.triggers, lr=lr)
        if engine.tracks_clip_fraction:
            metrics["sophia_clip_fraction"] = opt_state.clip_fraction
        if tc.comm_telemetry:
            # comm_seconds: the comm window, first bucket issued to last
            # dequantized (an upper bound on exposed communication)
            step_s = delta_seconds(t_step0, stamp(device))
            comm_s = tele["comm_seconds"] if tele is not None else 0.0
            metrics["comm_seconds"] = comm_s
            metrics["step_seconds"] = step_s
            metrics["exposed_comm_fraction"] = comm_s / max(step_s, 1e-9)
        return TrainState(step=state.step + 1, params=params,
                          opt_state=opt_state, clip_state=clip_state,
                          rng=state.rng, comp_state=comp_state), metrics

    return init_fn, train_step


def train_loop(cfg: ModelConfig, tc: TrainerConfig, source, *,
               num_steps: int, state: Optional[TrainState] = None,
               device=None, hess_seed_fn: Optional[Callable] = None,
               probe_fn: Optional[Callable] = None,
               noise_fn: Optional[Callable] = None,
               compress_seed_fn: Optional[Callable] = None,
               callback: Optional[Callable] = None, start_step: int = 0,
               group=None, grid=None):
    """The loop: the batch of step t from ``source.batch_at(t)`` (the rows
    of this rank's data coordinate when a process group is initialized)
    and the refresh at ``t % hess_interval == 0``.  Returns ``(state,
    history)``, the history one dict of floats per step."""
    device = resolve_device(device)
    init_fn, train_step = make_train_fns(cfg, tc, device=device,
                                         hess_seed_fn=hess_seed_fn,
                                         probe_fn=probe_fn,
                                         noise_fn=noise_fn,
                                         compress_seed_fn=compress_seed_fn,
                                         group=group, grid=grid)
    if state is None:
        state = init_fn()
    grid = resolve_grid(grid, group)
    ndev, rank = (grid.data, grid.d) if grid is not None else (1, 0)
    needs_hess = hessian_aware_optimizer(tc.optimizer)
    history = []
    for t in range(start_step, start_step + num_steps):
        batch = source.batch_at(t)
        if ndev > 1:
            batch = host_slice(batch, rank, ndev)
        batch = to_device_batch(batch, device)
        state, metrics = train_step(state, batch,
                                    needs_hess and t % tc.hess_interval == 0)
        history.append({k: float(v) for k, v in metrics.items()})
        if callback is not None:
            callback(t, state, metrics)
    return state, history
