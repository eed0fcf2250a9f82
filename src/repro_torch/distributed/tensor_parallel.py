"""Tensor and expert parallelism over the model axis of a grid: Megatron's
column/row split with explicit collectives, where the reference lets GSPMD
place them from its sharding table (``distributed/sharding.py``).

Two conjugate functions bracket every split region, over the grid's model
group:

    copy_to_model      identity forward, SUM all-reduce backward
    reduce_from_model  SUM all-reduce forward, identity backward

The residual stream is replicated over model.  A column-parallel
projection (``wq``/``wk``/``wv`` and their biases, ``w_gate``/``w_up``/
``b_up``) reads ``copy_to_model(x)``, so that the input's gradient sums
every rank's part; a row-parallel one (``wo``, ``w_down``) ends in
``reduce_from_model``, and a replicated bias (``b_down``) is added after
the sum.  Each rank's attention runs on its heads (``H/M`` query and
``Hkv/M`` KV heads) through the same routes, the flash kernels among them.
A replicated leaf used inside a region on a rank-dependent input (a KV
head replicated over model, the router under the all-to-all dispatch)
reads ``copy_to_model(w)``: its gradient is the sum of the ranks' parts,
the same on every rank.

``gather_from_model`` all-gathers along a dim and, backward, takes the
rank's block of the gradient: the input of the gather is a block of a
leaf whose consumers run the same on every model rank (the unembedding
before the CE kernels), so the whole gradient is already on every rank.

With no grid, or a model axis of one, every function here is the
identity, and the model runs as on one process.

The model axis's functions have no forward-mode rule: the Hutchinson HVP
(``torch.func.jvp`` of ``grad``) does not run on a model axis.
:func:`sum_over_data` (the MoE load-balance term's sums over the data
axis) has one.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .sharding import active_grid, attention_split


def _group():
    return active_grid().model_group


# CUDA events around each model-axis collective while comm_timing(True)
_TIMING = {"events": None}


def comm_timing(on: bool) -> None:
    """Record a (start, end) pair of CUDA events around every collective
    of the model axis (none on the CPU) until switched off;
    :func:`comm_ms` sums their spans."""
    _TIMING["events"] = [] if on else None


def comm_ms() -> float:
    """The summed span of the recorded collectives, in ms (synchronizes)."""
    ev = _TIMING["events"] or []
    if ev:
        ev[-1][1].synchronize()
    return sum(a.elapsed_time(b) for a, b in ev)


def collective(fn, *args, **kw):
    """``fn(*args, **kw)``, timed by CUDA events when
    :func:`comm_timing` is on and the tensors are on the card."""
    ev = _TIMING["events"]
    if ev is None or not torch.cuda.is_available() or \
            not args[0].is_cuda:
        return fn(*args, **kw)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn(*args, **kw)
    b.record()
    ev.append((a, b))
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        collective(dist.all_reduce, g, group=_group())
        return g


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.contiguous().clone()
        collective(dist.all_reduce, x, group=_group())
        return x

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        grid = active_grid()
        ctx.dim, ctx.m, ctx.n = dim, grid.m, x.shape[dim]
        x = x.contiguous()
        out = torch.empty((grid.model * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        collective(dist.all_gather_into_tensor, out, x,
                   group=grid.model_group)
        return out if dim == 0 else torch.cat(out.chunk(grid.model), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.m * ctx.n, ctx.n).contiguous(), None


def _split() -> bool:
    grid = active_grid()
    return grid is not None and grid.model > 1


def copy_to_model(x):
    return _CopyToModel.apply(x) if _split() else x


def reduce_from_model(x):
    return _ReduceFromModel.apply(x) if _split() else x


def gather_from_model(x, dim: int):
    return _GatherFromModel.apply(x, dim) if _split() else x


class _SumOverData(torch.autograd.Function):
    """SUM all-reduce over the data group forward, backward and in forward
    mode: the sum is a value that every data rank's share of the loss
    reads, so the gradient of a rank's input sums every rank's."""

    @staticmethod
    def forward(x):
        x = x.contiguous().clone()
        collective(dist.all_reduce, x, group=active_grid().data_group)
        return x

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return _SumOverData.apply(g)

    @staticmethod
    def jvp(ctx, t):
        return _SumOverData.apply(t)


def sum_over_data(x):
    """``x`` summed over the active grid's data ranks (differentiable; the
    identity with one data rank)."""
    grid = active_grid()
    if grid is None or grid.data <= 1:
        return x
    return _SumOverData.apply(x)


def reduce_scalar_mean(x):
    """The mean over the model ranks of a per-rank scalar (all-reduce
    forward; backward, each rank's share of the gradient): the reference's
    ``pmean`` over model."""
    if not _split():
        return x
    return _ReduceFromModel.apply(x) / active_grid().model


# ---------------------------------------------------------------------------
# the split layers


def local_attention_cfg(cfg, M: int):
    """The config one model rank's attention runs with: its query and KV
    heads (:func:`~repro_torch.distributed.sharding.attention_split`), the
    head dim fixed."""
    import dataclasses
    split = attention_split(cfg, M)
    if M <= 1 or split == "none":
        return cfg
    hkv = cfg.n_kv_heads // M if split == "heads" else 1
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // M, n_kv_heads=hkv,
                               head_dim=cfg.hd)


def attention_params(p, cfg, grid):
    """The rank's attention leaves as the layer functions read them: its
    blocks as stored, and with a "query" split its one KV head cut from the
    replicated ``wk``/``wv`` (and ``bk``/``bv``) through
    :func:`copy_to_model`."""
    if attention_split(cfg, grid.model) != "query":
        return p
    hd, G = cfg.hd, cfg.n_heads // cfg.n_kv_heads
    kv = (grid.m * (cfg.n_heads // grid.model)) // G
    out = {name: p[name] for name in p.keys()}
    for name in ("wk", "wv", "bk", "bv"):
        if name in out:
            w = copy_to_model(out[name])
            out[name] = w[..., kv * hd:(kv + 1) * hd]
    return out


def split_attention(attn_fn, p, x, cfg, **kw):
    """One attention call split over the model axis: ``attn_fn(p, x, cfg,
    **kw)`` (a training route of ``models/layers.py``) on the rank's heads,
    its output projection's partial sums reduced.  With a "none" split the
    whole block runs on every rank."""
    grid = active_grid()
    M = grid.model
    if attention_split(cfg, M) == "none":
        return attn_fn(p, x, cfg, **kw)
    out = attn_fn(attention_params(p, cfg, grid), copy_to_model(x),
                  local_attention_cfg(cfg, M), **kw)
    return reduce_from_model(out)


def split_mlp(mlp_fn, p, x, cfg):
    """The MLP split over the model axis: column-parallel up projections,
    a row-parallel ``w_down`` whose partial sums are reduced, then the
    replicated ``b_down`` (GELU)."""
    inner = {name: p[name] for name in p.keys() if name != "b_down"}
    if "b_down" in p:
        inner["b_down"] = torch.zeros_like(p["b_down"])
    out = reduce_from_model(mlp_fn(inner, copy_to_model(x), cfg))
    if "b_down" in p:
        out = out + p["b_down"].to(out.dtype)
    return out
