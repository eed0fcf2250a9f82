"""Mixture-of-Experts FFN: token-choice top-k routing with capacity-bounded,
sort-based dispatch, in plain PyTorch.

The counterpart of ``repro/models/moe.py``: ``moe_ffn`` is its
``moe_ffn_gspmd`` (the default dispatch, ``set_moe_impl("gspmd")``) and
``moe_ffn_a2a`` its all-to-all dispatch (``set_moe_impl("a2a")``).  The
reference has no kernel here: its expert products are batched matmuls,
and so are the port's.

On a grid (``distributed/sharding.py``) the default dispatch is the one
process's function of the global batch.  Its data axis: a data rank
holds rows d, d + W, ... of the global batch, and the groups are the
global batch's, so where a group spans ranks (S not a multiple of the
group size) the expert ids are all-gathered over data and each entry
takes its slot in its global group; the rank's buffer holds every group
with a token of its own, so its expert products run on up to W times the
rows of its own entries (the reference's GSPMD gathers the whole
dispatch to every data rank).  The load-balance term's probability sums
and expert counts are summed over data (``sum_over_data``, whose
backward sums every data rank's share), so ``aux`` is the global
batch's on every rank.  Its model axis: each rank holds E/M experts,
routes every token of its data rank (the same routing on every model
rank, so the same drops as one process), runs its own experts' entries
and reduces the combine over model; the gates enter the split region
through ``copy_to_model``, so the router's gradient is the sum of the
ranks' parts.  ``moe_ffn_a2a`` is the reference's algorithm
with ``all_to_all_single`` over the model group: each model rank routes
1/M of the tokens, sends them to their experts' ranks in fixed-capacity
buffers, runs its experts under a second capacity (factor 1.25), sends
the outputs back and all-gathers the tokens over model; its ``aux`` is
the mean over the model ranks (the data ranks' mean is the trainer's
token share), and the router, fed different tokens on each rank, reads
``copy_to_model``.  It runs where the reference's would: a model axis
that divides ``n_experts``, else the default dispatch.  Shared experts
are split like a dense MLP.

  * The router runs in fp32: softmax over the experts, the top k by a
    stable descending sort, so that among equal probabilities the lowest
    expert index comes first, as ``jax.lax.top_k`` orders them.  With
    k > 1 the selected gates are renormalised over ``max(sum, 1e-9)``.
  * The load-balance loss is ``router_aux_coef * E * sum(me * ce)``: ``me``
    the mean router probability of each expert, ``ce`` the share of the
    T * k choices it got (from indices, so it carries no gradient).
  * Tokens are viewed as G groups of ``GROUP_SIZE`` (one group when there
    are fewer).  Within a group an entry's slot is its rank among the
    group's entries that chose the same expert, in token order (a stable
    argsort and ``searchsorted``); entries at or past the group's capacity
    ``Cg`` are dropped and contribute zero.
  * Dispatch writes each kept entry into an (E, G * Cg, D) buffer by
    assignment: every (expert, slot) holds at most one kept entry, so this
    is the reference's scatter-add of zeros bit for bit; dropped entries
    go to a spare row that is cut off.  The experts are SwiGLU, their
    weights cast to the compute dtype at their use.
  * Combine gathers each entry's expert output, scales it by its gate and
    adds a token's k contributions in k order (no atomic ``index_add_``,
    whose order on the card is not fixed).  Shared experts are a dense
    SwiGLU of width ``d_ff * n_shared_experts`` on every token.

No tensor that can carry a tangent is written in place, so the function
runs under ``torch.func`` (Sophia-H's HVP is ``jvp`` of ``grad``).
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..distributed.sharding import active_grid, model_parallel
from ..distributed.tensor_parallel import (collective, copy_to_model,
                                           gather_from_model,
                                           reduce_from_model,
                                           reduce_scalar_mean, sum_over_data)
from .common import ModelConfig
from .layers import dense_init

GROUP_SIZE = 4096  # tokens per assignment group
MOE_IMPLS = ("gspmd", "a2a")

# dispatch on a model axis: "gspmd" (the default) or "a2a"
_MOE_IMPL = {"impl": "gspmd"}


def set_moe_impl(impl: str) -> None:
    if impl not in MOE_IMPLS:
        raise ValueError(f"moe impl {impl!r} is not one of {MOE_IMPLS}")
    _MOE_IMPL["impl"] = impl


def get_moe_impl() -> str:
    return _MOE_IMPL["impl"]

# the list that moe_ffn appends each call's routing to, while
# record_routing() is active
_RECORD = {"calls": None}


@contextlib.contextmanager
def record_routing():
    """Collect the routing of every :func:`moe_ffn` call made inside the
    block: yields a list that gets one dict per call, the router's
    ``probs`` (T, E) fp32, ``expert_idx`` (T, k) and ``keep`` (T * k,)
    bool, detached on the input's device (``moe_ffn_a2a``: its rank's
    tokens' ``expert_idx`` and ``keep``, kept by both stages)."""
    calls = []
    prev, _RECORD["calls"] = _RECORD["calls"], calls
    try:
        yield calls
    finally:
        _RECORD["calls"] = prev


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The reference's leaves: ``router`` (D, E), ``w_gate``/``w_up`` (E, D,
    F), ``w_down`` (E, F, D) and, with shared experts, ``shared`` {w_gate,
    w_up (D, Fs), w_down (Fs, D)} with Fs = F * n_shared_experts."""
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": dense_init(gen, (D, E)),
         "w_gate": dense_init(gen, (E, D, F_)),
         "w_up": dense_init(gen, (E, D, F_)),
         "w_down": dense_init(gen, (E, F_, D), in_axis=1)}
    if cfg.n_shared_experts:
        Fs = F_ * cfg.n_shared_experts
        p["shared"] = {"w_gate": dense_init(gen, (D, Fs)),
                       "w_up": dense_init(gen, (D, Fs)),
                       "w_down": dense_init(gen, (Fs, D), in_axis=0)}
    return p


def _group_capacity(sg: int, k: int, n_experts: int, factor: float) -> int:
    """Slots per expert in a group of ``sg`` tokens: ``sg * k * factor / E``
    rounded up to a multiple of 8, at least 8."""
    c = int(sg * k * factor / n_experts)
    return max(8, (c + 7) // 8 * 8)


def _slots_in_group(e_g: torch.Tensor) -> torch.Tensor:
    """e_g (..., N) expert ids -> each entry's slot in its expert: its rank
    among the same row's entries with that id, in order (int64)."""
    e_sorted, order = torch.sort(e_g, dim=-1, stable=True)
    first = torch.searchsorted(e_sorted.contiguous(), e_sorted.contiguous(),
                               side="left")
    pos = torch.arange(e_g.shape[-1], device=e_g.device) - first
    return torch.empty_like(pos).scatter_(-1, order, pos)


def _route(p, xt, cfg: ModelConfig, router=None, over_data=False):
    """(probs, expert_idx, gate_vals, aux) of tokens xt (T, D): the router
    in fp32, the top k by a stable sort (ties to the lowest index), the
    gates renormalised with k > 1, and the load-balance loss; with
    ``over_data`` the loss of the whole batch, its probability sums and
    expert counts summed over the active grid's data ranks."""
    E, K = cfg.n_experts, cfg.moe_top_k
    T = xt.shape[0]
    router = p["router"] if router is None else router
    probs = torch.softmax(xt.to(torch.float32) @ router.to(torch.float32),
                          dim=-1)
    expert_idx = torch.sort(probs.detach(), dim=-1, descending=True,
                            stable=True).indices[:, :K]
    gate_vals = probs.gather(-1, expert_idx)
    if K > 1:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # counts by an integer scatter-add: bincount would read the largest
    # index back to the host, a sync per layer on the card
    flat_e = expert_idx.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int64, device=xt.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    if over_data:
        grid = active_grid()
        collective(dist.all_reduce, counts, group=grid.data_group)
        T = T * grid.data
        me = sum_over_data(probs.sum(0)) / T
    else:
        me = probs.mean(0)
    ce = counts.to(torch.float32) * (1.0 / (T * K))
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)
    return probs, expert_idx, gate_vals, aux


def _experts(p, buf, dt):
    """The SwiGLU experts over buf (E', C, D) -> (E' * C, D)."""
    g = F.silu(torch.bmm(buf, p["w_gate"].to(dt)))
    u = torch.bmm(buf, p["w_up"].to(dt))
    return torch.bmm(g * u, p["w_down"].to(dt)).reshape(-1, buf.shape[-1])


def _shared(p, xt, dt):
    """The shared experts' dense SwiGLU (the rank's block of its width on a
    model axis: a partial sum there)."""
    sp = p["shared"]
    sg = F.silu(xt @ sp["w_gate"].to(dt))
    return (sg * (xt @ sp["w_up"].to(dt))) @ sp["w_down"].to(dt)


def _global_slots(expert_idx, B: int, S: int, Gsz: int, grid):
    """(slot, group, G) of each of a data rank's entries in the groups of
    the global batch, whose rows d, d + W, ... are the rank's
    (``data.host_slice``): the expert ids all-gathered over data, each
    entry's slot among its global group's, and its group's index among
    the G groups that hold the rank's tokens."""
    W, d, K = grid.data, grid.d, expert_idx.shape[1]
    dev = expert_idx.device
    ids = torch.empty((W * expert_idx.shape[0], K), dtype=expert_idx.dtype,
                      device=dev)
    collective(dist.all_gather_into_tensor, ids, expert_idx.contiguous(),
               group=grid.data_group)
    glob = ids.view(W, B, S, K).transpose(0, 1).reshape(-1, Gsz * K)
    slot = _slots_in_group(glob).view(B, W, S, K)[:, d].reshape(-1)
    n_held = len({g for j in range(B) for g in range(
        (j * W + d) * S // Gsz, ((j * W + d + 1) * S - 1) // Gsz + 1)})
    tok = ((torch.arange(B, device=dev)[:, None] * W + d) * S
           + torch.arange(S, device=dev)).reshape(-1)
    # the global groups rise along the rank's tokens: a token's index among
    # the held ones counts the changes before it (no copy from the host)
    g = tok // Gsz
    group = torch.cat([g.new_zeros(1), (g[1:] != g[:-1]).long()]).cumsum(0)
    return slot, group.repeat_interleave(K), n_held


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux fp32 scalar).  With
    more than ``GROUP_SIZE`` tokens their count must be a multiple of it
    (the reference's reshape into groups fails otherwise).  On a grid, x
    is the data rank's rows of the global batch (``data.host_slice``), and
    the routing groups, drops and ``aux`` are the global batch's; on a
    model axis, the installed dispatch (:func:`set_moe_impl`)."""
    M = model_parallel()
    if M > 1 and _MOE_IMPL["impl"] == "a2a" and cfg.n_experts % M == 0:
        return moe_ffn_a2a(p, x, cfg)
    dt = x.dtype
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    T = B * S
    grid = active_grid()
    W = 1 if grid is None else grid.data
    Gsz = min(GROUP_SIZE, T * W)
    if T * W % Gsz:
        raise ValueError(f"{T * W} tokens do not split into groups of {Gsz}")
    Cg = _group_capacity(Gsz, K, E, cfg.capacity_factor)
    xt = x.reshape(T, D)
    probs, expert_idx, gate_vals, aux = _route(p, xt, cfg,
                                               over_data=W > 1)
    flat_e = expert_idx.reshape(-1)

    if S % Gsz == 0 or W == 1:
        # every group lies within the rank's rows
        G = T // Gsz
        slot = _slots_in_group(expert_idx.reshape(G, Gsz * K)).reshape(-1)
        g_idx = torch.arange(T * K, device=x.device) // (Gsz * K)
    else:
        slot, g_idx, G = _global_slots(expert_idx, B, S, Gsz, grid)
    keep = slot < Cg
    if _RECORD["calls"] is not None:
        _RECORD["calls"].append({"probs": probs.detach(),
                                 "expert_idx": expert_idx.detach(),
                                 "keep": keep.detach()})
    # on a model axis the rank's experts are [lo, lo + E_loc): its entries
    # only, the rest zero, the combine reduced over model
    E_loc = p["w_gate"].shape[0]
    lo = active_grid().m * E_loc if M > 1 else 0
    if M > 1:
        keep = keep & (flat_e >= lo) & (flat_e < lo + E_loc)
        xt = copy_to_model(xt)
        gate_vals = copy_to_model(gate_vals)
    rows = (flat_e - lo) * (G * Cg) + g_idx * Cg + slot
    n_rows = E_loc * G * Cg

    # dispatch: kept entries by assignment, dropped ones to the spare row
    xk = xt[:, None, :].expand(T, K, D).reshape(T * K, D)
    buf = xt.new_zeros((n_rows + 1, D)).index_put(
        (torch.where(keep, rows, n_rows),), xk)
    eout = _experts(p, buf[:n_rows].view(E_loc, G * Cg, D), dt)

    # combine: each entry's output, zero where dropped, gated, summed over k
    yk = eout[torch.where(keep, rows, 0)] * keep[:, None].to(dt)
    yk = (yk * gate_vals.reshape(-1, 1).to(dt)).view(T, K, D)
    out = yk[:, 0]
    for k in range(1, K):
        out = out + yk[:, k]

    if cfg.n_shared_experts:
        out = out + _shared(p, xt, dt)
    return reduce_from_model(out).reshape(B, S, D), aux


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over the model group, chunks along dim 0; its
    backward is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x):
        return _a2a(x)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g)


def _a2a(x):
    out = torch.empty_like(x)
    collective(dist.all_to_all_single, out, x.contiguous(),
               group=active_grid().model_group)
    return out


def moe_ffn_a2a(p, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's all-to-all dispatch on the active grid's model axis
    (module docstring): x (B, S, D), replicated over model, -> (out, aux).
    The token count must divide by the model axis."""
    grid = active_grid()
    M, m = grid.model, grid.m
    dt = x.dtype
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    ep = E // M
    T = B * S
    if T % M:
        raise ValueError(f"{T} tokens do not split over {M} model ranks")
    Tm = T // M
    xt = copy_to_model(x.reshape(T, D))
    xm = xt[m * Tm:(m + 1) * Tm]
    _, expert_idx, gate_vals, aux = _route(p, xm, cfg,
                                           copy_to_model(p["router"]))
    aux = reduce_scalar_mean(aux)

    # per-destination send buffers: destination rank = expert // ep
    flat_e = expert_idx.reshape(-1)
    dst = flat_e // ep
    cap = _group_capacity(Tm, K, M, cfg.capacity_factor)
    slot = _slots_in_group(dst)
    keep = slot < cap
    rows = dst * cap + torch.where(keep, slot, 0)
    tok = torch.arange(Tm, device=x.device).repeat_interleave(K)
    spare = M * cap
    send_x = xm.new_zeros((spare + 1, D)).index_put(
        (torch.where(keep, rows, spare),), xm[tok].to(dt))[:spare]
    send_e = torch.full((spare + 1,), E, dtype=torch.int64,
                        device=x.device).index_put(
        (torch.where(keep, rows, spare),), flat_e)[:spare]

    # tokens travel to their experts' ranks
    rx = _AllToAll.apply(send_x)
    re_ = _a2a(send_e) - m * ep                 # the rank's expert ids
    valid = (re_ >= 0) & (re_ < ep)
    re_c = torch.where(valid, re_, 0)

    # the rank's experts under the second capacity
    C2 = _group_capacity(M * cap, 1, ep, 1.25)
    slot2 = _slots_in_group(torch.where(valid, re_c, ep))
    keep2 = valid & (slot2 < C2)
    rows2 = re_c * C2 + torch.where(keep2, slot2, 0)
    n2 = ep * C2
    buf = rx.new_zeros((n2 + 1, D)).index_put(
        (torch.where(keep2, rows2, n2),), rx)[:n2]
    eout = _experts(p, buf.view(ep, C2, D), dt)
    y = eout[torch.where(keep2, rows2, 0)] * keep2[:, None].to(dt)

    if _RECORD["calls"] is not None:
        # an entry is kept when both stages kept it: the second stage's
        # verdict travels back with the outputs
        kept2 = _a2a(keep2.to(torch.int64))[torch.where(keep, rows, 0)]
        _RECORD["calls"].append({"expert_idx": expert_idx.detach(),
                                 "keep": (keep & (kept2 > 0)).detach()})

    # the return trip, the combine, the tokens of every model rank
    back = _AllToAll.apply(y)
    yk = back[torch.where(keep, rows, 0)] * keep[:, None].to(dt)
    yk = (yk * gate_vals.reshape(-1, 1).to(dt)).view(Tm, K, D)
    out_m = yk[:, 0]
    for k in range(1, K):
        out_m = out_m + yk[:, k]
    out = gather_from_model(out_m, 0)
    if cfg.n_shared_experts:
        out = out + reduce_from_model(_shared(p, xt, dt))
    return out.reshape(B, S, D), aux
