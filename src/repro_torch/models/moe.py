"""Mixture-of-Experts FFN: token-choice top-k routing with capacity-bounded,
sort-based dispatch, in plain PyTorch.

The counterpart of ``repro/models/moe.py``'s ``moe_ffn_gspmd``, the route
the reference takes on one process (its all-to-all route over a device
mesh, ``moe_ffn_a2a``, is not ported).  The reference has no kernel here:
its expert products are batched matmuls, and so are the port's.

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
import torch.nn.functional as F

from .common import ModelConfig
from .layers import dense_init

GROUP_SIZE = 4096  # tokens per assignment group

# the list that moe_ffn appends each call's routing to, while
# record_routing() is active
_RECORD = {"calls": None}


@contextlib.contextmanager
def record_routing():
    """Collect the routing of every :func:`moe_ffn` call made inside the
    block: yields a list that gets one dict per call, the router's
    ``probs`` (T, E) fp32, ``expert_idx`` (T, k) and ``keep`` (T * k,)
    bool, detached on the input's device."""
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


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux fp32 scalar).  With
    more than ``GROUP_SIZE`` tokens their count must be a multiple of it
    (the reference's reshape into groups fails otherwise)."""
    dt = x.dtype
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    T = B * S
    Gsz = min(GROUP_SIZE, T)
    if T % Gsz:
        raise ValueError(f"{T} tokens do not split into groups of {Gsz}")
    G = T // Gsz
    Cg = _group_capacity(Gsz, K, E, cfg.capacity_factor)
    xt = x.reshape(T, D)

    # router (fp32): the top k by a stable sort, ties to the lowest index
    probs = torch.softmax(xt.to(torch.float32) @ p["router"].to(torch.float32),
                          dim=-1)
    expert_idx = torch.sort(probs.detach(), dim=-1, descending=True,
                            stable=True).indices[:, :K]
    gate_vals = probs.gather(-1, expert_idx)
    if K > 1:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    me = probs.mean(0)
    # counts by an integer scatter-add: bincount would read the largest
    # index back to the host, a sync per layer on the card
    flat_e = expert_idx.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    ce = counts.to(torch.float32) * (1.0 / (T * K))
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)

    slot = _slots_in_group(expert_idx.reshape(G, Gsz * K)).reshape(-1)
    keep = slot < Cg
    g_idx = torch.arange(T * K, device=x.device) // (Gsz * K)
    rows = flat_e * (G * Cg) + g_idx * Cg + slot
    n_rows = E * G * Cg
    if _RECORD["calls"] is not None:
        _RECORD["calls"].append({"probs": probs.detach(),
                                 "expert_idx": expert_idx.detach(),
                                 "keep": keep.detach()})

    # dispatch: kept entries by assignment, dropped ones to the spare row
    xk = xt[:, None, :].expand(T, K, D).reshape(T * K, D)
    buf = xt.new_zeros((n_rows + 1, D)).index_put(
        (torch.where(keep, rows, n_rows),), xk)
    buf = buf[:n_rows].view(E, G * Cg, D)

    g = F.silu(torch.bmm(buf, p["w_gate"].to(dt)))
    u = torch.bmm(buf, p["w_up"].to(dt))
    eout = torch.bmm(g * u, p["w_down"].to(dt)).reshape(n_rows, D)

    # combine: each entry's output, zero where dropped, gated, summed over k
    yk = eout[torch.where(keep, rows, 0)] * keep[:, None].to(dt)
    yk = (yk * gate_vals.reshape(-1, 1).to(dt)).view(T, K, D)
    out = yk[:, 0]
    for k in range(1, K):
        out = out + yk[:, k]

    if cfg.n_shared_experts:
        sp = p["shared"]
        sg = F.silu(xt @ sp["w_gate"].to(dt))
        out = out + (sg * (xt @ sp["w_up"].to(dt))) @ sp["w_down"].to(dt)
    return out.reshape(B, S, D), aux
