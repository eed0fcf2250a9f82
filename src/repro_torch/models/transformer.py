"""Decoder-only transformer LM, dense family (GPT-2, GPT-NeoX, stablelm,
yi, qwen1.5, gemma2): parameters, the training forward and losses, and the
serve engine's slot protocol.

The counterpart of ``repro/models/transformer.py``.  The parameters are an
``nn.Module`` whose names follow the reference's params dict
(``embed.tok``, ``embed.pos`` with learned positions, ``embed.unembed``
when untied, ``final_norm.scale`` (and ``.bias`` for LayerNorm), and per
layer ``layers.<i>.ln1``, ``attn.wq/wk/wv/wo`` (and ``bq/bk/bv`` with QKV
bias), ``ln2``, ``ln1_post`` and ``ln2_post`` with sandwich norms,
``mlp.w_up/b_up/w_down/b_down`` (GELU) or ``mlp.w_gate/w_up/w_down``
(SwiGLU, GeGLU)); the reference's scan over stacked layers is a Python
loop over ``layers``.  A layer is the reference's ``_dense_block``: with
sandwich norms the attention and MLP outputs are normed before each
residual add.  The parameters take gradients; the
serving entry points run under ``torch.inference_mode()``, which records
no autograd graph and skips autograd's per-op bookkeeping.  :meth:`Transformer.param_tree` is the reference's params dict
with each stacked leaf as a list of per-layer tensors (``core/types.py``),
the view the optimizer engine ravels.

Training (``forward_hidden``, ``forward``, ``loss_fn``,
``sampled_loss_fn``, ``logits_fn``): the reference's trunk on every
training-attention route (``models/layers.py:train_attention``) and remat
policy, and the LM loss on every route (``models/loss.py``; the fused one
with the final norm fused into the sweep).

Slot protocol (continuous-batching engine, ``serve/engine.py``): the cache
is the reference's slot-major ring, a dict of leaves with a leading layer
axis — k/v (L, N, C, Hkv, hd), plus k_scale/v_scale (L, N, C) fp32 for an
int8 cache.  Ring index s of a slot at position p holds absolute position
p - ((p - s) mod C); the mask hides unwritten, stale and out-of-window
entries, so reusing a slot needs no reset.  Prefill and decode update the
cache in place.
"""
from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch
from torch import nn

from ..kernels.decode_attention import GLOBAL_WINDOW
from .common import ModelConfig, check_supported
from .layers import (decode_attention_slots, embed, init_attention,
                     init_embedding, init_mlp, layer_norm, mlp,
                     prefill_chunk_attention, rms_norm, train_attention,
                     unembed)

# ---------------------------------------------------------------------------
# params


def _params(tree) -> nn.ParameterDict:
    return nn.ParameterDict({name: nn.Parameter(t)
                             for name, t in tree.items()})


_LAYER_GROUPS = ("ln1", "attn", "ln2", "mlp", "ln1_post", "ln2_post")


class _Layer(nn.Module):
    """One layer's groups; ``ln1_post`` and ``ln2_post`` only with sandwich
    norms (``groups`` lists the ones present)."""

    def __init__(self, tree):
        super().__init__()
        self.groups = tuple(g for g in _LAYER_GROUPS if g in tree)
        for g in self.groups:
            setattr(self, g, _params(tree[g]))


class Transformer(nn.Module):
    """Parameters of the dense LM, from a tree shaped like the reference's
    params dict with the layer stack as a list of per-layer dicts."""

    def __init__(self, cfg: ModelConfig, tree):
        super().__init__()
        check_supported(cfg)
        if len(tree["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(tree['layers'])} layers for a config "
                             f"of {cfg.n_layers}")
        self.cfg = cfg
        self.embed = _params(tree["embed"])
        self.final_norm = _params(tree["final_norm"])
        self.layers = nn.ModuleList(_Layer(t) for t in tree["layers"])

    def param_tree(self) -> dict:
        """The reference's params dict over this module's parameters; each
        leaf under ``"layers"`` is a list of the per-layer tensors."""
        groups = self.layers[0].groups
        return {
            "embed": dict(self.embed.items()),
            "final_norm": dict(self.final_norm.items()),
            "layers": {g: {name: [getattr(layer, g)[name]
                                  for layer in self.layers]
                           for name in getattr(self.layers[0], g).keys()}
                       for g in groups},
        }


def _init_norm(cfg: ModelConfig, device):
    """LayerNorm: scale ones, bias zeros; RMSNorm: scale zeros (it
    multiplies by 1 + scale) and no bias."""
    if cfg.norm_type == "ln":
        return {"scale": torch.ones((cfg.d_model,), device=device),
                "bias": torch.zeros((cfg.d_model,), device=device)}
    return {"scale": torch.zeros((cfg.d_model,), device=device)}


def _norm(p, x, cfg: ModelConfig):
    if cfg.norm_type == "ln":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


def _init_layer(cfg: ModelConfig, gen: torch.Generator) -> dict:
    dev = gen.device
    p = {"ln1": _init_norm(cfg, dev), "attn": init_attention(gen, cfg),
         "ln2": _init_norm(cfg, dev), "mlp": init_mlp(gen, cfg)}
    if cfg.post_norms:
        p["ln1_post"] = _init_norm(cfg, dev)
        p["ln2_post"] = _init_norm(cfg, dev)
    return p


def _attn_residual(layer, x, a, cfg: ModelConfig):
    """x + a, the attention output normed first with sandwich norms."""
    if cfg.post_norms:
        a = _norm(layer.ln1_post, a, cfg)
    return x + a


def _mlp_residual(layer, x, cfg: ModelConfig):
    """x + mlp(ln2(x)), the MLP output normed first with sandwich norms."""
    f = mlp(layer.mlp, _norm(layer.ln2, x, cfg), cfg)
    if cfg.post_norms:
        f = _norm(layer.ln2_post, f, cfg)
    return x + f


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Transformer:
    """Random parameters drawn from ``gen``, on ``gen``'s device."""
    check_supported(cfg)
    dev = gen.device
    layers = [_init_layer(cfg, gen) for _ in range(cfg.n_layers)]
    return Transformer(cfg, {"embed": init_embedding(gen, cfg),
                             "final_norm": _init_norm(cfg, dev),
                             "layers": layers})


# ---------------------------------------------------------------------------
# per-layer flags (sliding-window pattern, attention temperature)


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer effective window (``GLOBAL_WINDOW`` = global)."""
    n = cfg.n_layers
    if cfg.local_global_pattern == "alternating" and cfg.local_window:
        return [cfg.local_window if i % 2 == 0 else GLOBAL_WINDOW
                for i in range(n)]
    if cfg.local_window:
        return [cfg.local_window] * n
    return [GLOBAL_WINDOW] * n


def layer_scales(cfg: ModelConfig) -> List[float]:
    """Per-layer attention temperature, fp32 values as the reference's."""
    n = cfg.n_layers
    if cfg.attn_temperature_by_layer:
        return [float(np.float32(1.0) / np.float32(1.0 + i)) for i in range(n)]
    return [1.0] * n


# ---------------------------------------------------------------------------
# training forward


REMATS = ("none", "full", "dots", "scan2")


def _save_weight_products(ctx, op, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable`` in PyTorch's
    selective checkpointing: keep the outputs of the weight products
    (``aten.mm``/``addmm``; x @ W of a (B, S, D) x lowers to ``mm``) and
    recompute the rest, the batched products and the attention kernels'
    outputs among it."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(fn, remat: str):
    """``fn`` with its activations recomputed in the backward: all of them
    ("full") or all but the weight products' ("dots")."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_weight_products)
    return lambda x: checkpoint(fn, x, use_reentrant=False, **kw)


def _scan_groups(n: int) -> int:
    """The group size of "scan2" (the reference's ``transformer.py:226``)."""
    return next(d for d in (8, 5, 4, 2) if n % d == 0)


def forward_hidden(cfg: ModelConfig, params: Transformer, tokens, *,
                   positions=None, attn_impl: str = "auto",
                   remat: str = "none", final_norm: bool = True):
    """tokens (B, S) -> (hidden (B, S, D), aux): the trunk shared by
    :func:`forward` and the losses.  ``positions`` (B, S), by default
    0..S-1, feed the learned position table or rope in every layer.
    ``final_norm=False`` returns the PRE-norm hidden, which the fused loss
    normalizes inside its sweep.  ``aux`` is the MoE load-balance term, 0
    for the dense family.

    ``remat`` trades the backward's memory for a second forward, the
    reference's policies: "full" recomputes every layer
    (``torch.utils.checkpoint``), "dots" every layer but its weight
    products' outputs (selective checkpointing), "scan2" checkpoints groups
    of g layers (g the first of 8, 5, 4, 2 that divides the layer count)
    and every layer inside a group again, so that the backward holds g
    layer inputs at a time; with fewer than 4 layers "scan2" is the plain
    loop, as in the reference.  Values do not change, and recomputed flash
    layers launch the forward kernel again."""
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r} (one of {REMATS})")
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = embed(params.embed, tokens, cfg, positions)
    windows = layer_windows(cfg)
    scales = layer_scales(cfg)

    def layer_fn(i):
        layer = params.layers[i]

        def run(x):
            h = _norm(layer.ln1, x, cfg)
            a = train_attention(layer.attn, h, cfg, positions=positions,
                                window=windows[i], layer_scale=scales[i],
                                impl=attn_impl)
            return _mlp_residual(layer, _attn_residual(layer, x, a, cfg), cfg)
        return run

    n = len(params.layers)
    if remat == "scan2" and n >= 4:
        g = _scan_groups(n)

        def group_fn(start):
            inner = [_checkpointed(layer_fn(i), "full")
                     for i in range(start, start + g)]

            def run(x):
                for f in inner:
                    x = f(x)
                return x
            return run

        for start in range(0, n, g):
            x = _checkpointed(group_fn(start), "full")(x)
    else:
        for i in range(n):
            run = layer_fn(i)
            if remat in ("full", "dots"):
                run = _checkpointed(run, remat)
            x = run(x)
    if final_norm:
        x = _norm(params.final_norm, x, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(cfg: ModelConfig, params: Transformer, tokens, *, positions=None,
            attn_impl: str = "auto", remat: str = "none"):
    """tokens (B, S) -> (logits (B, S, V) fp32, aux)."""
    x, aux = forward_hidden(cfg, params, tokens, positions=positions,
                            attn_impl=attn_impl, remat=remat)
    return unembed(params.embed, x, cfg), aux


def loss_fn(cfg: ModelConfig, params: Transformer, batch, *,
            attn_impl="auto", remat="none", loss_impl=None):
    """batch {tokens, labels, [mask], [positions]} -> (loss, metrics), the
    CE through the logits-free fused loss with the final norm fused."""
    from .loss import lm_loss
    hidden, aux = forward_hidden(cfg, params, batch["tokens"],
                                 positions=batch.get("positions"),
                                 attn_impl=attn_impl, remat=remat,
                                 final_norm=False)
    ce, _ = lm_loss(cfg, params, hidden, batch["labels"], batch.get("mask"),
                    impl=loss_impl, pre_norm=cfg.norm_type)
    return ce + aux, {"ce": ce, "aux": aux}


def sampled_loss_fn(cfg: ModelConfig, params: Transformer, batch, seed, *,
                    attn_impl="auto", remat="none", loss_impl=None,
                    **draws):
    """GNB's sampled-label NLL (Algorithm 2): ``(nll, n_valid)`` with the
    labels drawn from the model's own softmax inside the loss sweep, from
    the hash noise of ``seed`` (two uint32 values) on the fused route
    (``models/loss.py:lm_loss_sampled`` for the others and ``draws``)."""
    from .loss import lm_loss_sampled
    hidden, _ = forward_hidden(cfg, params, batch["tokens"],
                               positions=batch.get("positions"),
                               attn_impl=attn_impl, remat=remat,
                               final_norm=False)
    return lm_loss_sampled(cfg, params, hidden, seed, batch.get("mask"),
                           impl=loss_impl, pre_norm=cfg.norm_type, **draws)


def logits_fn(cfg: ModelConfig, params: Transformer, batch, **kw):
    """The logits (B, S, V) fp32 of ``batch["tokens"]``: the view of the
    GNB estimator from materialized logits (Algorithm 2 line 3)."""
    kw.pop("loss_impl", None)
    logits, _ = forward(cfg, params, batch["tokens"],
                        positions=batch.get("positions"), **kw)
    return logits


# ---------------------------------------------------------------------------
# slot protocol


def init_slots(cfg: ModelConfig, n_slots: int, cache_len: int,
               device="cpu") -> dict:
    """Zeroed slot cache: k/v (L, N, C, Hkv, hd) in the compute dtype, or
    int8 payloads plus fp32 scale planes (L, N, C) when
    ``cfg.kv_dtype == "int8"``."""
    check_supported(cfg)
    L = cfg.n_layers
    shape = (L, n_slots, cache_len, cfg.n_kv_heads, cfg.hd)
    if cfg.kv_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros((L, n_slots, cache_len), device=device),
                "v_scale": torch.zeros((L, n_slots, cache_len), device=device)}
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


def reset_slot(cfg: ModelConfig, cache, slot):
    """Ring masking hides stale entries — nothing to clear for attention."""
    return cache


def _slot_layer_sweep(cfg: ModelConfig, params: Transformer, cache, x,
                      attn_fn):
    """Layer loop shared by :func:`decode_slots` and
    :func:`prefill_into_slot`, parameterized by the attention call
    ``attn_fn(p_attn, h, kv_l, window, scale) -> a``; ``kv_l`` is the
    layer's view of every cache leaf.  Returns the hidden state."""
    windows = layer_windows(cfg)
    scales = layer_scales(cfg)
    for i, layer in enumerate(params.layers):
        kv_l = {name: leaf[i] for name, leaf in cache.items()}
        a = attn_fn(layer.attn, _norm(layer.ln1, x, cfg), kv_l, windows[i],
                    scales[i])
        x = _mlp_residual(layer, _attn_residual(layer, x, a, cfg), cfg)
    return x


@torch.inference_mode()
def decode_slots(cfg: ModelConfig, params: Transformer, cache, tokens,
                 positions, active=None):
    """One decode step across all slots: tokens (N, 1), positions (N,).
    Writes each slot's new K/V (only where ``active`` (N,) bool is True,
    when given) and returns logits (N, 1, V) fp32."""
    positions = positions.to(torch.int32)
    x = embed(params.embed, tokens, cfg, positions[:, None])

    def attn_fn(p, h, kv_l, w, s):
        return decode_attention_slots(p, h, cfg, kv_l, positions, window=w,
                                      layer_scale=s, active=active)

    x = _slot_layer_sweep(cfg, params, cache, x, attn_fn)
    x = _norm(params.final_norm, x, cfg)
    return unembed(params.embed, x, cfg)


@torch.inference_mode()
def prefill_into_slot(cfg: ModelConfig, params: Transformer, cache,
                      slot: int, tokens, start: int, n_valid: int):
    """Chunk-prefill one slot: tokens (1, P) at positions start..start+P-1.
    Writes the chunk's K/V into the slot's ring and returns the logits (V,)
    fp32 of the last *valid* token — the next-token distribution once the
    final chunk lands.  Queries past ``n_valid`` compute values nothing
    reads."""
    P = tokens.shape[1]
    qpos = start + torch.arange(P, dtype=torch.int32, device=tokens.device)
    x = embed(params.embed, tokens, cfg, qpos[None])

    def attn_fn(p, h, kv_l, w, s):
        return prefill_chunk_attention(p, h, cfg, kv_l, slot, start, qpos,
                                       window=w, layer_scale=s)

    x = _slot_layer_sweep(cfg, params, cache, x, attn_fn)
    last = _norm(params.final_norm, x[:, n_valid - 1:n_valid], cfg)
    return unembed(params.embed, last, cfg)[0, 0]
