"""Decoder-only transformer LM, dense family (GPT-2, GPT-NeoX, stablelm,
yi, qwen1.5, gemma2, qwen2-vl's backbone) and MoE family (deepseek-moe,
llama4-maverick): parameters, the training forward and losses, the
whole-prompt serving path and the serve engine's slot protocol.

The counterpart of ``repro/models/transformer.py``.  The parameters are an
``nn.Module`` whose names follow the reference's params dict
(``embed.tok``, ``embed.pos`` with learned positions, ``embed.unembed``
when untied, ``final_norm.scale`` (and ``.bias`` for LayerNorm), and per
layer ``layers.<i>.ln1``, ``attn.wq/wk/wv/wo`` (and ``bq/bk/bv`` with QKV
bias), ``ln2``, ``ln1_post`` and ``ln2_post`` with sandwich norms,
``mlp.w_up/b_up/w_down/b_down`` (GELU) or ``mlp.w_gate/w_up/w_down``
(SwiGLU, GeGLU)), and ``patch_proj`` (D, D) with patch-embedding inputs;
the reference's scan over stacked layers is a Python loop over
``layers``.  A layer is the reference's ``_dense_block``: with
sandwich norms the attention and MLP outputs are normed before each
residual add.

A MoE layer holds a ``moe`` group (``router``, ``w_gate``/``w_up``/
``w_down`` with a leading expert axis, and a nested ``shared`` group with
shared experts; ``models/moe.py``) in place of ``mlp``.  With
``moe_every == 2`` (llama4) layer 2g is group g's dense layer, its MLP
``dense_d_ff`` wide, and layer 2g + 1 its MoE layer; both share the
group's window and attention temperature, as the reference's scan over
groups gives them.  ``layers`` stays one entry per attention layer, so
the caches and the layer loops are the dense family's.  The training
forward sums the MoE layers' load-balance losses in fp32 (``aux``).

The parameters take gradients; the serving entry points run under
``torch.inference_mode()``, which records no autograd graph and skips
autograd's per-op bookkeeping. :meth:`Transformer.param_tree` is the
reference's params dict with each stacked leaf as a list of per-layer
tensors (``core/types.py``), the view the optimizer engine ravels.

Training (``forward_hidden``, ``forward``, ``loss_fn``,
``sampled_loss_fn``, ``logits_fn``): the reference's trunk on every
training-attention route (``models/layers.py:train_attention``) and remat
policy, and the LM loss on every route (``models/loss.py``; the fused one
with the final norm fused into the sweep).  With patch-embedding inputs
(qwen2-vl, whose vision tower is a stub as in the reference) the first P
rows of the embedded sequence are ``patch_embeds @ patch_proj``; with
M-RoPE the positions are (B, 3, S).

Whole-prompt serving (``init_cache``, ``prefill``, ``decode_step``; the
reference's lockstep path, ``serve/decode.py:generate_lockstep``): a
linear cache k/v (L, B, max_len, Hkv, hd) in the compute dtype;
``prefill`` runs the training attention over the whole prompt and fills
it, ``decode_step`` writes one token at a shared position and attends
``cache[:position + 1]`` through the decode kernel, whose ring mask is
that causal prefix while the position is below the cache length.

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

from ..distributed.sharding import model_parallel
from ..distributed.tensor_parallel import split_attention, split_mlp
from ..kernels.decode_attention import GLOBAL_WINDOW
from .common import ModelConfig, check_supported
from .layers import (_flash_attention_proj, _qkv, decode_attention_slots,
                     dense_init, embed, init_attention, init_embedding,
                     init_mlp, layer_norm, mlp, prefill_chunk_attention,
                     rms_norm, rope_positions, train_attention, unembed)
from .moe import init_moe, moe_ffn

# ---------------------------------------------------------------------------
# params


def _params(tree) -> nn.ParameterDict:
    return nn.ParameterDict({name: nn.Parameter(t)
                             for name, t in tree.items()})


class _Tree(nn.Module):
    """A group of parameters with nested groups (the MoE group and its
    ``shared`` experts), read like a dict: ``p["router"]``,
    ``p["shared"]["w_up"]``."""

    def __init__(self, tree):
        super().__init__()
        self._names = tuple(tree)
        for name, value in tree.items():
            setattr(self, name, _Tree(value) if isinstance(value, dict)
                    else nn.Parameter(value))

    def __getitem__(self, name):
        return getattr(self, name)

    def __contains__(self, name):
        return name in self._names

    def keys(self):
        return self._names


_LAYER_GROUPS = ("ln1", "attn", "ln2", "mlp", "moe", "ln1_post", "ln2_post")


class _Layer(nn.Module):
    """One layer's groups: ``mlp`` or, in a MoE layer, ``moe``;
    ``ln1_post`` and ``ln2_post`` only with sandwich norms (``groups``
    lists the ones present)."""

    def __init__(self, tree):
        super().__init__()
        self.groups = tuple(g for g in _LAYER_GROUPS if g in tree)
        for g in self.groups:
            setattr(self, g, _Tree(tree[g]) if g == "moe"
                    else _params(tree[g]))


def _is_moe_layer(cfg: ModelConfig, i: int) -> bool:
    """Whether attention layer ``i`` has the MoE FFN: every layer of a MoE
    config, or with ``moe_every == 2`` the second of each group."""
    return cfg.family == "moe" and (cfg.moe_every == 1 or i % 2 == 1)


def _grouped(cfg: ModelConfig) -> bool:
    """The reference's (dense, MoE) scan groups (llama4)."""
    return cfg.family == "moe" and cfg.moe_every > 1


def _stack(groups) -> dict:
    """The per-layer groups (of one kind) as one tree of stacked leaves."""
    first = groups[0]
    return {name: (_stack([g[name] for g in groups])
                   if isinstance(first[name], _Tree)
                   else [g[name] for g in groups])
            for name in first.keys()}


def _stacked_layers(layers) -> dict:
    return {g: _stack([getattr(layer, g) for layer in layers])
            for g in layers[0].groups}


def unstack_layers(cfg: ModelConfig, stacked) -> list:
    """The inverse of ``param_tree()["layers"]`` over arrays with a leading
    stacked axis: one tree per attention layer.  With ``moe_every == 2``
    group g's ``dense`` and ``moe`` trees give layers 2g and 2g + 1."""
    def take(tree, i):
        return {name: take(leaf, i) if isinstance(leaf, dict) else leaf[i]
                for name, leaf in tree.items()}

    if _grouped(cfg):
        return [take(stacked[kind], g)
                for g in range(cfg.n_layers // cfg.moe_every)
                for kind in ("dense", "moe")]
    return [take(stacked, i) for i in range(cfg.n_layers)]


class Transformer(nn.Module):
    """Parameters of the dense LM, from a tree shaped like the reference's
    params dict with the layer stack as a list of per-layer dicts."""

    def __init__(self, cfg: ModelConfig, tree):
        super().__init__()
        check_supported(cfg)
        if len(tree["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(tree['layers'])} layers for a config "
                             f"of {cfg.n_layers}")
        for i, layer in enumerate(tree["layers"]):
            if ("moe" in layer) != _is_moe_layer(cfg, i):
                raise ValueError(f"layer {i} of config {cfg.name!r} "
                                 f"{'has' if 'moe' in layer else 'lacks'} "
                                 f"a moe group")
        has = "patch_proj" in tree
        if has != cfg.patch_embed_input:
            raise ValueError(f"a tree {'with' if has else 'without'} "
                             f"patch_proj for a config with "
                             f"patch_embed_input={cfg.patch_embed_input}")
        self.cfg = cfg
        self.embed = _params(tree["embed"])
        self.final_norm = _params(tree["final_norm"])
        self.layers = nn.ModuleList(_Layer(t) for t in tree["layers"])
        self.patch_proj = (nn.Parameter(tree["patch_proj"])
                           if cfg.patch_embed_input else None)

    def param_tree(self) -> dict:
        """The reference's params dict over this module's parameters; each
        leaf under ``"layers"`` is a list of the per-layer tensors, or with
        ``moe_every == 2`` of the per-group ones, under ``"dense"`` and
        ``"moe"``."""
        layers = list(self.layers)
        tree = {
            "embed": dict(self.embed.items()),
            "final_norm": dict(self.final_norm.items()),
            "layers": ({"dense": _stacked_layers(layers[0::2]),
                        "moe": _stacked_layers(layers[1::2])}
                       if _grouped(self.cfg) else _stacked_layers(layers)),
        }
        if self.patch_proj is not None:
            tree["patch_proj"] = self.patch_proj
        return tree


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


def _init_layer(cfg: ModelConfig, gen: torch.Generator, i: int) -> dict:
    dev = gen.device
    p = {"ln1": _init_norm(cfg, dev), "attn": init_attention(gen, cfg),
         "ln2": _init_norm(cfg, dev)}
    if _is_moe_layer(cfg, i):
        p["moe"] = init_moe(gen, cfg)
    else:
        p["mlp"] = init_mlp(gen, cfg, d_ff=cfg.dense_d_ff
                            if _grouped(cfg) else None)
    if cfg.post_norms:
        p["ln1_post"] = _init_norm(cfg, dev)
        p["ln2_post"] = _init_norm(cfg, dev)
    return p


def _attn_residual(layer, x, a, cfg: ModelConfig):
    """x + a, the attention output normed first with sandwich norms."""
    if cfg.post_norms:
        a = _norm(layer.ln1_post, a, cfg)
    return x + a


def _ffn_residual(layer, x, cfg: ModelConfig, aux=None):
    """(x + ffn(ln2(x)), aux): the MLP, or in a MoE layer the MoE FFN with
    its load-balance loss added to ``aux`` (fp32); the FFN output normed
    first with sandwich norms."""
    h = _norm(layer.ln2, x, cfg)
    if "moe" in layer.groups:
        f, a = moe_ffn(layer.moe, h, cfg)
        aux = a if aux is None else aux + a
    elif model_parallel() > 1:
        f = split_mlp(mlp, layer.mlp, h, cfg)
    else:
        f = mlp(layer.mlp, h, cfg)
    if cfg.post_norms:
        f = _norm(layer.ln2_post, f, cfg)
    return x + f, aux


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Transformer:
    """Random parameters drawn from ``gen``, on ``gen``'s device."""
    check_supported(cfg)
    dev = gen.device
    # the layers draw first, then the embedding and patch_proj: a seed
    # gives the weights it gave before patch_proj existed
    layers = [_init_layer(cfg, gen, i) for i in range(cfg.n_layers)]
    tree = {"embed": init_embedding(gen, cfg),
            "final_norm": _init_norm(cfg, dev), "layers": layers}
    if cfg.patch_embed_input:
        tree["patch_proj"] = dense_init(gen, (cfg.d_model, cfg.d_model))
    return Transformer(cfg, tree)


# ---------------------------------------------------------------------------
# per-layer flags (sliding-window pattern, attention temperature)


def _per_layer(cfg: ModelConfig, value) -> list:
    """``value(g)`` of each attention layer's scan group g, as the
    reference's per-group flags: both layers of a (dense, MoE) group take
    the group's."""
    per = cfg.moe_every if _grouped(cfg) else 1
    return [value(i // per) for i in range(cfg.n_layers)]


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer effective window (``GLOBAL_WINDOW`` = global)."""
    if cfg.local_global_pattern == "alternating" and cfg.local_window:
        return _per_layer(cfg, lambda g: cfg.local_window if g % 2 == 0
                          else GLOBAL_WINDOW)
    return [cfg.local_window or GLOBAL_WINDOW] * cfg.n_layers


def layer_scales(cfg: ModelConfig) -> List[float]:
    """Per-layer attention temperature, fp32 values as the reference's:
    1 / (1 + g) for scan group g with ``attn_temperature_by_layer``."""
    if cfg.attn_temperature_by_layer:
        return _per_layer(cfg, lambda g: float(np.float32(1.0)
                                               / np.float32(1.0 + g)))
    return [1.0] * cfg.n_layers


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
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def _scan_groups(n: int) -> int:
    """The group size of "scan2" (the reference's ``transformer.py:226``)."""
    return next(d for d in (8, 5, 4, 2) if n % d == 0)


def _embed_inputs(cfg: ModelConfig, params: Transformer, tokens, positions,
                  patch_embeds):
    """(embedded inputs (B, S, D), rope positions), the reference's
    ``_embed_inputs``: positions default to 0..S-1, broadcast to (B, 3, S)
    with M-RoPE; the learned position table reads the first stream; with
    patch-embedding inputs the first P rows become ``patch_embeds`` (B, P,
    D) @ ``patch_proj``, both cast to the compute dtype."""
    B, S = tokens.shape
    if positions is None:
        positions = rope_positions(
            cfg, torch.arange(S, device=tokens.device)[None].expand(B, S))
    emb_pos = positions if positions.dim() == 2 else positions[:, 0]
    x = embed(params.embed, tokens, cfg, emb_pos)
    if cfg.patch_embed_input and patch_embeds is not None:
        P = patch_embeds.shape[1]
        pe = patch_embeds.to(x.dtype) @ params.patch_proj.to(x.dtype)
        x = torch.cat([pe, x[:, P:]], dim=1)
    return x, positions


def forward_hidden(cfg: ModelConfig, params: Transformer, tokens, *,
                   positions=None, patch_embeds=None, attn_impl: str = "auto",
                   remat: str = "none", final_norm: bool = True):
    """tokens (B, S) -> (hidden (B, S, D), aux): the trunk shared by
    :func:`forward` and the losses.  ``positions`` (B, S), or (B, 3, S)
    with M-RoPE, by default 0..S-1, feed the learned position table or
    rope in every layer; ``patch_embeds`` (B, P, D) replace the first P
    embedded rows with patch-embedding inputs (:func:`_embed_inputs`).
    ``final_norm=False`` returns the PRE-norm hidden, which the fused loss
    normalizes inside its sweep.  ``aux`` is the sum of the MoE layers'
    load-balance losses in layer order (fp32), 0 for the dense family.

    ``remat`` trades the backward's memory for a second forward, the
    reference's policies: "full" recomputes every layer
    (``torch.utils.checkpoint``), "dots" every layer but its weight
    products' outputs (selective checkpointing), "scan2" checkpoints groups
    of g layers (g the first of 8, 5, 4, 2 that divides the layer count)
    and every layer inside a group again, so that the backward holds g
    layer inputs at a time; with fewer than 4 layers "scan2" is the plain
    loop, as in the reference.  A checkpointed function takes and returns
    (x, aux), so the losses add in the same order.  Values do not change,
    and recomputed flash layers launch the forward kernel again."""
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r} (one of {REMATS})")
    x, positions = _embed_inputs(cfg, params, tokens, positions, patch_embeds)
    windows = layer_windows(cfg)
    scales = layer_scales(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # on a grid's model axis each rank attends over its heads
    # (distributed/tensor_parallel.py)
    attend = (split_attention if model_parallel() > 1
              else (lambda fn, *a, **kw: fn(*a, **kw)))

    def layer_fn(i):
        layer = params.layers[i]

        def run(x, aux):
            h = _norm(layer.ln1, x, cfg)
            a = attend(train_attention, layer.attn, h, cfg,
                       positions=positions, window=windows[i],
                       layer_scale=scales[i], impl=attn_impl)
            return _ffn_residual(layer, _attn_residual(layer, x, a, cfg),
                                 cfg, aux)
        return run

    n = len(params.layers)
    if remat == "scan2" and n >= 4:
        g = _scan_groups(n)

        def group_fn(start):
            inner = [_checkpointed(layer_fn(i), "full")
                     for i in range(start, start + g)]

            def run(x, aux):
                for f in inner:
                    x, aux = f(x, aux)
                return x, aux
            return run

        for start in range(0, n, g):
            x, aux = _checkpointed(group_fn(start), "full")(x, aux)
    else:
        for i in range(n):
            run = layer_fn(i)
            if remat in ("full", "dots"):
                run = _checkpointed(run, remat)
            x, aux = run(x, aux)
    if final_norm:
        x = _norm(params.final_norm, x, cfg)
    return x, aux


def forward(cfg: ModelConfig, params: Transformer, tokens, *, positions=None,
            patch_embeds=None, attn_impl: str = "auto", remat: str = "none"):
    """tokens (B, S) -> (logits (B, S, V) fp32, aux)."""
    x, aux = forward_hidden(cfg, params, tokens, positions=positions,
                            patch_embeds=patch_embeds, attn_impl=attn_impl,
                            remat=remat)
    return unembed(params.embed, x, cfg), aux


def loss_fn(cfg: ModelConfig, params: Transformer, batch, *,
            attn_impl="auto", remat="none", loss_impl=None):
    """batch {tokens, labels, [mask], [positions], [patch_embeds]} ->
    (loss, metrics), the CE through the logits-free fused loss with the
    final norm fused; the loss is the CE plus the MoE load-balance term."""
    from .loss import lm_loss
    hidden, aux = forward_hidden(cfg, params, batch["tokens"],
                                 positions=batch.get("positions"),
                                 patch_embeds=batch.get("patch_embeds"),
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
    (``models/loss.py:lm_loss_sampled`` for the others and ``draws``).  The
    MoE load-balance term is left out, as in the reference."""
    from .loss import lm_loss_sampled
    hidden, _ = forward_hidden(cfg, params, batch["tokens"],
                               positions=batch.get("positions"),
                               patch_embeds=batch.get("patch_embeds"),
                               attn_impl=attn_impl, remat=remat,
                               final_norm=False)
    return lm_loss_sampled(cfg, params, hidden, seed, batch.get("mask"),
                           impl=loss_impl, pre_norm=cfg.norm_type, **draws)


def logits_fn(cfg: ModelConfig, params: Transformer, batch, **kw):
    """The logits (B, S, V) fp32 of ``batch["tokens"]``: the view of the
    GNB estimator from materialized logits (Algorithm 2 line 3)."""
    kw.pop("loss_impl", None)
    logits, _ = forward(cfg, params, batch["tokens"],
                        positions=batch.get("positions"),
                        patch_embeds=batch.get("patch_embeds"), **kw)
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
        x, _ = _ffn_residual(layer, _attn_residual(layer, x, a, cfg), cfg)
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


# ---------------------------------------------------------------------------
# whole-prompt serving: prefill + linear-cache decode (the lockstep path)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device="cpu") -> dict:
    """Zeroed linear cache k/v (L, B, max_len, Hkv, hd) in the compute
    dtype, the reference's ``init_cache`` (which has no int8 form)."""
    check_supported(cfg)
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.hd)
    return {name: torch.zeros(shape, dtype=cfg.compute_dtype, device=device)
            for name in ("k", "v")}


@torch.inference_mode()
def prefill(cfg: ModelConfig, params: Transformer, tokens, *,
            patch_embeds=None):
    """The whole prompt in one forward, filling a linear cache: tokens
    (B, S) -> (logits (B, 1, V) fp32 of the last token, cache {"k", "v"}
    (L, B, S, Hkv, hd) in the compute dtype).  Every layer attends on the
    flash route (the forward kernel on the card; the reference's
    ``attn_impl`` is not taken: the other routes materialize more than a
    long prompt allows) and writes its rotated K and V.  Only the last
    token is unembedded: the (B, S, V) logits of a 32k prompt at a 152k
    vocabulary cannot exist (the reference's ``prefill``)."""
    B, S = tokens.shape
    x, positions = _embed_inputs(cfg, params, tokens, None, patch_embeds)
    windows = layer_windows(cfg)
    scales = layer_scales(cfg)
    cache = init_cache(cfg, B, S, tokens.device)
    for i, layer in enumerate(params.layers):
        h = _norm(layer.ln1, x, cfg)
        qkv = _qkv(layer.attn, h, cfg, positions)
        cache["k"][i], cache["v"][i] = qkv[1], qkv[2]
        a = _flash_attention_proj(layer.attn, h, cfg, window=windows[i],
                                  layer_scale=scales[i], qkv=qkv)
        x, _ = _ffn_residual(layer, _attn_residual(layer, x, a, cfg), cfg)
    x = _norm(params.final_norm, x[:, -1:], cfg)
    return unembed(params.embed, x, cfg), cache


def decode_step(cfg: ModelConfig, params: Transformer, cache, tokens,
                position: int):
    """One decode step of every row at one position: tokens (B, 1) ->
    logits (B, 1, V) fp32, writing each row's K/V at ``position`` of the
    linear cache in place.  It is :func:`decode_slots` with every slot at
    ``position``: on a cache longer than the position the ring mask is
    the causal prefix ``cache[:position + 1]``, the reference's
    ``decode_step``."""
    C = cache["k"].shape[2]
    position = int(position)
    if not 0 <= position < C:
        raise ValueError(f"position {position} outside the cache of {C}")
    positions = torch.full((tokens.shape[0],), position, dtype=torch.int32,
                           device=tokens.device)
    return decode_slots(cfg, params, cache, tokens, positions)
