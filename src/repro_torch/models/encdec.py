"""Encoder-decoder backbone (seamless-m4t-medium, arXiv:2308.11596): a
bidirectional encoder over frame embeddings and a causal decoder with
cross-attention, in plain PyTorch around the port's attention, CE and
decode kernels.

The counterpart of ``repro/models/encdec.py``.  The modality frontend
(the speech feature extractor) is a stub, as in the reference: the
encoder takes precomputed frame embeddings (B, S_src, d_model), cast to
the compute dtype before ``frame_proj``.  Every norm is RMSNorm, whatever
``norm_type`` says.  The encoder's attention is bidirectional
(``causal=False``) and rotates q and k by positions 0..S_src - 1 under
rope; the decoder's self-attention is causal and rotated by 0..S_tgt - 1;
its cross-attention takes q from the decoder (projected, never rotated)
and K, V from the encoder's output through the layer's own ``wk`` and
``wv`` (``_cross_kv``: no rotation and no bias, as in the reference), so
that on the flash route the encoder learns only through the dK/dV kernel
of the cross-attention.  Training attention is
``layers.train_attention`` on every route; the chunked route has no
cross-attention and takes the materialized one there, as the
reference's.  The training loss is the CE over the target tokens with
the final RMSNorm fused (``pre_norm="rms"``); ``aux`` is 0.  Remat:
``"full"`` recomputes each encoder and each decoder layer in the
backward; ``"dots"`` and ``"scan2"`` run as ``"none"``, as in the
reference, which honours only ``"full"`` in this family.

Parameters are an ``nn.Module``, :class:`EncDec`, whose names follow the
reference's tree: ``embed.tok`` (tied), ``frame_proj`` (D, D),
``encoder.<i>`` (``ln1``, ``attn.wq/wk/wv/wo``, ``ln2``, ``mlp``),
``enc_norm``, ``decoder.<i>`` (``ln1``, ``self_attn``, ``ln_x``,
``cross_attn``, ``ln2``, ``mlp``) and ``final_norm``.
:meth:`EncDec.param_tree` is the reference's tree with ``encoder`` and
``decoder`` stacked, each stacked leaf a list of tensors: the view the
optimizer engine ravels and the checkpoint writes.

Serving.  The cache is the reference's: ``k``/``v`` (L, N, C, Hkv, hd),
the decoder's self-attention ring (slot-major, as the transformer
family's), and ``xk``/``xv`` (L, N, S_src, Hkv, hd), each slot's
cross-attention K/V, written once per request by
``prefill_encoder_slot`` before its decoder prefix is prefilled.  The
serving encoder (``prefill_encoder``, ``prefill_encoder_slot``) takes the
flash forward with ``causal=False`` whatever route the reference's
``attn_impl`` would pick (the others materialize more than a 32k frame
stream allows), as the transformer family's ``prefill`` does: the same
function.  Decode and the chunk prefill attend the self ring through
``layers.decode_attention_slots`` (the decode kernel on the card) and
``layers.prefill_chunk_attention``; their cross-attention is the
reference's materialized ``full_attention`` over the slot's own rows,
plain PyTorch (the reference has no kernel there).  There is no int8
cache and no prefix cache.  ``decode_step`` (the whole-prompt path) is
``decode_slots`` with every row at one position.  The serving entry
points run under ``torch.inference_mode()`` and update the cache in
place.
"""
from __future__ import annotations

import torch
from torch import nn

from .common import ModelConfig, check_supported
from .griffin import _attn_shapes, _init_norm, _mlp_shapes, _shapes
from .layers import (decode_attention_slots, dense_init, embed,
                     full_attention, init_attention, init_embedding,
                     init_mlp, mlp, prefill_chunk_attention, rms_norm,
                     train_attention, unembed)
from .transformer import REMATS, _checkpointed, _params, _stack, _Tree

# ---------------------------------------------------------------------------
# params


def _norm_shape(cfg: ModelConfig) -> dict:
    return {"scale": (cfg.d_model,)}


def enc_layer_shapes(cfg: ModelConfig) -> dict:
    """{leaf: shape} of one encoder layer, the reference's tree."""
    attn = _attn_shapes(cfg)["attn"]
    return {"ln1": _norm_shape(cfg), "attn": attn,
            "ln2": _norm_shape(cfg), "mlp": _mlp_shapes(cfg)}


def dec_layer_shapes(cfg: ModelConfig) -> dict:
    """{leaf: shape} of one decoder layer, the reference's tree."""
    attn = _attn_shapes(cfg)["attn"]
    return {"ln1": _norm_shape(cfg), "self_attn": attn,
            "ln_x": _norm_shape(cfg), "cross_attn": attn,
            "ln2": _norm_shape(cfg), "mlp": _mlp_shapes(cfg)}


class EncDec(nn.Module):
    """Parameters of the encoder-decoder, from a tree shaped like the
    reference's params dict with ``encoder`` and ``decoder`` as lists of
    per-layer dicts.  A leaf the port does not know, or of another shape,
    raises."""

    def __init__(self, cfg: ModelConfig, tree):
        super().__init__()
        check_supported(cfg)
        if cfg.family != "encdec":
            raise ValueError(f"config {cfg.name!r} is of family "
                             f"{cfg.family!r}, not encdec")
        enc, dec = tree["encoder"], tree["decoder"]
        if len(enc) != cfg.n_encoder_layers or len(dec) != cfg.n_layers:
            raise ValueError(f"{len(enc)} encoder and {len(dec)} decoder "
                             f"layers for a config of {cfg.n_encoder_layers} "
                             f"and {cfg.n_layers}")
        for kind, layers, want in (("encoder", enc, enc_layer_shapes(cfg)),
                                   ("decoder", dec, dec_layer_shapes(cfg))):
            for i, layer in enumerate(layers):
                if _shapes(layer) != want:
                    raise ValueError(f"{kind} layer {i} has leaves "
                                     f"{_shapes(layer)}, not {want}")
        emb = {"tok": (cfg.padded_vocab, cfg.d_model)}
        if not cfg.tie_embeddings:
            emb["unembed"] = (cfg.d_model, cfg.padded_vocab)
        top = {"embed": emb, "frame_proj": (cfg.d_model, cfg.d_model),
               "enc_norm": _norm_shape(cfg), "final_norm": _norm_shape(cfg)}
        for name, want in top.items():
            got = (_shapes(tree[name]) if isinstance(tree[name], dict)
                   else tuple(tree[name].shape))
            if got != want:
                raise ValueError(f"{name} has {got}, not {want}")
        self.cfg = cfg
        self.embed = _params(tree["embed"])
        self.frame_proj = nn.Parameter(tree["frame_proj"])
        self.encoder = nn.ModuleList(_Tree(t) for t in enc)
        self.enc_norm = _params(tree["enc_norm"])
        self.decoder = nn.ModuleList(_Tree(t) for t in dec)
        self.final_norm = _params(tree["final_norm"])

    def param_tree(self) -> dict:
        """The reference's params dict over this module's parameters; each
        leaf under ``"encoder"`` and ``"decoder"`` is a list of the
        per-layer tensors."""
        return {"embed": dict(self.embed.items()),
                "frame_proj": self.frame_proj,
                "encoder": _stack(list(self.encoder)),
                "enc_norm": dict(self.enc_norm.items()),
                "decoder": _stack(list(self.decoder)),
                "final_norm": dict(self.final_norm.items())}


def init_params(cfg: ModelConfig, gen: torch.Generator) -> EncDec:
    """Random parameters drawn from ``gen``, on ``gen``'s device."""
    check_supported(cfg)
    dev = gen.device
    tree = {"embed": init_embedding(gen, cfg),
            "frame_proj": dense_init(gen, (cfg.d_model, cfg.d_model))}
    tree["encoder"] = [{"ln1": _init_norm(cfg, dev),
                        "attn": init_attention(gen, cfg),
                        "ln2": _init_norm(cfg, dev),
                        "mlp": init_mlp(gen, cfg)}
                       for _ in range(cfg.n_encoder_layers)]
    tree["decoder"] = [{"ln1": _init_norm(cfg, dev),
                        "self_attn": init_attention(gen, cfg),
                        "ln_x": _init_norm(cfg, dev),
                        "cross_attn": init_attention(gen, cfg),
                        "ln2": _init_norm(cfg, dev),
                        "mlp": init_mlp(gen, cfg)}
                       for _ in range(cfg.n_layers)]
    tree["enc_norm"] = _init_norm(cfg, dev)
    tree["final_norm"] = _init_norm(cfg, dev)
    return EncDec(cfg, tree)


# ---------------------------------------------------------------------------
# forward / loss


def _check_remat(remat: str) -> None:
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r} (one of {REMATS})")


def _positions(x):
    B, S = x.shape[0], x.shape[1]
    return torch.arange(S, device=x.device)[None].expand(B, S)


def encode(cfg: ModelConfig, params: EncDec, frames, *, remat: str = "none",
           attn_impl: str = "auto"):
    """frames (B, S_src, D), the stub's embeddings -> the encoder's output
    (B, S_src, D) in the compute dtype, final-normed: the frames cast to
    the compute dtype, then ``frame_proj``; each layer bidirectional
    attention (rotated by 0..S_src - 1 under rope) and the MLP, pre-norm.
    ``remat="full"`` recomputes each layer in the backward."""
    _check_remat(remat)
    dt = cfg.compute_dtype
    x = frames.to(dt) @ params.frame_proj.to(dt)
    positions = _positions(x)

    def layer_fn(p):
        def run(x):
            h = rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
            x = x + train_attention(p["attn"], h, cfg, positions=positions,
                                    causal=False, impl=attn_impl)
            h = rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
            return x + mlp(p["mlp"], h, cfg)
        return run

    for p in params.encoder:
        run = layer_fn(p)
        if remat == "full":
            run = _checkpointed(run, "full")
        x = run(x)
    return rms_norm(x, params.enc_norm["scale"], cfg.norm_eps)


def _cross_kv(p, enc_out, cfg: ModelConfig):
    """One decoder layer's cross-attention K and V (B, S_src, Hkv, hd) from
    the encoder's output, in its dtype: ``enc_out @ wk`` and ``@ wv``, no
    bias and no rotation (the reference's ``_cross_kv``)."""
    dt = enc_out.dtype
    B, S, _ = enc_out.shape
    k = (enc_out @ p["wk"].to(dt)).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = (enc_out @ p["wv"].to(dt)).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    return k, v


def decode_train_hidden(cfg: ModelConfig, params: EncDec, tokens, enc_out,
                        *, remat: str = "none", final_norm: bool = True,
                        attn_impl: str = "auto"):
    """The teacher-forced decoder trunk: tokens (B, S_tgt) and the
    encoder's output -> the hidden (B, S_tgt, D), final-normed unless
    ``final_norm=False`` (the fused loss normalizes inside its sweep).
    Each layer: causal self-attention (rotated by 0..S_tgt - 1), then
    cross-attention over the encoder's output, then the MLP, pre-norm.
    ``remat="full"`` recomputes each layer in the backward."""
    _check_remat(remat)
    x = embed(params.embed, tokens, cfg)
    positions = _positions(x)

    def layer_fn(p):
        def run(x, enc_out):
            h = rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
            x = x + train_attention(p["self_attn"], h, cfg,
                                    positions=positions, causal=True,
                                    impl=attn_impl)
            h = rms_norm(x, p["ln_x"]["scale"], cfg.norm_eps)
            kv = _cross_kv(p["cross_attn"], enc_out, cfg)
            x = x + train_attention(p["cross_attn"], h, cfg, causal=False,
                                    kv_override=kv, impl=attn_impl)
            h = rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
            return x + mlp(p["mlp"], h, cfg)
        return run

    for p in params.decoder:
        run = layer_fn(p)
        if remat == "full":
            run = _checkpointed(run, "full")
        x = run(x, enc_out)
    if final_norm:
        x = rms_norm(x, params.final_norm["scale"], cfg.norm_eps)
    return x


def forward_hidden(cfg: ModelConfig, params: EncDec, tokens, *, frames,
                   remat: str = "none", final_norm: bool = True,
                   attn_impl: str = "auto"):
    """tokens (B, S_tgt) and frames (B, S_src, D) -> (hidden (B, S_tgt, D),
    aux 0 fp32): :func:`encode`, then :func:`decode_train_hidden`."""
    enc_out = encode(cfg, params, frames, remat=remat, attn_impl=attn_impl)
    x = decode_train_hidden(cfg, params, tokens, enc_out, remat=remat,
                            final_norm=final_norm, attn_impl=attn_impl)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(cfg: ModelConfig, params: EncDec, tokens, *, frames,
            remat: str = "none", attn_impl: str = "auto"):
    """tokens (B, S_tgt), frames (B, S_src, D) -> (logits (B, S_tgt, V)
    fp32, aux)."""
    x, aux = forward_hidden(cfg, params, tokens, frames=frames, remat=remat,
                            attn_impl=attn_impl)
    return unembed(params.embed, x, cfg), aux


def loss_fn(cfg: ModelConfig, params: EncDec, batch, *, attn_impl="auto",
            remat="none", loss_impl=None):
    """batch {tokens, labels, frames, [mask]} -> (ce, {"ce", "aux"}), the
    CE with the final RMSNorm fused into the loss route
    (``pre_norm="rms"``); ``aux`` is 0."""
    from .loss import lm_loss
    hidden, aux = forward_hidden(cfg, params, batch["tokens"],
                                 frames=batch["frames"], remat=remat,
                                 final_norm=False, attn_impl=attn_impl)
    ce, _ = lm_loss(cfg, params, hidden, batch["labels"], batch.get("mask"),
                    impl=loss_impl, pre_norm="rms")
    return ce + aux, {"ce": ce, "aux": aux}


def sampled_loss_fn(cfg: ModelConfig, params: EncDec, batch, seed, *,
                    attn_impl="auto", remat="none", loss_impl=None, **draws):
    """GNB's sampled-label NLL: ``(nll, n_valid)``, the labels drawn from
    the model's own softmax (``models/loss.py:lm_loss_sampled``)."""
    from .loss import lm_loss_sampled
    hidden, _ = forward_hidden(cfg, params, batch["tokens"],
                               frames=batch["frames"], remat=remat,
                               final_norm=False, attn_impl=attn_impl)
    return lm_loss_sampled(cfg, params, hidden, seed, batch.get("mask"),
                           impl=loss_impl, pre_norm="rms", **draws)


def logits_fn(cfg: ModelConfig, params: EncDec, batch, *, attn_impl="auto",
              **_):
    """The logits (B, S_tgt, V) fp32 of ``batch["tokens"]`` against
    ``batch["frames"]`` (the reference's ``logits_fn``, which takes no
    remat)."""
    return forward(cfg, params, batch["tokens"], frames=batch["frames"],
                   attn_impl=attn_impl)[0]


# ---------------------------------------------------------------------------
# serving


def _zeros(cfg: ModelConfig, n: int, length: int, src_len: int,
           device) -> dict:
    kv = (cfg.n_layers, n, length, cfg.n_kv_heads, cfg.hd)
    xkv = (cfg.n_layers, n, src_len, cfg.n_kv_heads, cfg.hd)
    dt = cfg.compute_dtype
    return {"k": torch.zeros(kv, dtype=dt, device=device),
            "v": torch.zeros(kv, dtype=dt, device=device),
            "xk": torch.zeros(xkv, dtype=dt, device=device),
            "xv": torch.zeros(xkv, dtype=dt, device=device)}


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               src_len: int, device="cpu") -> dict:
    """Zeroed whole-prompt cache in the compute dtype: k/v (L, B, max_len,
    Hkv, hd) and xk/xv (L, B, src_len, Hkv, hd)."""
    check_supported(cfg)
    return _zeros(cfg, batch_size, max_len, src_len, device)


def _cross_rows(cfg: ModelConfig, params: EncDec, frames):
    """The encoder on the flash forward (``causal=False``) and every
    decoder layer's cross K/V of its output: (xk, xv) (L, B, S_src, Hkv,
    hd) in the compute dtype."""
    enc_out = encode(cfg, params, frames, attn_impl="flash")
    kvs = [_cross_kv(p["cross_attn"], enc_out, cfg) for p in params.decoder]
    return (torch.stack([k for k, _ in kvs]),
            torch.stack([v for _, v in kvs]))


@torch.inference_mode()
def prefill_encoder(cfg: ModelConfig, params: EncDec, frames, cache):
    """Run the encoder once over frames (B, S_src, D) and return ``cache``
    with its xk/xv replaced by every layer's cross K/V (the reference's
    ``prefill_encoder``)."""
    xk, xv = _cross_rows(cfg, params, frames)
    return dict(cache, xk=xk, xv=xv)


def init_slots(cfg: ModelConfig, n_slots: int, cache_len: int,
               src_len: int = 0, device="cpu") -> dict:
    """Zeroed slot cache of ``n_slots`` slots: the self-attention ring k/v
    (L, N, C, Hkv, hd) and the cross rows xk/xv (L, N, src_len, Hkv, hd),
    in the compute dtype.  An int8 cache raises the reference's
    ``ValueError``."""
    check_supported(cfg)
    if cfg.kv_dtype != "bf16":
        raise ValueError("kv_dtype=int8 is implemented for the paged-KV "
                         "families (dense/moe); encdec keeps bf16 slots")
    return _zeros(cfg, n_slots, cache_len, src_len, device)


def reset_slot(cfg: ModelConfig, cache, slot):
    """Ring masking hides stale self-attention entries; xk/xv are
    overwritten by :func:`prefill_encoder_slot` before the slot decodes."""
    return cache


@torch.inference_mode()
def prefill_encoder_slot(cfg: ModelConfig, params: EncDec, cache, slot: int,
                         frames):
    """Run the encoder for one request, frames (1, S_src, D), and write its
    per-layer cross K/V into slot ``slot``'s rows in place."""
    xk, xv = _cross_rows(cfg, params, frames)
    cache["xk"][:, slot] = xk[:, 0].to(cache["xk"].dtype)
    cache["xv"][:, slot] = xv[:, 0].to(cache["xv"].dtype)
    return cache


def _cross(p, h, cfg: ModelConfig, xk, xv):
    """Cross-attention of h (N, P, D) over the rows xk/xv (N, S_src, Hkv,
    hd): the reference's materialized ``full_attention``."""
    return full_attention(p, h, cfg, causal=False, kv_override=(xk, xv))


def _sweep(cfg: ModelConfig, params: EncDec, cache, x, self_attn, rows):
    """The decoder's layer loop of the serving paths: ``self_attn(p, h,
    kv_l)`` attends the layer's ring and ``rows`` (a slice of the slot
    axis) picks the cross rows.  Returns the hidden state."""
    for i, p in enumerate(params.decoder):
        kv_l = {"k": cache["k"][i], "v": cache["v"][i]}
        x = x + self_attn(p["self_attn"],
                          rms_norm(x, p["ln1"]["scale"], cfg.norm_eps), kv_l)
        x = x + _cross(p["cross_attn"],
                       rms_norm(x, p["ln_x"]["scale"], cfg.norm_eps), cfg,
                       cache["xk"][i][rows], cache["xv"][i][rows])
        x = x + mlp(p["mlp"], rms_norm(x, p["ln2"]["scale"], cfg.norm_eps),
                    cfg)
    return x


@torch.inference_mode()
def decode_slots(cfg: ModelConfig, params: EncDec, cache, tokens, positions,
                 active=None):
    """One decode step across all slots: tokens (N, 1), positions (N,) ->
    logits (N, 1, V) fp32.  Self-attention writes each slot's K/V at its
    position (only where ``active`` (N,) bool is True, when given) and
    attends its ring through the decode kernel; cross-attention attends
    the slot's own rows."""
    positions = positions.to(torch.int32)
    x = embed(params.embed, tokens, cfg)

    def self_attn(p, h, kv_l):
        return decode_attention_slots(p, h, cfg, kv_l, positions,
                                      active=active)

    x = _sweep(cfg, params, cache, x, self_attn, slice(None))
    x = rms_norm(x, params.final_norm["scale"], cfg.norm_eps)
    return unembed(params.embed, x, cfg)


@torch.inference_mode()
def prefill_into_slot(cfg: ModelConfig, params: EncDec, cache, slot: int,
                      tokens, start: int, n_valid: int):
    """Chunk-prefill one slot's decoder prefix: tokens (1, P) at positions
    start..start + P - 1, teacher-forced.  Writes the chunk's K/V into the
    slot's ring and returns the logits (V,) fp32 of the last valid token.
    The slot's cross rows must have been written by
    :func:`prefill_encoder_slot`."""
    P = tokens.shape[1]
    qpos = start + torch.arange(P, dtype=torch.int32, device=tokens.device)
    x = embed(params.embed, tokens, cfg)

    def self_attn(p, h, kv_l):
        return prefill_chunk_attention(p, h, cfg, kv_l, slot, start, qpos)

    x = _sweep(cfg, params, cache, x, self_attn, slice(slot, slot + 1))
    last = rms_norm(x[:, n_valid - 1:n_valid], params.final_norm["scale"],
                    cfg.norm_eps)
    return unembed(params.embed, last, cfg)[0, 0]


def decode_step(cfg: ModelConfig, params: EncDec, cache, tokens,
                position: int):
    """One target token of every row at one position: tokens (B, 1) ->
    logits (B, 1, V) fp32, the row's K/V written at ``position`` of the
    cache in place: :func:`decode_slots` with every slot at ``position``
    (on a cache longer than the position the ring mask is the causal
    prefix, the reference's ``decode_step``)."""
    C = cache["k"].shape[2]
    position = int(position)
    if not 0 <= position < C:
        raise ValueError(f"position {position} outside the cache of {C}")
    positions = torch.full((tokens.shape[0],), position, dtype=torch.int32,
                           device=tokens.device)
    return decode_slots(cfg, params, cache, tokens, positions)
