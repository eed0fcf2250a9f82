"""Family dispatch: ModelConfig -> the functions implementing it."""
from __future__ import annotations

from types import SimpleNamespace

from . import encdec, griffin, rwkv, transformer
from .common import ModelConfig


def get_model(cfg: ModelConfig) -> SimpleNamespace:
    """The family's training functions (``forward_hidden``, ``forward``,
    ``loss_fn``, ``sampled_loss_fn``, ``logits_fn``, as in
    ``models/transformer.py``), its whole-prompt serving path:

        init_cache(cfg, batch, max_len, device)         -> linear cache dict
        prefill(cfg, params, tokens, patch_embeds=None) -> logits (B, 1, V),
                                                           cache
        decode_step(cfg, params, cache, tok, position)  -> logits (B, 1, V)

    and its serve-engine slot protocol:

        init_params(cfg, generator)                     -> Transformer
        init_slots(cfg, n_slots, cache_len, device)     -> slot cache dict
        prefill_into_slot(cfg, params, cache, slot,
                          tokens, start, n_valid)       -> logits (V,)
        decode_slots(cfg, params, cache, tok, pos,
                     active=None)                       -> logits (N, 1, V)
        reset_slot(cfg, cache, slot)                    -> cache

    ``prefill`` returns a new cache; the other prefill and decode
    functions update theirs in place.  The dense and MoE families share
    the transformer's functions, as in the reference.  The RWKV family
    (``models/rwkv.py``) has no ``prefill``: its cache is the bounded
    recurrent state (``init_cache`` is ``init_state``; the lockstep path
    feeds the prompt one token at a time), ``init_slots`` ignores the
    cache length and refuses an int8 cache, and ``reset_slot`` zeroes the
    slot.  The Griffin family (``models/griffin.py``) has no ``prefill``
    either: its state is the recurrent layers' plus a ring KV cache of the
    attention window's size, which ``init_cache`` and ``init_slots`` build
    whatever the cache length; ``prefill_into_slot`` feeds a chunk one
    token at a time through ``decode_slots``, ``reset_slot`` zeroes the
    recurrent state and leaves the ring to its mask.  The encoder-decoder
    family (``models/encdec.py``) takes ``frames`` (B, S_src, D) beside
    the tokens in training; its caches add each slot's cross-attention
    rows, so ``init_cache`` and ``init_slots`` take the source length
    (``init_cache(cfg, batch, max_len, src_len, device)``,
    ``init_slots(cfg, n_slots, cache_len, src_len, device)``), the encoder
    runs once a request (``prefill_encoder(cfg, params, frames, cache)``
    for the whole-prompt path, ``prefill_encoder_slot(cfg, params, cache,
    slot, frames)`` for the engine, before the decoder prefix's chunks),
    ``reset_slot`` is the identity and there is no ``prefill``.  Another
    family raises ``NotImplementedError``."""
    if cfg.family in ("dense", "moe"):
        return SimpleNamespace(
            init_params=transformer.init_params,
            forward_hidden=transformer.forward_hidden,
            forward=transformer.forward,
            loss_fn=transformer.loss_fn,
            sampled_loss_fn=transformer.sampled_loss_fn,
            logits_fn=transformer.logits_fn,
            init_cache=transformer.init_cache,
            prefill=transformer.prefill,
            decode_step=transformer.decode_step,
            init_slots=transformer.init_slots,
            prefill_into_slot=transformer.prefill_into_slot,
            decode_slots=transformer.decode_slots,
            reset_slot=transformer.reset_slot,
        )
    if cfg.family == "rwkv":
        return SimpleNamespace(
            init_params=rwkv.init_params,
            forward_hidden=rwkv.forward_hidden,
            forward=rwkv.forward,
            loss_fn=rwkv.loss_fn,
            sampled_loss_fn=rwkv.sampled_loss_fn,
            logits_fn=rwkv.logits_fn,
            init_cache=lambda c, b, _len=None, device="cpu":
                rwkv.init_state(c, b, device),
            decode_step=rwkv.decode_step,
            init_slots=rwkv.init_slots,
            prefill_into_slot=rwkv.prefill_into_slot,
            decode_slots=rwkv.decode_slots,
            reset_slot=rwkv.reset_slot,
        )
    if cfg.family == "griffin":
        return SimpleNamespace(
            init_params=griffin.init_params,
            forward_hidden=griffin.forward_hidden,
            forward=griffin.forward,
            loss_fn=griffin.loss_fn,
            sampled_loss_fn=griffin.sampled_loss_fn,
            logits_fn=griffin.logits_fn,
            init_cache=lambda c, b, _len=None, device="cpu":
                griffin.init_state(c, b, device),
            decode_step=griffin.decode_step,
            init_slots=griffin.init_slots,
            prefill_into_slot=griffin.prefill_into_slot,
            decode_slots=griffin.decode_slots,
            reset_slot=griffin.reset_slot,
        )
    if cfg.family == "encdec":
        return SimpleNamespace(
            init_params=encdec.init_params,
            forward_hidden=encdec.forward_hidden,
            forward=encdec.forward,
            loss_fn=encdec.loss_fn,
            sampled_loss_fn=encdec.sampled_loss_fn,
            logits_fn=encdec.logits_fn,
            init_cache=encdec.init_cache,
            prefill_encoder=encdec.prefill_encoder,
            decode_step=encdec.decode_step,
            init_slots=encdec.init_slots,
            prefill_encoder_slot=encdec.prefill_encoder_slot,
            prefill_into_slot=encdec.prefill_into_slot,
            decode_slots=encdec.decode_slots,
            reset_slot=encdec.reset_slot,
        )
    raise NotImplementedError(f"family {cfg.family!r} is not ported")
