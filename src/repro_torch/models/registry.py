"""Family dispatch: ModelConfig -> the functions implementing it."""
from __future__ import annotations

from types import SimpleNamespace

from . import transformer
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
    the transformer's functions, as in the reference; the others are not
    ported and raise ``NotImplementedError``."""
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
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
