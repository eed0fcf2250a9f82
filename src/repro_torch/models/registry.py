"""Family dispatch: ModelConfig -> the functions implementing it."""
from __future__ import annotations

from types import SimpleNamespace

from . import transformer
from .common import ModelConfig


def get_model(cfg: ModelConfig) -> SimpleNamespace:
    """The family's training functions (``forward_hidden``, ``forward``,
    ``loss_fn``, ``sampled_loss_fn``, ``logits_fn``, as in
    ``models/transformer.py``) and
    its serve-engine slot protocol:

        init_params(cfg, generator)                     -> Transformer
        init_slots(cfg, n_slots, cache_len, device)     -> slot cache dict
        prefill_into_slot(cfg, params, cache, slot,
                          tokens, start, n_valid)       -> logits (V,)
        decode_slots(cfg, params, cache, tok, pos,
                     active=None)                       -> logits (N, 1, V)
        reset_slot(cfg, cache, slot)                    -> cache

    Prefill and decode update the cache in place.  Only the dense family
    is ported; the others raise ``NotImplementedError``."""
    if cfg.family == "dense":
        return SimpleNamespace(
            init_params=transformer.init_params,
            forward_hidden=transformer.forward_hidden,
            forward=transformer.forward,
            loss_fn=transformer.loss_fn,
            sampled_loss_fn=transformer.sampled_loss_fn,
            logits_fn=transformer.logits_fn,
            init_slots=transformer.init_slots,
            prefill_into_slot=transformer.prefill_into_slot,
            decode_slots=transformer.decode_slots,
            reset_slot=transformer.reset_slot,
        )
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
