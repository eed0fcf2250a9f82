"""Serving decode: the engine's burst loop, sampling, and ``generate``.

The counterpart of ``repro/serve/decode.py``.  ``make_decode_burst`` is the
engine's hot loop: ``n_steps`` decode steps over all slots with per-slot
position, remaining-token budget, EOS and greedy/temperature sampling, all
on the device — the loop issues work and never reads a value back, so the
host does not wait on the device inside a burst.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models import ModelConfig, get_model

NO_EOS = -1  # sentinel: no EOS id for this slot


def sample_tokens(gen: torch.Generator, logits, temps):
    """Greedy where temps <= 0, temperature sampling elsewhere.
    logits (N, V) fp32; temps (N,) fp32 -> (N,) int32.  Greedy takes the
    first maximal index; sampling is a Gumbel-max draw from ``gen`` (its
    draws differ from ``jax.random``'s)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / temps.clamp_min(1e-6)[:, None]
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    sampled = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
    return torch.where(temps > 0.0, sampled, greedy)


def make_decode_burst(cfg: ModelConfig, n_steps: int):
    """Builds burst(params, cache, tokens, positions, remaining, temps,
    eos_ids, gen) -> (cache, tokens, positions, remaining, ys, act).

      * ``remaining[i] > 0`` marks slot i active; an inactive slot is
        frozen (no cache write, position pinned, last token re-fed), so
        slots still prefilling and free slots ride along inertly;
      * a slot that emits its EOS id or spends its budget deactivates
        inside the loop;
      * ``ys`` (n_steps, N) are the emitted tokens and ``act`` (n_steps, N)
        marks which are real.

    The cache is updated in place and returned for symmetry with the
    reference."""
    model = get_model(cfg)

    def burst(params, cache, tokens, positions, remaining, temps, eos_ids,
              gen):
        ys, acts = [], []
        for _ in range(n_steps):
            active = remaining > 0
            logits = model.decode_slots(cfg, params, cache, tokens, positions,
                                        active=active)
            nxt = sample_tokens(gen, logits[:, -1, :], temps)
            nxt = torch.where(active, nxt, tokens[:, 0])
            hit_eos = active & (nxt == eos_ids)
            remaining = torch.where(
                active, torch.where(hit_eos, torch.zeros_like(remaining),
                                    remaining - 1), remaining)
            positions = torch.where(active, positions + 1, positions)
            tokens = nxt[:, None]
            ys.append(nxt)
            acts.append(active)
        return (cache, tokens, positions, remaining, torch.stack(ys),
                torch.stack(acts))

    return burst


def generate(cfg: ModelConfig, params, prompt_tokens, *, max_new: int,
             temperature: float = 0.0, seed: int = 0,
             max_len: Optional[int] = None, eos_id: Optional[int] = None,
             page_len: Optional[int] = None, device=None):
    """Greedy/temperature batched generation through the engine, one slot
    per row: prompt (B, S_p) int -> (B, max_new) int32 on the CPU.  Runs
    on the GPU unless ``device`` says otherwise (see
    :func:`~repro_torch.serve.engine.resolve_device`)."""
    from .engine import Request, ServeEngine

    B, Sp = prompt_tokens.shape
    eng = ServeEngine(cfg, params, n_slots=B,
                      cache_len=max_len or (Sp + max_new),
                      page_len=page_len or min(Sp, 32),
                      steps_per_tick=min(8, max(1, max_new - 1)), seed=seed,
                      device=device)
    for i in range(B):
        eng.submit(Request(uid=i, tokens=prompt_tokens[i], max_new=max_new,
                           temperature=temperature, eos_id=eos_id))
    results = {r.uid: r for r in eng.run()}
    out = torch.full((B, max_new), eos_id if eos_id is not None else 0,
                     dtype=torch.int32)
    for i in range(B):
        toks = results[i].tokens
        out[i, :len(toks)] = torch.tensor(toks, dtype=torch.int32)
    return out
