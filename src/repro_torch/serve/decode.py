"""Serving decode: the engine's burst loop, sampling, ``generate``, and
the lockstep baseline.

The counterpart of ``repro/serve/decode.py``.  ``make_decode_burst`` is the
engine's hot loop: ``n_steps`` decode steps over all slots with per-slot
position, remaining-token budget, EOS and greedy/temperature sampling, all
on the device — the loop issues work and never reads a value back, so the
host does not wait on the device inside a burst.  ``generate_lockstep`` is
the reference's pre-engine path, kept as the baseline of the serving
benchmark: the whole prompt prefilled at once, then a Python token loop in
which every row decodes at one shared position.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models import ModelConfig, get_model

NO_EOS = -1  # sentinel: no EOS id for this slot


def make_serve_step(cfg: ModelConfig, *, temperature: float = 0.0):
    """Returns serve_step(params, cache, tokens, position, gen) ->
    (next_tokens (B, 1) int32, logits (B, V), cache): one
    ``decode_step`` at ``position`` (the cache updated in place), then
    greedy or, with a positive temperature, a draw from ``gen``."""
    model = get_model(cfg)

    def serve_step(params, cache, tokens, position, gen):
        logits = model.decode_step(cfg, params, cache, tokens,
                                   position)[:, -1, :]
        temps = torch.full((logits.shape[0],), float(temperature),
                           device=logits.device)
        nxt = sample_tokens(gen, logits, temps)
        return nxt[:, None], logits, cache

    return serve_step


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


def generate_lockstep(cfg: ModelConfig, params, prompt_tokens, *,
                      max_new: int, temperature: float = 0.0, seed: int = 0,
                      max_len: Optional[int] = None):
    """Fixed-batch generation, every request in lockstep: prompt (B, S_p)
    int -> (B, max_new) int32 on the CPU, drawing from a generator seeded
    with ``seed`` on the parameters' device.  The dense and MoE families
    put the whole prompt through ``prefill`` (the flash route), pad its
    cache to ``max_len`` (default S_p + max_new) and take the prefill
    logits' argmax as the first token; the recurrent families (RWKV,
    Griffin) feed the prompt one token at a time through :func:`make_serve_step` at
    positions 0..S_p - 1 from ``init_cache``, the last of those steps'
    token being the first generated one.  Then ``max_new - 1`` steps of
    :func:`make_serve_step` at the shared position.  The reference's
    ``generate_lockstep``, which has no encoder-decoder route: an encdec
    config raises ``ValueError`` (serve it through the engine, or
    ``prefill_encoder`` and ``decode_step``)."""
    if cfg.family not in ("dense", "moe", "rwkv", "griffin"):
        raise ValueError(f"generate_lockstep has no route for family "
                         f"{cfg.family!r} (the reference asserts dense, "
                         f"moe, rwkv or griffin)")
    model = get_model(cfg)
    device = params.embed["tok"].device
    prompt = torch.as_tensor(np.asarray(prompt_tokens)).to(device)
    B, Sp = prompt.shape
    max_len = max_len or (Sp + max_new)
    serve_step = make_serve_step(cfg, temperature=temperature)
    gen = torch.Generator(device=device).manual_seed(seed)
    if cfg.family in ("dense", "moe"):
        logits, cache = model.prefill(cfg, params, prompt)
        pad = max_len - Sp
        cache = {name: F.pad(c, (0, 0, 0, 0, 0, pad))
                 for name, c in cache.items()}
        toks = [torch.argmax(logits[:, -1, :], dim=-1).to(
            torch.int32)[:, None]]
    else:
        cache = model.init_cache(cfg, B, max_len, device)
        for t in range(Sp):
            last, _, cache = serve_step(params, cache, prompt[:, t:t + 1],
                                        t, gen)
        toks = [last]
    for pos in range(Sp, Sp + max_new - 1):
        last, _, cache = serve_step(params, cache, toks[-1], pos, gen)
        toks.append(last)
    return torch.cat(toks, dim=1).cpu()
