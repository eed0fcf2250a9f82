"""The whole-prompt serving path held against the JAX reference:
``prefill`` (the last token's logits and the filled linear cache, with
patch embeddings for qwen2-vl), ``decode_step`` at a shared position on
the padded cache, and ``generate_lockstep``, for GPT2_TINY (learned
positions), yi-6b's smoke config (rope, GQA) and qwen2-vl-7b's (M-RoPE,
QKV bias, patch embeddings), fp32, the reference's weights carried across
by ``params_from_jax`` and numpy inputs; and the engine's greedy tokens
against the lockstep path's, as the reference pins its own."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _rope_models import tcfg
from repro.configs import get_config as jax_get_config
from repro.configs.gpt2 import GPT2_TINY
from repro.models import get_model as jax_get_model
from repro.serve import generate_lockstep as jax_generate_lockstep
from repro_torch.convert import params_from_jax
from repro_torch.models import get_model
from repro_torch.serve import generate, generate_lockstep, make_serve_step

torch.set_num_threads(1)

ARCHS = ("gpt2-tiny", "yi-6b", "qwen2-vl-7b")
# fp32 products over D = 64 summed in other orders: the logits within
# 3e-6 plus 1e-6 of the largest (the dense configs' bound), the cache
# within 1e-5, as the slot cache's (tests/test_torch_dense_features.py)
ATOL, LOGIT_RTOL, CACHE_TOL = 3e-6, 1e-6, 1e-5
B, SP, NEW = 2, 7, 5


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(reference config fp32, reference params, the port's params)."""
    cfg = (dataclasses.replace(GPT2_TINY, name="gpt2-tiny")
           if request.param == "gpt2-tiny"
           else jax_get_config(request.param, smoke=True))
    cfg = dataclasses.replace(cfg, dtype="float32")
    params = jax_get_model(cfg).init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, params_from_jax(jax.tree.map(np.asarray, params),
                                        tcfg(cfg))


def _prompt(cfg, S=SP, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close_logits(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=ATOL + LOGIT_RTOL * np.abs(want).max())


def test_prefill_matches_reference(model):
    """The last token's logits (B, 1, V) and every layer's K (rotated
    under rope) and V over the prompt; qwen2-vl with 4 patch embeddings
    over the first positions."""
    cfg, params, tparams = model
    tokens = _prompt(cfg, S=12)
    pe = (np.random.default_rng(2).standard_normal((B, 4, cfg.d_model))
          .astype(np.float32) if cfg.patch_embed_input else None)
    lg, cache = jax_get_model(cfg).prefill(
        cfg, params, jnp.asarray(tokens), attn_impl="full",
        patch_embeds=None if pe is None else jnp.asarray(pe))
    tlg, tcache = get_model(tcfg(cfg)).prefill(
        tcfg(cfg), tparams, torch.from_numpy(tokens),
        patch_embeds=None if pe is None else torch.from_numpy(pe))
    assert tuple(tlg.shape) == (B, 1, cfg.padded_vocab)
    _close_logits(tlg, lg)
    for name in ("k", "v"):
        assert tcache[name].dtype == torch.float32
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(cache[name]), rtol=0,
                                   atol=CACHE_TOL)


def test_decode_step_matches_reference(model):
    """The prefill's cache padded to 12 positions, then 4 decode steps of
    given tokens at the shared position: the logits and the cache after
    each."""
    cfg, params, tparams = model
    tokens = _prompt(cfg)
    jm, tm = jax_get_model(cfg), get_model(tcfg(cfg))
    _, cache = jm.prefill(cfg, params, jnp.asarray(tokens), attn_impl="full")
    cache = jax.tree.map(lambda c: jnp.pad(
        c, ((0, 0), (0, 0), (0, 12 - SP), (0, 0), (0, 0))), cache)
    _, tcache = tm.prefill(tcfg(cfg), tparams, torch.from_numpy(tokens))
    tcache = {k: F.pad(v, (0, 0, 0, 0, 0, 12 - SP))
              for k, v in tcache.items()}
    rng = np.random.default_rng(3)
    for pos in range(SP, SP + 4):
        step = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        lg, cache = jm.decode_step(cfg, params, cache, jnp.asarray(step),
                                   pos)
        tlg = tm.decode_step(tcfg(cfg), tparams, tcache,
                             torch.from_numpy(step), pos)
        _close_logits(tlg, lg)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(cache[name]), rtol=0,
                                   atol=CACHE_TOL)
    with pytest.raises(ValueError, match="outside the cache"):
        tm.decode_step(tcfg(cfg), tparams, tcache, torch.from_numpy(step), 12)


def test_generate_lockstep_matches_reference(model):
    """Greedy lockstep generation (prefill, then a decode step at a time):
    the reference's tokens, each of them."""
    cfg, params, tparams = model
    prompt = _prompt(cfg)
    want = np.asarray(jax_generate_lockstep(cfg, params, jnp.asarray(prompt),
                                            max_new=NEW))
    got = generate_lockstep(tcfg(cfg), tparams, prompt, max_new=NEW)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, NEW)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_matches_lockstep_greedy(model):
    """The engine's greedy tokens (chunked prefill into slots, the decode
    burst) are the lockstep path's, as the reference pins its own
    (``tests/test_serve.py``)."""
    cfg, _, tparams = model
    prompt = _prompt(cfg, seed=4)
    lock = generate_lockstep(tcfg(cfg), tparams, prompt, max_new=NEW)
    eng = generate(tcfg(cfg), tparams, torch.from_numpy(prompt),
                   max_new=NEW, device="cpu")
    np.testing.assert_array_equal(eng.numpy(), lock.numpy())


def test_serve_step_samples_with_a_temperature():
    """``make_serve_step``: greedy is the logits' argmax; a positive
    temperature draws in-vocabulary tokens from the given generator,
    the same ones for the same seed."""
    cfg = dataclasses.replace(jax_get_config("yi-6b", smoke=True),
                              dtype="float32")
    tm = get_model(tcfg(cfg))
    params = tm.init_params(tcfg(cfg), torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_prompt(cfg))
    out = []
    for temp, seed in ((0.0, 0), (1.5, 5), (1.5, 5)):
        _, cache = tm.prefill(tcfg(cfg), params, tokens)
        cache = {k: F.pad(v, (0, 0, 0, 0, 0, 2)) for k, v in cache.items()}
        nxt, logits, _ = make_serve_step(tcfg(cfg), temperature=temp)(
            params, cache, tokens[:, -1:], SP, torch.Generator()
            .manual_seed(seed))
        assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (B, 1)
        assert ((nxt >= 0) & (nxt < cfg.vocab_size)).all()
        out.append(nxt)
    assert torch.equal(out[0][:, 0], torch.argmax(logits, -1).to(torch.int32))
    assert torch.equal(out[1], out[2])
