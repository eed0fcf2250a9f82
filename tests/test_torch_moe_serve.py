"""The MoE family's serving held against the JAX reference, for
deepseek-moe-16b's and llama4-maverick's smoke configs (fp32 compute, the
reference's weights carried across by ``params_from_jax``, numpy inputs):
``prefill_into_slot`` and ``decode_slots`` with bf16 and int8 slot caches,
and the whole-prompt path (``prefill``, ``decode_step``,
``generate_lockstep``); the engine is in tests/test_torch_moe_engine.py.
Every row is routed as in the reference: a prefill chunk's padded tail and
the idle slots of a decode step compete for the experts' capacity there
too."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _rope_models import tcfg
from repro.configs import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.models.layers import set_decode_attn_impl
from repro.serve import generate_lockstep as jax_generate_lockstep
from repro_torch.convert import params_from_jax
from repro_torch.models import get_model
from repro_torch.serve import generate_lockstep

torch.set_num_threads(1)

NAMES = ("deepseek-moe-16b", "llama4-maverick-400b-a17b")
# the dense configs' serving bounds (tests/test_torch_dense_features.py):
# fp32 logits within 1e-4 and the cache within 1e-5; an int8 cache one
# quantization step apart at most and its logits within 2e-3; the
# whole-prompt path's logits within 3e-6 plus 1e-6 of the largest
# (tests/test_torch_lockstep.py)
ATOL, LOGIT_RTOL, CACHE_TOL = 3e-6, 1e-6, 1e-5


def _setup(arch, seed=0, **over):
    """(reference config fp32, reference params, the port's params); a
    uniquely named config, since the reference compiles one program per
    config."""
    cfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                              dtype="float32", name=f"{arch}-moe-serve",
                              **over)
    params = jax_get_model(cfg).init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, params, params_from_jax(jax.tree.map(np.asarray, params),
                                        tcfg(cfg))


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    return _setup(request.param)


def _pallas(fn):
    set_decode_attn_impl("pallas")
    try:
        return fn()
    finally:
        set_decode_attn_impl("xla")


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_and_decode_match_reference(model, kv_dtype):
    """Two slots prefilled in chunks of 16 (one ragged: its padded tail is
    routed), then three decode steps of three slots, one of them idle, the
    reference decoding through its Pallas kernel in interpret mode."""
    cfg, params, tparams = model
    cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    atol = 2e-3 if kv_dtype == "int8" else 1e-4
    jm, tm = jax_get_model(cfg), get_model(tcfg(cfg))
    N, C, P = 3, 40, 16
    st, tst = jm.init_slots(cfg, N, C), tm.init_slots(tcfg(cfg), N, C)
    rng = np.random.default_rng(0)
    prompts = {1: rng.integers(0, cfg.vocab_size, 11),
               2: rng.integers(0, cfg.vocab_size, 29)}
    for slot, prompt in prompts.items():
        for start in range(0, len(prompt), P):
            chunk = prompt[start:start + P].astype(np.int32)
            n = len(chunk)
            chunk = np.pad(chunk, (0, P - n))[None]
            st, lg = jm.prefill_into_slot(cfg, params, st, slot,
                                          jnp.asarray(chunk), start, n)
            tlg = tm.prefill_into_slot(tcfg(cfg), tparams, tst, slot,
                                       torch.from_numpy(chunk), start, n)
            np.testing.assert_allclose(tlg.numpy(), np.asarray(lg),
                                       atol=atol)
    pos = np.array([0, 11, 29], np.int32)
    for step in range(3):
        toks = rng.integers(0, cfg.vocab_size, (N, 1)).astype(np.int32)
        lg, st = _pallas(lambda: jm.decode_slots(
            cfg, params, st, jnp.asarray(toks), jnp.asarray(pos + step)))
        tlg = tm.decode_slots(tcfg(cfg), tparams, tst,
                              torch.from_numpy(toks),
                              torch.from_numpy(pos + step))
        np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), atol=atol)
    for key, leaf in st.items():
        ref, got = np.asarray(leaf), tst[key].numpy()
        if ref.dtype == np.int8:
            assert np.abs(ref.astype(np.int32)
                          - got.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


B, SP, NEW = 2, 7, 5


def _prompt(cfg, S=SP, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close_logits(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=ATOL + LOGIT_RTOL * np.abs(want).max())


def test_whole_prompt_path_matches_reference(model):
    """``prefill`` (the last token's logits, every layer's rotated K and
    V), 4 ``decode_step``s at the shared position on the padded cache,
    and the greedy tokens of ``generate_lockstep``.  (The engine's tokens
    need not be the lockstep's here, unlike the dense family's: the
    lockstep prefill routes both prompts' tokens as one group, the engine
    each prompt alone, and the experts' capacity binds differently.)"""
    cfg, params, tparams = model
    jm, tm = jax_get_model(cfg), get_model(tcfg(cfg))
    tokens = _prompt(cfg)
    lg, cache = jm.prefill(cfg, params, jnp.asarray(tokens),
                           attn_impl="full")
    tlg, tcache = tm.prefill(tcfg(cfg), tparams, torch.from_numpy(tokens))
    _close_logits(tlg, lg)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(cache[name]), rtol=0,
                                   atol=CACHE_TOL)
    cache = jax.tree.map(lambda c: jnp.pad(
        c, ((0, 0), (0, 0), (0, 12 - SP), (0, 0), (0, 0))), cache)
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
    want = np.asarray(jax_generate_lockstep(cfg, params, jnp.asarray(tokens),
                                            max_new=NEW))
    got = generate_lockstep(tcfg(cfg), tparams, tokens, max_new=NEW)
    np.testing.assert_array_equal(got.numpy(), want)
