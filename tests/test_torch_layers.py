"""The port's dense layers (repro_torch.models.layers) against the JAX
reference (repro.models.layers) on the same numpy inputs, fp32."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gpt2 import GPT2_TINY
from repro.models import layers as jl
from repro_torch.models import layers as tl
from repro_torch.models.common import ModelConfig

TOL = 1e-6  # fp32: the same operations, sums in another order

CFG = dataclasses.replace(GPT2_TINY, dtype="float32")
TCFG = ModelConfig(**dataclasses.asdict(CFG))


def _rng(seed):
    return np.random.default_rng(seed)


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_layer_norm():
    r = _rng(0)
    x = r.standard_normal((2, 5, 128), dtype=np.float32) * 3 + 1
    scale = r.standard_normal(128, dtype=np.float32)
    bias = r.standard_normal(128, dtype=np.float32)
    ref = jl.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                        1e-6)
    got = tl.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                        torch.from_numpy(bias), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


def test_mlp_tanh_gelu():
    r = _rng(1)
    D, F = 128, 512
    p = {"w_up": r.standard_normal((D, F), dtype=np.float32) / np.sqrt(D),
         "b_up": r.standard_normal(F, dtype=np.float32) * 0.1,
         "w_down": r.standard_normal((F, D), dtype=np.float32) / np.sqrt(F),
         "b_down": r.standard_normal(D, dtype=np.float32) * 0.1}
    x = r.standard_normal((3, 4, D), dtype=np.float32) * 0.5
    ref = jl.mlp(_j(p), jnp.asarray(x), CFG)
    got = tl.mlp(_t(p), torch.from_numpy(x), TCFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


def test_embed_learned_positions():
    r = _rng(2)
    p = {"tok": r.standard_normal((CFG.padded_vocab, 128),
                                  dtype=np.float32) * 0.02,
         "pos": r.standard_normal((CFG.max_position_embeddings, 128),
                                  dtype=np.float32) * 0.02}
    toks = r.integers(0, CFG.vocab_size, (2, 7)).astype(np.int32)
    pos = (np.arange(7)[None] + np.array([[0], [40]])).astype(np.int32)
    ref = jl.embed(_j(p), jnp.asarray(toks), CFG, jnp.asarray(pos))
    got = tl.embed(_t(p), torch.from_numpy(toks), TCFG, torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("vocab", [512, 500])   # 500 pads to 512: masked
def test_unembed_tied(vocab):
    cfg = dataclasses.replace(CFG, vocab_size=vocab)
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    r = _rng(3)
    p = {"tok": r.standard_normal((cfg.padded_vocab, 128),
                                  dtype=np.float32) * 0.02}
    x = r.standard_normal((2, 3, 128), dtype=np.float32)
    ref = np.asarray(jl.unembed(_j(p), jnp.asarray(x), cfg))
    got = tl.unembed(_t(p), torch.from_numpy(x), tcfg).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=TOL)
    assert (got[..., vocab:] == -1e30).all()


@pytest.mark.parametrize("window", [None, 5, 1 << 30])
def test_ring_mask_exact(window):
    """Positions below, inside and past the ring (negative (pos - s) give
    floor-mod, not truncation), with and without a window."""
    C = 16
    pos = np.array([0, 3, 15, 16, 17, 40, 1000], np.int32)
    ref = np.asarray(jl.ring_mask(jnp.asarray(pos), C, window))
    got = tl.ring_mask(torch.from_numpy(pos), C, window).numpy()
    np.testing.assert_array_equal(got, ref)


def test_ring_write_matches_and_skips_inactive():
    r = _rng(4)
    N, C = 3, 8
    cache = r.standard_normal((N, C, 2, 4), dtype=np.float32)
    val = r.standard_normal((N, 1, 2, 4), dtype=np.float32)
    pos = np.array([3, 11, 8], np.int32)
    ref = np.asarray(jl.ring_write(jnp.asarray(cache), jnp.asarray(val),
                                   jnp.asarray(pos)))
    got = tl.ring_write(torch.from_numpy(cache.copy()), torch.from_numpy(val),
                        torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), ref)
    active = torch.tensor([True, False, True])
    got = tl.ring_write(torch.from_numpy(cache.copy()), torch.from_numpy(val),
                        torch.from_numpy(pos), active)
    np.testing.assert_array_equal(got[1].numpy(), cache[1])
    np.testing.assert_array_equal(got[0].numpy(), ref[0])


def test_attention_scale_rounds_in_fp32():
    """layer_scale / sqrt(hd) as the reference computes it: a traced fp32
    layer scale divided by a Python float, in fp32."""
    for hd, s in [(32, 1.0), (64, 1.0), (128, 0.5), (256, 1.0 / 3.0)]:
        cfg = dataclasses.replace(TCFG, head_dim=hd)
        want = jnp.asarray(s, jnp.float32) / np.sqrt(hd)
        assert tl.attention_scale(cfg, s) == float(want)


def _attn_params(r, D, H, Hkv, hd):
    return {"wq": r.standard_normal((D, H * hd), dtype=np.float32) / np.sqrt(D),
            "wk": r.standard_normal((D, Hkv * hd), dtype=np.float32)
            / np.sqrt(D),
            "wv": r.standard_normal((D, Hkv * hd), dtype=np.float32)
            / np.sqrt(D),
            "wo": r.standard_normal((H * hd, D), dtype=np.float32)
            / np.sqrt(H * hd)}


@pytest.mark.parametrize("S,kv_block,window,softcap,heads,dtype", [
    (40, 16, None, None, (4, 4), "float32"),     # 16 shrinks to 10
    (40, 1024, None, None, (4, 4), "float32"),   # one block
    (48, 16, 9, 20.0, (4, 2), "float32"),        # window, softcap, GQA
    (33, 8, None, None, (4, 1), "float32"),      # 33 = 3 x 11: blocks of 3
    (40, 16, 7, None, (4, 4), "bfloat16")])
def test_chunked_attention_matches_reference(S, kv_block, window, softcap,
                                             heads, dtype):
    """The online softmax over KV blocks (kv_block shrunk to a divisor of
    S, the -1e30 mask, a -inf initial max) against the reference's
    ``chunked_attention`` on the same inputs: fp32 within 1e-6, bf16
    within 2e-2 (the reference tests' bf16 bound); and, in fp32, the
    materialized route's output within 1e-5."""
    H, Hkv = heads
    cfg = dataclasses.replace(CFG, n_heads=H, n_kv_heads=Hkv,
                              attn_logit_softcap=softcap)
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    r = _rng(5)
    p = _attn_params(r, cfg.d_model, H, Hkv, cfg.hd)
    x = r.standard_normal((2, S, cfg.d_model), dtype=np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    ref = jl.chunked_attention(_j(p), jx, cfg, None, window=window,
                               kv_block=kv_block)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tl.chunked_attention(_t(p), tx, tcfg, window=window,
                               kv_block=kv_block)
    assert got.dtype == tx.dtype
    want = np.asarray(ref.astype(jnp.float32))
    atol = 2e-2 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol)
    if dtype == "float32":
        full = tl.full_attention(_t(p), tx, tcfg, window=window)
        np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    """Token-level CE of fp32 logits, the mean or the masked mean, against
    the reference's ``cross_entropy`` (and a manual log-softmax)."""
    r = _rng(6)
    logits = r.standard_normal((2, 4, 8), dtype=np.float32) * 2
    labels = r.integers(0, 8, (2, 4)).astype(np.int32)
    mask = (r.random((2, 4)) > 0.4).astype(np.float32) if masked else None
    ref = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                           None if mask is None else jnp.asarray(mask))
    got = tl.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    nll = -np.take_along_axis(lp, labels[..., None], -1)[..., 0]
    manual = nll.mean() if mask is None else (nll * mask).sum() / mask.sum()
    np.testing.assert_allclose(got.item(), manual, rtol=1e-5)
