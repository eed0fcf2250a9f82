"""The dense layer features of yi-6b, qwen1.5-110b and gemma2-9b held
against the JAX reference: RMSNorm, GeGLU, QKV bias, sandwich norms and
the embedding scale, each alone and in the three smoke configs (fp32, the
reference's weights carried across by ``params_from_jax`` with every
all-zero leaf, the biases and the RMSNorm scales, drawn from a seed so
that it shows; numpy inputs): forward logits, the loss on the fused,
chunked and unfused routes with every gradient, the sampled loss, remat,
prefill and decode through the slot cache and the engine's greedy tokens,
a few Sophia-G trainer steps and a Hutchinson refresh.  The smoke configs' head
dims (8 and 16) are below what the reference's flash kernel takes, so
both sides attend on the materialized-scores route."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _rope_models import tcfg, trajectories
from repro.configs import get_config as jax_get_config
from repro.kernels.fused_ce import seed_from_key
from repro.models import get_model as jax_get_model
from repro.models import layers as jl
from repro.models.layers import set_decode_attn_impl
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.core.types import flat_tensors, tree_leaves
from repro_torch.models import check_supported, get_model
from repro_torch.models import layers as tl
from repro_torch.serve import Request, ServeEngine

torch.set_num_threads(1)

NAMES = ("yi-6b", "qwen1.5-110b", "gemma2-9b")
# fp32 sums over D = 64 and 2-4 layers in other orders: losses and
# gradients (of magnitude <= 1) within 3e-6, the rope tests' bound; yi's
# and qwen's untied logits reach ~4.7, where an fp32 ulp is 4.8e-7, and a
# logit near 0 summed from such terms lands up to 4.2e-6 away (~9 ulps of
# the largest), so the logits also get 1e-6 of the largest one
ATOL = 3e-6
LOGIT_RTOL = 1e-6


def _cfg(arch, **over):
    return dataclasses.replace(jax_get_config(arch, smoke=True),
                               **{"dtype": "float32", **over})


def _seeded_zeros(params, seed=3):
    """The reference tree with every all-zero leaf (QKV biases, RMSNorm
    scales, which init to 0) drawn from N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if np.any(x):
            return jnp.asarray(x)
        return jnp.asarray((0.1 * rng.standard_normal(x.shape))
                           .astype(x.dtype))
    return jax.tree.map(fill, params)


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    """(reference config, reference params, the port's params)."""
    cfg = _cfg(request.param)
    params = _seeded_zeros(jax_get_model(cfg).init_params(
        cfg, jax.random.PRNGKey(0)))
    return cfg, params, params_from_jax(jax.tree.map(np.asarray, params),
                                        tcfg(cfg))


def _batch(cfg, B=2, S=40, seed=1):
    """S = 40 puts gemma2's smoke window of 16 inside the sequence."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "mask": (rng.random((B, S)) > 0.25).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _assert_grads(tparams, loss, jgrads, atol):
    tree = tparams.param_tree()
    grads = iter(torch.autograd.grad(loss, flat_tensors(tree)))
    for leaf, want in zip(tree_leaves(tree), jax.tree.leaves(jgrads)):
        got = (torch.stack([next(grads) for _ in leaf])
               if isinstance(leaf, list) else next(grads))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


# ---------------------------------------------------------------------------
# the features alone


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    """fp32 statistics and ``(1 + scale)``, cast back: fp32 within 3e-6;
    bf16 outputs within one bf16 ulp (the two rsqrt's may round the fp32
    value to either side of a bf16 boundary)."""
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((4, 7, 96)) + 0.5).astype(np.float32)
    scale = (0.3 * rng.standard_normal(96)).astype(np.float32)
    want = np.asarray(jl.rms_norm(jnp.asarray(x).astype(dtype),
                                  jnp.asarray(scale), 1e-6)).astype(np.float32)
    got = tl.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(scale), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)


def test_geglu_matches_reference():
    """GeGLU ``(gelu_tanh(x Wg) * (x Wu)) Wd`` on gemma2's smoke leaves:
    the tanh GELU, jax.nn.gelu's default, within 3e-6."""
    cfg = _cfg("gemma2-9b")
    p = jl.init_mlp(jax.random.PRNGKey(2), cfg)
    x = np.random.default_rng(1).standard_normal((2, 5, cfg.d_model)) \
        .astype(np.float32)
    want = np.asarray(jl.mlp(p, jnp.asarray(x), cfg))
    got = tl.mlp({k: torch.from_numpy(np.array(v)) for k, v in p.items()},
                 torch.from_numpy(x), tcfg(cfg))
    assert sorted(p) == ["w_down", "w_gate", "w_up"]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_scale_rounds_the_constant_first(dtype):
    """gemma2's ``x * sqrt(d_model)`` at its full width (3584): the
    constant rounded to the compute dtype before the multiply, as the
    reference's ``jnp.asarray(sqrt(d), x.dtype)``, bit for bit; in bf16 a
    multiply by the fp32 constant would differ."""
    cfg = _cfg("gemma2-9b", d_model=3584, dtype=dtype)
    table = (0.02 * np.random.default_rng(4).standard_normal(
        (cfg.padded_vocab, 3584))).astype(np.float32)
    tokens = np.arange(0, 512, 5, dtype=np.int32)[None]
    want = np.asarray(jl.embed({"tok": jnp.asarray(table)},
                               jnp.asarray(tokens), cfg)).astype(np.float32)
    got = tl.embed({"tok": torch.from_numpy(table)},
                   torch.from_numpy(tokens), tcfg(cfg))
    np.testing.assert_array_equal(got.float().numpy(), want)
    if dtype == "bfloat16":
        x = torch.from_numpy(table)[torch.from_numpy(tokens).long()]
        fp32_const = (x.to(torch.bfloat16).float() * 3584 ** 0.5).to(
            torch.bfloat16)
        assert (fp32_const.float().numpy() != want).any()


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "deepseek-moe-16b",
                                  "rwkv6-7b"])
def test_check_supported_still_refuses(arch):
    """M-RoPE and patch-embedding inputs (qwen2-vl) and the other families
    stay refused; the three new configs are in ``ARCHS`` and pass."""
    cfg = tcfg(jax_get_config(arch, smoke=True))
    with pytest.raises(NotImplementedError) as err:
        check_supported(cfg)
    if arch == "qwen2-vl-7b":
        assert "mrope_sections" in str(err.value)
        assert "patch_embed_input" in str(err.value)
    else:
        assert "family" in str(err.value)
    for name in NAMES:
        check_supported(tcfg(jax_get_config(name)))
        assert name in ARCHS


# ---------------------------------------------------------------------------
# the three smoke configs


def test_parameter_tree_is_the_reference_tree(model):
    """The same leaves in the same sorted order and shapes: RMSNorm scales
    without biases, ``bq/bk/bv`` with QKV bias, ``ln1_post`` and
    ``ln2_post`` with sandwich norms."""
    cfg, params, tparams = model
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = tree_leaves(tparams.param_tree())
    assert len(got) == len(want)
    for leaf, (path, ref) in zip(got, want):
        shape = ((len(leaf),) + tuple(leaf[0].shape)
                 if isinstance(leaf, list) else tuple(leaf.shape))
        assert shape == ref.shape, jax.tree_util.keystr(path)
    names = {jax.tree_util.keystr(p) for p, _ in want}
    assert any("'bias'" in n for n in names) is (cfg.norm_type == "ln")
    assert any("'bq'" in n for n in names) is cfg.qkv_bias
    assert any("'ln1_post'" in n for n in names) is cfg.post_norms


def test_forward_logits_match_reference(model):
    cfg, params, tparams = model
    jb, tb = _batch(cfg)
    want, _ = jax_get_model(cfg).forward(cfg, params, jb["tokens"])
    got, _ = get_model(tcfg(cfg)).forward(tcfg(cfg), tparams, tb["tokens"])
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want,
        atol=ATOL + LOGIT_RTOL * np.abs(want).max())


@pytest.mark.parametrize("impl", ["fused", "chunked", "unfused"])
def test_loss_and_grads_match_reference(model, impl):
    """The masked-mean CE with RMSNorm as the final norm (fused into the
    sweep on "fused"), gemma2's final softcap and tied table, qwen's
    biases: loss and every gradient within 3e-6."""
    cfg, params, tparams = model
    jb, tb = _batch(cfg)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_get_model(cfg).loss_fn(cfg, p, jb, loss_impl=impl,
                                             attn_impl="full"),
        has_aux=True)(params)
    loss, _ = get_model(tcfg(cfg)).loss_fn(tcfg(cfg), tparams, tb,
                                           loss_impl=impl, attn_impl="full")
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL)
    _assert_grads(tparams, loss, jgrads, ATOL)


def test_sampled_loss_matches_reference(model):
    """GNB's sampled NLL on the reference's noise seed: the same draws,
    the NLL, its count and ĝ within 3e-6."""
    cfg, params, tparams = model
    jb, tb = _batch(cfg, seed=2)
    key = jax.random.PRNGKey(11)
    (jnll, jn), jgrads = jax.value_and_grad(
        lambda p: jax_get_model(cfg).sampled_loss_fn(
            cfg, p, jb, key, loss_impl="fused", attn_impl="full"),
        has_aux=True)(params)
    nll, n = get_model(tcfg(cfg)).sampled_loss_fn(
        tcfg(cfg), tparams, tb, np.asarray(seed_from_key(key)),
        attn_impl="full")
    assert float(n) == float(jn)
    np.testing.assert_allclose(nll.item(), float(jnll), atol=ATOL)
    _assert_grads(tparams, nll, jgrads, ATOL)


def test_flash_and_chunked_routes_agree(model):
    """The port's flash (plain version on the CPU) and chunked routes give
    the materialized route's hidden state through every feature (softmax
    sums in other orders: within 1e-5)."""
    cfg, _, tparams = model
    _, tb = _batch(cfg)
    fh = get_model(tcfg(cfg)).forward_hidden
    ref, _ = fh(tcfg(cfg), tparams, tb["tokens"], attn_impl="full")
    for impl in ("flash", "chunked"):
        got, _ = fh(tcfg(cfg), tparams, tb["tokens"], attn_impl=impl)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("remat", ["full", "dots", "scan2"])
def test_remat_is_bit_identical_through_the_sandwich_norms(remat):
    """gemma2's 4 smoke layers (sandwich norms, GeGLU, the window) under
    each remat policy ("scan2": one group of 4): the loss and every
    gradient equal those without remat, bit for bit."""
    cfg = tcfg(_cfg("gemma2-9b"))
    params = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0))
    _, tb = _batch(cfg)
    out = []
    for policy in ("none", remat):
        loss, _ = get_model(cfg).loss_fn(cfg, params, tb, remat=policy,
                                         attn_impl="flash")
        out.append([loss] + list(torch.autograd.grad(
            loss, flat_tensors(params.param_tree()))))
    for a, b in zip(*out):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# serving


def _pallas(fn):
    set_decode_attn_impl("pallas")
    try:
        return fn()
    finally:
        set_decode_attn_impl("xla")


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_and_decode_match_reference(model, kv_dtype):
    """Two slots prefilled in chunks of 16 (one ragged, one past gemma2's
    window), then three decode steps of three slots, the reference
    decoding through its Pallas kernel in interpret mode: the QKV biases
    reach the cached K and V, the sandwich norms and the window the sweep.
    Logits within 1e-4 and the cache within 1e-5 (fp32), as the rope
    models' serving test; an int8 cache one quantization step apart at
    most and its logits within 2e-3 (see tests/test_torch_rope_serve.py)."""
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


MIXED = [(5, 7), (13, 3), (21, 9), (30, 5), (3, 8)]


@pytest.mark.parametrize("name", ["qwen1.5-110b", "gemma2-9b"])
def test_engine_greedy_tokens_match_reference(name):
    """5 mixed requests over 3 slots (chunked prefill of 8-token chunks
    interleaved with decode bursts, slot reuse, prompts past gemma2's
    window of 16): the port's engine on the CPU emits exactly the
    reference engine's greedy tokens."""
    # a uniquely named config: the reference compiles one program per
    # config, and this one must trace on the Pallas route
    cfg = _cfg(name, name=f"{name}-port-engine-parity")
    params = _seeded_zeros(jax_get_model(cfg).init_params(
        cfg, jax.random.PRNGKey(1)))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg(cfg))
    kw = dict(n_slots=3, cache_len=64, page_len=8, steps_per_tick=4, seed=0)

    def requests(cls):
        rng = np.random.default_rng(10)
        return [cls(uid=i, tokens=rng.integers(0, cfg.vocab_size, sp)
                    .astype(np.int32), max_new=mn)
                for i, (sp, mn) in enumerate(MIXED)]

    eng = ServeEngine(tcfg(cfg), tparams, device="cpu", **kw)
    for r in requests(Request):
        eng.submit(r)
    got = {r.uid: r.tokens for r in eng.run()}

    def ref():
        jeng = JServeEngine(cfg, params, **kw)
        for r in requests(JRequest):
            jeng.submit(r)
        return {r.uid: r.tokens for r in jeng.run()}

    assert got == _pallas(ref)
    assert [len(got[i]) for i in range(len(MIXED))] == [m for _, m in MIXED]


# ---------------------------------------------------------------------------
# training


@pytest.mark.parametrize("name", ["qwen1.5-110b", "gemma2-9b"])
def test_sophia_g_trajectory_matches_reference_trainer(name):
    """5 Sophia-G steps with the GNB refresh at 0 and 4 (the fused loss,
    the reference's noise seeds), from the seeded weights: the trajectory
    contract of tests/test_torch_train.py, equal refresh counts, losses to
    rtol 1e-4 / atol 1e-5, every parameter coordinate within 2e-3 and >=
    99.95% of them within 3e-6 + 1e-5 |a|, m and h within 2e-3."""
    cfg = _cfg(name)
    params = _seeded_zeros(jax_get_model(cfg).init_params(
        cfg, jax.random.PRNGKey(0)))
    hist, hist_ref, a, b, s_port, s_ref = trajectories(
        cfg, "full", dict(optimizer="sophia_g"), 5, params=params)
    assert int(s_port.opt_state.hess_count) == \
        int(s_ref.opt_state.hess_count) == 2
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in hist_ref], rtol=1e-4,
                               atol=1e-5)
    bad = np.abs(b - a) > (3e-6 + 1e-5 * np.abs(a))
    assert bad.mean() <= 5e-4, f"{bad.sum()} / {bad.size} beyond 3e-6"
    np.testing.assert_allclose(b, a, rtol=1e-2, atol=2e-3)
    for x, y in zip(s_port.opt_state.m + s_port.opt_state.h,
                    s_ref.opt_state.m + s_ref.opt_state.h):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-2,
                                   atol=2e-3)


def test_hutchinson_refresh_through_the_gemma2_layers():
    """One Sophia-H step with the Hutchinson refresh on gemma2's smoke
    config: its HVP runs forward-over-reverse through RMSNorm, the
    sandwich norms, GeGLU, the embedding scale and both softcaps, on the
    reference's probe.  The loss within 1e-5 and the refreshed h within
    1e-4 of its largest element, the bound of the rope models' case
    (tests/test_torch_neox.py)."""
    cfg = _cfg("gemma2-9b")
    params = _seeded_zeros(jax_get_model(cfg).init_params(
        cfg, jax.random.PRNGKey(0)))
    hist, hist_ref, _, _, s_port, s_ref = trajectories(
        cfg, "full", dict(optimizer="sophia_h", estimator="hutchinson"), 1,
        params=params)
    np.testing.assert_allclose(hist[0]["loss"], hist_ref[0]["loss"],
                               atol=1e-5)
    for x, y in zip(s_port.opt_state.h, s_ref.opt_state.h):
        y = np.asarray(y)
        assert np.abs(y).max() > 0
        np.testing.assert_allclose(x.numpy(), y, rtol=0,
                                   atol=1e-4 * np.abs(y).max())
