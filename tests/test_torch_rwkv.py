"""The RWKV-6 family held against the JAX reference (``repro.models.rwkv``)
on rwkv6-7b's smoke config (d 128, two heads of 64, 2 layers), fp32
unless a case says bf16: the WKV functions, token shift, decay, time and
channel mix, the logits and final state of ``forward`` on both WKV routes,
``loss_fn``'s loss and every gradient on two loss routes, the sampled loss,
remat, the parameter tree and the optimizer engine's layout and state,
and ``check_supported``.  The reference's weights cross by
``params_from_jax``; inputs come from numpy seeds.  Where the model is
ill-conditioned the fp32 bounds add the reference's own one-ulp spread,
and bf16 is held against the reference compiled to round where its code
says (``tests/_rwkv_models.py``; the spreads: ``_rwkv_ref_spread.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _rope_models import tcfg
from _rwkv_models import (REF_BF16, assert_close, batch, port_params,
                          random_state, ref_params, ref_spread, rwkv_cfg)
from repro.core.engine import build_layout as jax_build_layout
from repro.core.engine import ravel_shards as jax_ravel_shards
from repro.kernels.fused_ce import seed_from_key
from repro.models import get_model as jax_get_model
from repro.models import rwkv as jr
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import make_engine as jax_make_engine
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config
from repro_torch.convert import engine_state_from_jax, params_from_jax
from repro_torch.core import build_layout, ravel_shards
from repro_torch.core.types import flat_tensors, tree_leaves
from repro_torch.models import check_supported, get_model
from repro_torch.models import rwkv as tr
from repro_torch.train import TrainerConfig, make_engine

torch.set_num_threads(1)


def _np(t):
    return t.detach().float().numpy()


def _wkv_inputs(B=2, S=64, H=2, K=64, seed=0):
    """r, k, v, logw (B, S, H, K), u (H, K), state (B, H, K, K): a third of
    the decays at the -4 clamp and more within 0.5 of it."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, S, H, K)) for _ in range(3))
    logw = -4.0 * rng.random((B, S, H, K)) ** 0.5
    logw = np.where(rng.random((B, S, H, K)) < 0.33, -4.0, logw)
    logw = np.clip(logw, -4.0, -1e-6)
    u = 0.1 * rng.standard_normal((H, K))
    st = 0.5 * rng.standard_normal((B, H, K, K))
    return [a.astype(np.float32) for a in (r, k, v, logw, u, st)]


# ---------------------------------------------------------------------------
# the WKV functions


@pytest.mark.parametrize("n_chunks", [1, 2, 3])
@pytest.mark.parametrize("fn", ["wkv_scan", "wkv_chunked"])
def test_wkv_matches_reference(fn, n_chunks):
    """Each WKV function against the reference's same function, from a
    random state with decays near the clamp, over 1-3 chunks of 32: the
    outputs and the final state within 1e-5 of their largest element."""
    args = _wkv_inputs(S=jr.CHUNK * n_chunks, seed=n_chunks)
    o, s = getattr(jr, fn)(*map(jnp.asarray, args))
    to, ts = getattr(tr, fn)(*map(torch.from_numpy, args))
    for got, want in ((to, o), (ts, s)):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        assert np.isfinite(_np(got)).all()


def test_chunked_matches_scan():
    """The port's two WKV routes against each other over 3 chunks, as
    tests/test_models.py holds the reference's: within 1e-4."""
    args = [torch.from_numpy(a) for a in _wkv_inputs(S=96, seed=7)]
    o1, s1 = tr.wkv_scan(*args)
    o2, s2 = tr.wkv_chunked(*args)
    np.testing.assert_allclose(_np(o2), _np(o1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(s2), _np(s1), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="chunk"):
        tr.wkv_chunked(*[a[:, :40] if a.dim() == 4 and a.shape[1] == 96
                         else a for a in args])


# ---------------------------------------------------------------------------
# the layers


@pytest.fixture(scope="module")
def model():
    """(reference config fp32, reference params, the port's params)."""
    cfg = rwkv_cfg()
    params = ref_params(cfg)
    return cfg, params, port_params(cfg, params)


def _layer0(params):
    return jax.tree.map(lambda a: a[0], params["layers"])


def test_token_shift_and_decay_match_reference(model):
    """``_token_shift`` bit for bit, ``_decay`` (the LoRA, then fp32
    ``-exp`` clipped to [-4, -1e-6]) within 1e-5 of its largest element,
    on inputs whose decays reach both ends of the clip."""
    cfg, params, tparams = model
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    prev = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    want = np.asarray(jr._token_shift(jnp.asarray(x), jnp.asarray(prev)))
    got = tr._token_shift(torch.from_numpy(x), torch.from_numpy(prev))
    np.testing.assert_array_equal(_np(got), want)
    tm = dict(_layer0(params)["tm"])
    tm["w0"] = jnp.asarray(np.linspace(-16, 3, cfg.d_model,
                                       dtype=np.float32))
    ttm = {k: torch.from_numpy(np.array(v)) for k, v in tm.items()
           if k in ("w0", "wa", "wb")}
    want = np.asarray(jr._decay(tm, jnp.asarray(x)))
    got = tr._decay(ttm, torch.from_numpy(x))
    assert want.min() == -4.0 and want.max() == np.float32(-1e-6)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("S", [64, 40])
def test_time_mix_and_channel_mix_match_reference(model, S):
    """Layer 0's time mix (the chunked WKV at S 64, the scan at S 40) and
    channel mix from a nonzero carried state: outputs, last tokens and the
    new WKV state within 1e-5 of their largest element."""
    cfg, params, tparams = model
    p = _layer0(params)
    st = {k: v[0] for k, v in random_state(cfg, 2).items()}
    x = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    out = jr.time_mix(p["tm"], jnp.asarray(x), cfg,
                      jnp.asarray(st["tm_shift"]), jnp.asarray(st["wkv"]))
    got = tr.time_mix(tparams.layers[0]["tm"], torch.from_numpy(x),
                      tcfg(cfg), torch.from_numpy(st["tm_shift"]),
                      torch.from_numpy(st["wkv"]))
    out += jr.channel_mix(p["cm"], jnp.asarray(x), jnp.asarray(
        st["cm_shift"]))
    got += tr.channel_mix(tparams.layers[0]["cm"], torch.from_numpy(x),
                          torch.from_numpy(st["cm_shift"]))
    for g, w in zip(got, out):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


# ---------------------------------------------------------------------------
# the smoke model


def test_parameter_tree_is_the_reference_tree(model):
    """The same leaves in the same sorted order and shapes, bit for bit:
    ``embed/{tok, unembed}``, ``final_norm/scale`` and the stacked
    ``layers/{cm, ln1, ln2, tm/{ln_x, mu, u, w0, wa, ...}}``."""
    cfg, params, tparams = model
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = tree_leaves(tparams.param_tree())
    assert len(got) == len(want) == 21
    for leaf, (path, ref) in zip(got, want):
        arr = torch.stack(leaf) if isinstance(leaf, list) else leaf
        assert tuple(arr.shape) == ref.shape, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(_np(arr), np.asarray(ref))
    assert sum(p.numel() for p in tparams.parameters()) == sum(
        np.asarray(x).size for x in jax.tree.leaves(params))


def test_params_from_jax_refuses_unknown_keys(model):
    """A top-level key or a layer leaf the port does not know raises."""
    cfg, params, _ = model
    np_params = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="top-level"):
        params_from_jax(dict(np_params, patch_proj=np.zeros((2, 2))),
                        tcfg(cfg))
    layers = dict(np_params["layers"], extra={"x": np.zeros((2, 3))})
    with pytest.raises(ValueError, match="leaves"):
        params_from_jax(dict(np_params, layers=layers), tcfg(cfg))


@pytest.mark.parametrize("S,dtype", [(64, "float32"), (40, "float32"),
                                     (64, "bfloat16"), (40, "bfloat16")])
def test_forward_logits_and_state_match_reference(model, S, dtype):
    """``forward`` (S 64 takes the chunked WKV, S 40 the scan), its logits
    and final state.  fp32: within 1e-5 of the largest element plus four
    times the reference's own spread when its weights move by one ulp.
    bf16: every logit within 2e-2 of the largest and every state element
    within 2e-2 of its leaf's largest, against the reference compiled
    with ``xla_allow_excess_precision`` off (REF_BF16), and the port's
    bf16 logits as near the reference's fp32 ones as the reference's bf16
    (RMS, within 1.5x)."""
    cfg, params, tparams = model
    cfg = dataclasses.replace(cfg, dtype=dtype)
    jb, tb = batch(cfg, S=S)
    got, aux, state = get_model(tcfg(cfg)).forward(tcfg(cfg), tparams,
                                                   tb["tokens"])
    assert float(aux) == 0.0

    jfwd = jax.jit(lambda p: jax_get_model(cfg).forward(cfg, p,
                                                        jb["tokens"]),
                   compiler_options=REF_BF16 if dtype == "bfloat16" else None)
    if dtype == "float32":
        (want, _, wstate), (spread, _, sstate) = ref_spread(jfwd, params)
        assert_close(_np(got), want, spread, what="logits")
        for k in wstate:
            assert_close(_np(state[k]), wstate[k], sstate[k], what=k)
        return
    want, _, wstate = jfwd(params)
    want = np.asarray(want)
    c32 = dataclasses.replace(cfg, dtype="float32")
    f32 = np.asarray(jax_get_model(c32).forward(c32, params,
                                                jb["tokens"])[0])

    def rms(a):
        return float(np.sqrt(np.mean(np.square(a))))

    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())
    assert rms(_np(got) - f32) <= 1.5 * rms(want - f32)
    for k in wstate:
        w = np.asarray(wstate[k].astype(jnp.float32))
        assert state[k].dtype == (torch.float32 if k == "wkv"
                                  else torch.bfloat16)
        np.testing.assert_allclose(_np(state[k]), w, rtol=0,
                                   atol=2e-2 * np.abs(w).max())


def _assert_grads(tparams, loss, grads, spreads):
    """Every leaf's gradient within 1e-5 of its largest element plus four
    times the reference's one-ulp spread."""
    tree = tparams.param_tree()
    it = iter(torch.autograd.grad(loss, flat_tensors(tree)))
    for leaf, want, spread in zip(tree_leaves(tree), jax.tree.leaves(grads),
                                  jax.tree.leaves(spreads)):
        got = (torch.stack([next(it) for _ in leaf])
               if isinstance(leaf, list) else next(it))
        assert np.abs(np.asarray(want)).max() > 0
        assert_close(_np(got), want, spread, what="gradient")


@pytest.mark.parametrize("impl", ["fused", "chunked"])
def test_loss_and_grads_match_reference(model, impl):
    """``loss_fn`` on the fused-kernel twin route (the final RMSNorm fused
    into the sweep; on the CPU the kernels' plain versions) and on the
    chunked route: the loss, aux 0 and every gradient."""
    cfg, params, tparams = model
    jb, tb = batch(cfg)

    @jax.jit
    def value_and_grad(p):
        return jax.value_and_grad(lambda q: jax_get_model(cfg).loss_fn(
            cfg, q, jb, loss_impl=impl)[0])(p)

    (jloss, jgrads), (sloss, sgrads) = ref_spread(value_and_grad, params)
    loss, met = get_model(tcfg(cfg)).loss_fn(tcfg(cfg), tparams, tb,
                                             loss_impl=impl)
    assert_close(loss.item(), jloss, sloss, what="loss")
    assert met["aux"].item() == 0.0 and met["ce"].item() == loss.item()
    _assert_grads(tparams, loss, jgrads, sgrads)


def test_sampled_loss_matches_reference(model):
    """GNB's sampled NLL on the reference's noise seed (the fused route):
    the count, the NLL and every gradient."""
    cfg, params, tparams = model
    jb, tb = batch(cfg, seed=2)
    key = jax.random.PRNGKey(11)

    @jax.jit
    def value_and_grad(p):
        return jax.value_and_grad(
            lambda q: jax_get_model(cfg).sampled_loss_fn(
                cfg, q, jb, key, loss_impl="fused"), has_aux=True)(p)

    ((jnll, jn), jgrads), ((snll, _), sgrads) = ref_spread(value_and_grad,
                                                           params)
    nll, n = get_model(tcfg(cfg)).sampled_loss_fn(
        tcfg(cfg), tparams, tb, np.asarray(seed_from_key(key)))
    assert float(n) == float(jn)
    assert_close(nll.item(), jnll, snll, what="nll")
    _assert_grads(tparams, nll, jgrads, sgrads)


@pytest.mark.parametrize("remat", ["full", "dots", "scan2"])
def test_remat_is_bit_identical(remat):
    """Each remat policy ("full" checkpoints every layer; "dots" and
    "scan2" run as "none", as in the reference): the loss and every
    gradient equal those without remat, bit for bit."""
    cfg = tcfg(rwkv_cfg())
    params = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0))
    _, tb = batch(cfg)
    out = []
    for policy in ("none", remat):
        loss, _ = get_model(cfg).loss_fn(cfg, params, tb, remat=policy)
        out.append([loss] + list(torch.autograd.grad(
            loss, flat_tensors(params.param_tree()))))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("block", [128, 128 * 1024])
def test_layout_and_state_match_reference(model, block):
    """``build_layout`` over the RWKV tree gives the reference's leaf
    order, offsets and shard sizes, the raveled parameters bit for bit,
    and the reference engine's state carries over to the port's engine as
    a plain copy (``engine_state_from_jax``)."""
    cfg, params, tparams = model
    tree = tparams.param_tree()
    ref, lay = jax_build_layout(params, block=block), build_layout(
        tree, block=block)
    assert lay.leaf_shapes == ref.leaf_shapes
    assert lay.leaf_offset == ref.leaf_offset
    assert lay.shard_sizes == ref.shard_sizes
    assert lay.manifest() == ref.manifest()
    for a, b in zip(ravel_shards(lay, tree), jax_ravel_shards(ref, params)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    over = dict(optimizer="sophia_g", peak_lr=5e-4, total_steps=8)
    jeng = jax_make_engine(JTrainerConfig(**over))
    eng = make_engine(TrainerConfig(**over))
    rng = np.random.default_rng(5)
    jstate = jeng.init(params)
    jstate = jstate._replace(
        m=tuple(jnp.asarray(rng.standard_normal(m.shape).astype(np.float32))
                for m in jstate.m))
    state = engine_state_from_jax(jax.tree.map(np.asarray, jstate),
                                  eng.layout(tree))
    for got, want in zip(state.m + state.h, jstate.m + jstate.h):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# check_supported


def test_check_supported_takes_rwkv_by_its_own_fields():
    """The dense trunk's norm, activation and rope fields do not refuse an
    RWKV config; a width that is not a multiple of the head dim 64 raises
    the ``ValueError`` the reference's head count implies; an encoder-
    decoder config and a Griffin config are each taken by their own fields
    (here the encoder's depth and the window)."""
    cfg = get_config("rwkv6-7b", smoke=True)
    check_supported(dataclasses.replace(cfg, norm_type="other",
                                        activation="other", n_heads=3))
    with pytest.raises(ValueError, match="64"):
        check_supported(dataclasses.replace(cfg, d_model=96))
    assert "rwkv6-7b" in ARCHS
    with pytest.raises(ValueError, match="n_encoder_layers"):
        check_supported(dataclasses.replace(cfg, family="encdec"))
    with pytest.raises(ValueError, match="local_window"):
        check_supported(dataclasses.replace(cfg, family="griffin"))
    check_supported(dataclasses.replace(cfg, family="griffin",
                                        local_window=16))
