"""The port's Hutchinson and empirical-Fisher estimators
(repro_torch.core.estimators) and the twins they differentiate twice
(``fused_lm_loss_jvp``, the flash attention's ``use_jvp``) held against
the JAX reference on GPT2_TINY in fp32: the same weights, the same numpy
batch, the reference's own probe u (``jax.random.normal`` per flat shard,
which no PyTorch code reproduces) passed to the port, and the reference's
twins (``fused_jvp``, ``flash_jvp``) in interpret mode.

Both packages take H u forward-over-reverse (the reference ``jax.jvp`` of
``jax.grad``, the port ``torch.func.jvp`` of ``torch.func.grad`` through
the twins' ``jvp`` rules): each leaf of u ⊙ Hu within 1e-5 of that leaf's
largest |u ⊙ Hu|."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.gpt2 import GPT2_TINY
from repro.core import estimators as jest
from repro.core.engine import build_layout as jax_build_layout
from repro.models import get_model as jax_get_model
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import make_train_fns as jax_make_train_fns
from repro_torch.convert import params_from_jax
from repro_torch.core import build_layout, unravel_shards
from repro_torch.core.estimators import (empirical_fisher_estimator_flat,
                                         functional_loss,
                                         hutchinson_estimator,
                                         hutchinson_estimator_flat)
from repro_torch.core.types import flat_tensors, tree_leaves, tree_unflatten
from repro_torch.kernels import ref as kref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_ce import fused_lm_loss, fused_lm_loss_jvp
from repro_torch.models import ModelConfig, get_model
from repro_torch.train import TrainerConfig, make_train_fns

# One intra-op thread per process: the suite runs six pytest-xdist workers
# on the machine's cores, and torch's default pool in every worker
# oversubscribes them, slowing every test beside it (JAX's too) severalfold.
torch.set_num_threads(1)

CFG32 = dataclasses.replace(GPT2_TINY, dtype="float32")
TCFG32 = ModelConfig(**dataclasses.asdict(CFG32))
REL = 1e-5      # per leaf, of the leaf's largest |u ⊙ Hu|


@pytest.fixture(scope="module")
def weights():
    params = jax_get_model(CFG32).init_params(CFG32, jax.random.PRNGKey(0))
    return params, params_from_jax(jax.tree.map(np.asarray, params), TCFG32)


def _batch(B=2, S=16, mask=True, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, CFG32.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, CFG32.vocab_size, (B, S)).astype(np.int32)}
    if mask:
        out["mask"] = (rng.random((B, S)) > 0.25).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _leaf_close(got, want, rel=REL):
    """Each leaf within ``rel`` of its largest |value| (``want`` sets the
    scale)."""
    for a, b in zip(got, want):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        scale = np.abs(b).max()
        assert scale > 0
        assert np.abs(a - b).max() <= rel * scale, \
            f"max diff {np.abs(a - b).max()} vs {rel} x {scale}"


# ---------------------------------------------------------------------------
# the estimators against the reference


@pytest.mark.parametrize("attn", ["flash", "full"])
def test_hutchinson_flat_matches_reference(weights, attn):
    """The port's u ⊙ Hu on the fused-loss twin and the flash twin (or the
    materialized attention) against the reference's on its
    ``fused_jvp``/``flash_jvp`` route, the same probe shards: every leaf
    within 1e-5 of its largest |u ⊙ Hu|, the tail pad exactly zero."""
    params, tparams = weights
    jb, tb = _batch()
    jm, tm = jax_get_model(CFG32), get_model(TCFG32)
    jattn = "flash_jvp" if attn == "flash" else "full"
    tattn = "flash_jvp" if attn == "flash" else "full"
    jlay = jax_build_layout(params)
    rng = jax.random.PRNGKey(3)
    want = jest.hutchinson_estimator_flat(
        lambda p: jm.loss_fn(CFG32, p, jb, attn_impl=jattn,
                             loss_impl="fused_jvp")[0], params, rng, jlay)
    keys = jax.random.split(rng, jlay.n_shards)
    u_sh = tuple(torch.from_numpy(np.array(
        jax.random.normal(k, (s,), jnp.float32)))
        for k, s in zip(keys, jlay.shard_sizes))

    tree = tparams.param_tree()
    lay = build_layout(tree)
    assert lay.shard_sizes == tuple(jlay.shard_sizes)
    got = hutchinson_estimator_flat(
        functional_loss(tparams, flat_tensors(tree),
                        lambda m: tm.loss_fn(TCFG32, m, tb, attn_impl=tattn,
                                             loss_impl="fused_jvp")[0]),
        tree, u_sh, lay)
    for g, w_, used in zip(got, want, lay.shard_used):
        assert g.dtype == torch.float32 and not g[used:].any()
        assert np.abs(np.asarray(w_)[used:]).max() == 0.0
    wt = tuple(torch.from_numpy(np.asarray(w_)) for w_ in want)
    _leaf_close([t.numpy() for t in unravel_shards(lay, got)],
                [t.numpy() for t in unravel_shards(lay, wt)])


def test_hutchinson_on_the_chunked_loss_matches_reference(weights):
    """The trainer's HVP with ``fused_loss=False``: the chunked loss (its
    backward and tangent recomputing each vocabulary chunk, plain
    PyTorch) and flash attention's twin against the reference's chunked
    loss (a checkpointed ``lax.scan``) and ``flash_jvp``, the same probe
    shards: every leaf within 1e-5 of its largest |u ⊙ Hu|."""
    params, tparams = weights
    jb, tb = _batch()
    jm, tm = jax_get_model(CFG32), get_model(TCFG32)
    jlay = jax_build_layout(params)
    rng = jax.random.PRNGKey(5)
    want = jest.hutchinson_estimator_flat(
        lambda p: jm.loss_fn(CFG32, p, jb, attn_impl="flash_jvp",
                             loss_impl="chunked")[0], params, rng, jlay)
    keys = jax.random.split(rng, jlay.n_shards)
    u_sh = tuple(torch.from_numpy(np.array(
        jax.random.normal(k, (s,), jnp.float32)))
        for k, s in zip(keys, jlay.shard_sizes))
    tree = tparams.param_tree()
    lay = build_layout(tree)
    got = hutchinson_estimator_flat(
        functional_loss(tparams, flat_tensors(tree),
                        lambda m: tm.loss_fn(TCFG32, m, tb,
                                             attn_impl="flash_jvp",
                                             loss_impl="chunked")[0]),
        tree, u_sh, lay)
    wt = tuple(torch.from_numpy(np.asarray(w_)) for w_ in want)
    _leaf_close([t.numpy() for t in unravel_shards(lay, got)],
                [t.numpy() for t in unravel_shards(lay, wt)])


def test_hutchinson_tree_form_matches_reference(weights):
    """The tree form with the reference's per-leaf probe (``split`` over
    the leaves), on the materialized attention and the loss twin."""
    params, tparams = weights
    jb, tb = _batch(B=1, S=12, mask=False)
    jm, tm = jax_get_model(CFG32), get_model(TCFG32)
    rng = jax.random.PRNGKey(5)
    want = jest.hutchinson_estimator(
        lambda p: jm.loss_fn(CFG32, p, jb, attn_impl="full",
                             loss_impl="fused_jvp")[0], params, rng)
    leaves = jax.tree.leaves(params)
    keys = jax.random.split(rng, len(leaves))
    u_leaves = [np.asarray(jax.random.normal(k, p.shape, jnp.float32))
                for k, p in zip(keys, leaves)]
    tree = tparams.param_tree()
    u = tree_unflatten(tree, [t for leaf, v in zip(tree_leaves(tree),
                                                   u_leaves)
                              for t in (list(torch.from_numpy(v))
                                        if isinstance(leaf, list)
                                        else [torch.from_numpy(v)])])
    got = hutchinson_estimator(
        functional_loss(tparams, flat_tensors(tree),
                        lambda m: tm.loss_fn(TCFG32, m, tb, attn_impl="full",
                                             loss_impl="fused_jvp")[0]),
        tree, u)
    _leaf_close([torch.stack(g).numpy() if isinstance(g, list) else g.numpy()
                 for g in tree_leaves(got)],
                [np.asarray(w_) for w_ in jax.tree.leaves(want)])


def test_empirical_fisher_shards_and_scale_match_reference(weights):
    """E-F's g ⊙ g shards against the reference's on the fused loss, and
    its scale (rows x sequence of the sub-batch) through one refresh step
    of each trainer: the refreshed h, (1 - b2) B g ⊙ g, agrees."""
    params, tparams = weights
    jb, tb = _batch(B=2, S=16, mask=False)
    jm, tm = jax_get_model(CFG32), get_model(TCFG32)
    jlay = jax_build_layout(params)
    want = jest.empirical_fisher_estimator_flat(
        lambda p: jm.loss_fn(CFG32, p, jb, loss_impl="fused")[0], params,
        jlay)
    tree = tparams.param_tree()
    got = empirical_fisher_estimator_flat(
        lambda: tm.loss_fn(TCFG32, tparams, tb)[0], tree, build_layout(tree))
    for g, w_ in zip(got, want):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g.numpy(), w_, rtol=1e-4,
                                   atol=1e-5 * np.abs(w_).max())

    over = dict(optimizer="sophia_g", estimator="empirical_fisher",
                hess_subbatch=1, peak_lr=1e-3, warmup_steps=1,
                total_steps=4, seed=0)
    j_init, j_step = jax_make_train_fns(CFG32, JTrainerConfig(**over))
    js = j_init(jax.random.PRNGKey(0))
    t_init, t_step = make_train_fns(TCFG32, TrainerConfig(**over),
                                    device="cpu")
    ts = t_init(params_from_jax(jax.tree.map(np.asarray, js.params),
                                TCFG32))
    js, _ = j_step(js, jb, jnp.asarray(True))
    ts, _ = t_step(ts, tb, True)
    assert int(ts.opt_state.hess_count) == int(js.opt_state.hess_count) == 1
    for a, b in zip(ts.opt_state.h, js.opt_state.h):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max())


# ---------------------------------------------------------------------------
# the loss twin


def _ce_inputs(N, D, V, Vp, transpose_w, seed=0):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    w = rng.standard_normal((D, Vp) if transpose_w else (Vp, D)) * 0.2
    w = torch.from_numpy(w.astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, V, (N,)).astype(np.int32))
    mask = torch.from_numpy((rng.random(N) > 0.3).astype(np.float32))
    return h, w, labels, mask


def _plain_ce(h, w, labels, mask, *, V, transpose_w, softcap):
    logits = h @ (w if transpose_w else w.T)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    nll = F.cross_entropy(logits[:, :V], labels.long(), reduction="none")
    return (nll * mask).sum() / mask.sum()


@pytest.mark.parametrize("transpose_w,softcap", [(False, None), (True, 30.0),
                                                 (False, 5.0)])
def test_fused_jvp_twin_loss_grad_and_hvp(transpose_w, softcap):
    """The twin's loss and first gradient equal the fused loss's (its
    plain versions here) within 1e-6; its HVP, forward-over-reverse
    (``torch.func.jvp`` of ``torch.func.grad``: the twin's tangent rule
    and the tangent of its backward), equals
    ``torch.autograd.functional.hvp`` of the plain CE over materialized
    logits (a padded vocab: 300 of 384 columns, 2 chunks of 256 and 128)
    within 1e-5 of its largest element."""
    N, D, V, Vp = 40, 32, 300, 384
    h, w, labels, mask = _ce_inputs(N, D, V, Vp, transpose_w)
    kw = dict(vocab_size=V, transpose_w=transpose_w, softcap=softcap)

    hv = h.clone().requires_grad_(True)
    wv = w.clone().requires_grad_(True)
    twin, n_twin = fused_lm_loss_jvp(hv, wv, labels, mask, **kw)
    base, n_base = fused_lm_loss(h.clone().requires_grad_(True), w, labels,
                                 mask, **kw)
    assert float(n_twin) == float(n_base)
    np.testing.assert_allclose(twin.item(), base.item(), rtol=1e-6)
    g_twin = torch.autograd.grad(twin, (hv, wv))
    hb, wb = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
    g_base = torch.autograd.grad(
        fused_lm_loss(hb, wb, labels, mask, **kw)[0], (hb, wb))
    for a, b in zip(g_twin, g_base):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)

    rng = np.random.default_rng(9)
    u = tuple(torch.from_numpy(rng.standard_normal(t.shape)
                               .astype(np.float32)) for t in (h, w))
    _, hvp = torch.func.jvp(torch.func.grad(
        lambda a, b: fused_lm_loss_jvp(a, b, labels, mask, **kw)[0],
        argnums=(0, 1)), (h, w), u)
    _, want = torch.autograd.functional.hvp(
        lambda a, b: _plain_ce(a, b, labels, mask, V=V,
                               transpose_w=transpose_w, softcap=softcap),
        (h, w), u)
    _leaf_close([t.numpy() for t in hvp], [t.numpy() for t in want])


# ---------------------------------------------------------------------------
# the attention twin


@pytest.mark.parametrize("H,Hkv,S,window,softcap", [
    (4, 4, 24, None, None), (4, 2, 40, 9, 20.0)])
def test_flash_jvp_twin_output_jvp_and_hvp(H, Hkv, S, window, softcap):
    """The twin's output equals the flash route's (its plain version) and
    the oracle; its JVP (``torch.func.jvp``: the twin's tangent rule)
    equals the forward-mode oracle ``flash_attention_jvp_ref``; its HVP of
    a fixed projection of o, forward-over-reverse, equals
    ``torch.autograd.functional.hvp`` of the materialized attention
    (``flash_attention_ref``), within 1e-5 of the largest element.  KV
    chunks of 24 and 40 keys (no divisor up to 512 but S)."""
    rng = np.random.default_rng(4)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    B, hd = 2, 32
    q, k, v = t(B, H, S, hd), t(B, Hkv, S, hd), t(B, Hkv, S, hd)
    r = t(B, H, S, hd)
    kw = dict(causal=True, window=window, softcap=softcap)
    o = flash_attention(q, k, v, use_jvp=True, **kw)
    torch.testing.assert_close(o, flash_attention(q, k, v, **kw), rtol=0,
                               atol=0)
    torch.testing.assert_close(o, kref.flash_attention_ref(q, k, v, **kw)[0],
                               rtol=1e-5, atol=1e-6)

    tangents = (t(B, H, S, hd), t(B, Hkv, S, hd), t(B, Hkv, S, hd))
    _, jvp = torch.func.jvp(
        lambda a, b, c: flash_attention(a, b, c, use_jvp=True, **kw),
        (q, k, v), tangents)
    want = kref.flash_attention_jvp_ref(q, k, v, *tangents, **kw)
    _leaf_close([jvp.numpy()], [want.numpy()])

    def proj(fn):
        return lambda a, b, c: (fn(a, b, c) * r).sum()

    _, hvp = torch.func.jvp(torch.func.grad(
        proj(lambda a, b, c: flash_attention(a, b, c, use_jvp=True, **kw)),
        argnums=(0, 1, 2)), (q, k, v), tangents)
    _, want = torch.autograd.functional.hvp(
        proj(lambda a, b, c: kref.flash_attention_ref(a, b, c, **kw)[0]),
        (q, k, v), tangents)
    _leaf_close([x.numpy() for x in hvp], [x.numpy() for x in want])


# ---------------------------------------------------------------------------
# the twins' tangent rules against autograd's JVP of their plain versions


@pytest.mark.parametrize("case", ["nll_tied", "nll_untied_softcap",
                                  "attn", "attn_gqa_window_softcap"])
def test_twin_jvp_rules_match_plain_jvp(case):
    """Each twin's ``jvp`` rule (``torch.func.jvp`` reaches it) against
    ``torch.autograd.functional.jvp`` (the double-backward trick) of its
    plain counterpart: the CE over materialized logits and the
    materialized attention ``flash_attention_ref``; the primal output and
    its tangent within 1e-5 of their largest element."""
    rng = np.random.default_rng(12)
    if case.startswith("nll"):
        transpose_w = case == "nll_untied_softcap"
        softcap = 30.0 if transpose_w else None
        V, Vp = 300, 384
        h, w, labels, mask = _ce_inputs(40, 32, V, Vp, transpose_w, seed=5)
        primals = (h, w)
        kw = dict(vocab_size=V, transpose_w=transpose_w, softcap=softcap)

        def twin(a, b):
            return fused_lm_loss_jvp(a, b, labels, mask, **kw)[0]

        def plain(a, b):
            return _plain_ce(a, b, labels, mask, V=V,
                             transpose_w=transpose_w, softcap=softcap)
    else:
        H, Hkv, S, window, softcap = ((4, 4, 24, None, None)
                                      if case == "attn"
                                      else (4, 2, 40, 9, 20.0))
        B, hd = 2, 16
        primals = tuple(torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32))
            for shape in ((B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd)))
        kw = dict(causal=True, window=window, softcap=softcap)

        def twin(a, b, c):
            return flash_attention(a, b, c, use_jvp=True, **kw)

        def plain(a, b, c):
            return kref.flash_attention_ref(a, b, c, **kw)[0]
    tangents = tuple(torch.from_numpy(
        rng.standard_normal(p.shape).astype(np.float32)) for p in primals)
    out, tan = torch.func.jvp(twin, primals, tangents)
    want_out, want_tan = torch.autograd.functional.jvp(plain, primals,
                                                       tangents)
    _leaf_close([out.numpy(), tan.numpy()],
                [want_out.numpy(), want_tan.numpy()])
