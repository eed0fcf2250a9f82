"""The port's training forward (repro_torch.models: full_attention,
forward_hidden, loss_fn, sampled_loss_fn through models/loss.py, every
loss route and remat policy) held against the JAX reference on GPT2_TINY:
the same weights (carried over by ``params_from_jax``), the same numpy
batch, the reference's fused loss in interpret mode, its chunked and
unfused routes and its materialized-scores attention."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gpt2 import GPT2_TINY
from repro.kernels.fused_ce import seed_from_key
from repro.models import get_model as jax_get_model
from repro.models.layers import full_attention as jax_full_attention
from repro_torch.convert import params_from_jax
from repro_torch.core.types import flat_tensors, tree_leaves, tree_unflatten
from repro_torch.models import ModelConfig, get_model
from repro_torch.models.layers import (_flash_attention_proj,
                                       chunked_attention, full_attention,
                                       train_attention)
from repro_torch.kernels.fused_ce import ce_forward_sampled_plain, vocab_chunk
from repro_torch.models.loss import lm_loss
from repro.models.loss import _chunked_sweep as jax_chunked_sweep

# One intra-op thread per process: the suite runs six pytest-xdist workers
# on the machine's cores, and torch's default pool in every worker
# oversubscribes them, slowing every test beside it (JAX's too) severalfold.
torch.set_num_threads(1)

CFG32 = dataclasses.replace(GPT2_TINY, dtype="float32")
TCFG32 = ModelConfig(**dataclasses.asdict(CFG32))


@pytest.fixture(scope="module")
def weights():
    params = jax_get_model(CFG32).init_params(CFG32, jax.random.PRNGKey(0))
    return params, params_from_jax(jax.tree.map(np.asarray, params), TCFG32)


def _batch(B=4, S=24, mask=True, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, CFG32.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, CFG32.vocab_size, (B, S)).astype(np.int32)}
    if mask:
        out["mask"] = (rng.random((B, S)) > 0.25).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _grads(tparams, loss):
    tree = tparams.param_tree()
    return tree_unflatten(tree, torch.autograd.grad(loss, flat_tensors(tree)))


def _assert_grads(tgrads, jgrads, atol):
    for t, j in zip(tree_leaves(tgrads), jax.tree.leaves(jgrads)):
        t = torch.stack(t) if isinstance(t, list) else t
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_full_attention_matches_reference(weights, dtype, atol):
    """Causal training attention of layer 0: fp32 within 1e-5, bf16
    within 2e-2 (the reference tests' bf16 bound)."""
    params, tparams = weights
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 40, CFG32.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = jax_full_attention(jp, jx, CFG32, None)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = full_attention(tparams.layers[0].attn, tx, TCFG32)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=atol)


def test_train_attention_routes(weights):
    """"auto" (and None) and "full" take the materialized route up to 4096
    tokens and "auto" the chunked one above; "chunked", "flash" and
    "flash_jvp" take theirs; an unknown route raises."""
    _, tparams = weights
    x = torch.zeros(1, 8, CFG32.d_model)
    p = tparams.layers[0].attn
    for impl in ("auto", "full", None):
        torch.testing.assert_close(train_attention(p, x, TCFG32, impl=impl),
                                   full_attention(p, x, TCFG32))
    torch.testing.assert_close(train_attention(p, x, TCFG32, impl="flash"),
                               _flash_attention_proj(p, x, TCFG32))
    torch.testing.assert_close(
        train_attention(p, x, TCFG32, impl="flash_jvp"),
        _flash_attention_proj(p, x, TCFG32), rtol=0, atol=0)
    torch.testing.assert_close(train_attention(p, x, TCFG32, impl="chunked"),
                               chunked_attention(p, x, TCFG32), rtol=0,
                               atol=0)
    long = torch.randn(1, 4100, CFG32.d_model,
                       generator=torch.Generator().manual_seed(0)) * 0.1
    torch.testing.assert_close(train_attention(p, long, TCFG32),
                               chunked_attention(p, long, TCFG32), rtol=0,
                               atol=0)
    with pytest.raises(ValueError):
        train_attention(p, x, TCFG32, impl="nope")


def test_loss_fn_and_grads_match_reference(weights):
    """CE through the fused loss with the final norm fused, masked mean:
    loss within 1e-5 and every parameter's gradient within 2e-5 (the
    reference's loss-impl agreement bound)."""
    params, tparams = weights
    jb, tb = _batch()
    jm = jax_get_model(CFG32)
    (jloss, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss_fn(CFG32, p, jb, loss_impl="fused"),
        has_aux=True)(params)
    loss, met = get_model(TCFG32).loss_fn(TCFG32, tparams, tb)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    np.testing.assert_allclose(met["ce"].item(), float(jmet["ce"]),
                               atol=1e-5)
    _assert_grads(_grads(tparams, loss), jg, atol=2e-5)


def test_sampled_loss_fn_matches_reference(weights):
    """GNB's sampled-label NLL on the reference's noise seed: the same
    draws, so the NLL, its valid count and ĝ agree."""
    params, tparams = weights
    jb, tb = _batch(B=2, mask=False)
    key = jax.random.PRNGKey(11)
    jm = jax_get_model(CFG32)
    (jnll, jn), jg = jax.value_and_grad(
        lambda p: jm.sampled_loss_fn(CFG32, p, jb, key, loss_impl="fused"),
        has_aux=True)(params)
    nll, n = get_model(TCFG32).sampled_loss_fn(
        TCFG32, tparams, tb, np.asarray(seed_from_key(key)))
    assert float(n) == float(jn) == 48.0
    np.testing.assert_allclose(nll.item(), float(jnll), atol=1e-5)
    _assert_grads(_grads(tparams, nll), jg, atol=2e-5)


def test_forward_logits_match_reference(weights):
    params, tparams = weights
    jb, tb = _batch(B=2, S=16, mask=False)
    want, _ = jax_get_model(CFG32).forward(CFG32, params, jb["tokens"])
    got, aux = get_model(TCFG32).forward(TCFG32, tparams, tb["tokens"])
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4)


def test_fused_jvp_loss_matches_reference(weights):
    """The loss twin of the Hutchinson path (the final norm in PyTorch,
    then the CE forward's value and a differentiable backward) against the
    reference's ``fused_jvp`` (interpret mode): loss within 1e-5 and
    every gradient within 2e-5, as the fused route."""
    params, tparams = weights
    jb, tb = _batch()
    jm = jax_get_model(CFG32)
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jm.loss_fn(CFG32, p, jb, loss_impl="fused_jvp"),
        has_aux=True)(params)
    loss, _ = get_model(TCFG32).loss_fn(TCFG32, tparams, tb,
                                        loss_impl="fused_jvp")
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    _assert_grads(_grads(tparams, loss), jg, atol=2e-5)


@pytest.mark.parametrize("impl", ["chunked", "unfused"])
def test_loss_routes_match_reference(weights, impl):
    """The reference's other loss routes: "chunked" (the plain vocab sweep,
    its backward recomputing each chunk) and "unfused" (materialized
    logits), masked mean, against the reference's same route: loss within
    1e-5 and every gradient within 2e-5, the fused route's bounds; the
    valid count is the mask's."""
    params, tparams = weights
    jb, tb = _batch()
    jm = jax_get_model(CFG32)
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jm.loss_fn(CFG32, p, jb, loss_impl=impl),
        has_aux=True)(params)
    loss, met = get_model(TCFG32).loss_fn(TCFG32, tparams, tb,
                                          loss_impl=impl)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    _assert_grads(_grads(tparams, loss), jg, atol=2e-5)
    hidden = torch.zeros(4, 24, CFG32.d_model)
    _, n_valid = lm_loss(TCFG32, tparams, hidden, tb["labels"], tb["mask"],
                         impl=impl)
    assert float(n_valid) == float(tb["mask"].sum())


def _vocab_cfg(vocab):
    cfg = dataclasses.replace(CFG32, vocab_size=vocab)
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def wide_weights():
    """GPT2_TINY at vocab 4500 (padded to 4608: three 1536-column chunks of
    the sweep, the last with 108 padded columns)."""
    cfg, tcfg = _vocab_cfg(4500)
    params = jax_get_model(cfg).init_params(cfg, jax.random.PRNGKey(2))
    return cfg, tcfg, params, params_from_jax(jax.tree.map(np.asarray,
                                                           params), tcfg)


def _chunk_noise(key, n_rows, vp):
    """The reference's Gumbel noise of the chunked sweep, chunk c from
    ``fold_in(key, c)`` (models/loss.py:_chunked_sweep), as (n_rows, vp)."""
    bv = vocab_chunk(vp, 2048, 128)
    return np.concatenate([np.asarray(jax.random.gumbel(
        jax.random.fold_in(key, c), (n_rows, bv), jnp.float32))
        for c in range(vp // bv)], axis=1)


@pytest.mark.parametrize("impl", ["chunked", "unfused"])
def test_sampled_loss_routes_match_reference(wide_weights, impl):
    """GNB's sampled-label NLL on the chunked and unfused routes with the
    reference's draws passed in (the chunked sweep's Gumbel noise, the
    unfused route's ``jax.random.categorical`` labels): the drawn labels
    identical, the NLL within 1e-5 and ĝ within 2e-5 (the fused route's
    bounds), B the mask's count."""
    cfg, tcfg, params, tparams = wide_weights
    jb, tb = _batch(B=2, S=16)
    key = jax.random.PRNGKey(11)
    jm = jax_get_model(cfg)
    (jnll, jn), jg = jax.value_and_grad(
        lambda p: jm.sampled_loss_fn(cfg, p, jb, key, loss_impl=impl),
        has_aux=True)(params)
    model = get_model(tcfg)
    if impl == "chunked":
        noise = _chunk_noise(key, 32, cfg.padded_vocab)
        draws = dict(noise=torch.from_numpy(noise).reshape(2, 16, -1))
        # the labels of the reference's sweep against the port's
        hid = jm.forward_hidden(cfg, params, jb["tokens"])[0]
        _, _, want_y = jax_chunked_sweep(cfg, hid, params["embed"]["tok"],
                                         False, rng=key)
        thid = model.forward_hidden(tcfg, tparams, tb["tokens"])[0]
        _, _, got_y = ce_forward_sampled_plain(
            thid.detach().reshape(32, -1), tparams.embed["tok"].detach(),
            torch.zeros(2, cfg.d_model),
            lambda c0, w: draws["noise"].reshape(32, -1)[:, c0:c0 + w],
            vocab=cfg.vocab_size)
        np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    else:
        logits = jm.forward(cfg, params, jb["tokens"])[0]
        yhat = jax.random.categorical(key, logits, axis=-1)
        draws = dict(yhat=torch.from_numpy(np.array(yhat)))
        assert (np.asarray(yhat) < cfg.vocab_size).all()
    nll, n = model.sampled_loss_fn(tcfg, tparams, tb, None, loss_impl=impl,
                                   **draws)
    assert float(n) == float(jn) == float(tb["mask"].sum())
    np.testing.assert_allclose(nll.item(), float(jnll), atol=1e-5)
    _assert_grads(_grads(tparams, nll), jg, atol=2e-5)


def test_sampled_routes_draw_from_a_generator(weights):
    """Without given draws the chunked and unfused routes draw from a
    ``torch.Generator``: the same seed gives the same NLL, another seed
    another; both match the labeled loss at the labels they drew only in
    expectation, so here only finiteness and determinism are held."""
    _, tparams = weights
    _, tb = _batch(B=2, S=8, mask=False)
    model = get_model(TCFG32)
    for impl in ("chunked", "unfused"):
        out = [model.sampled_loss_fn(TCFG32, tparams, tb,
                                     torch.Generator().manual_seed(s),
                                     loss_impl=impl)[0].item()
               for s in (0, 0, 1)]
        assert np.isfinite(out).all()
        assert out[0] == out[1] != out[2]


@pytest.mark.parametrize("remat", ["full", "dots", "scan2"])
@pytest.mark.parametrize("attn,impl", [("flash", "fused"),
                                       ("full", "chunked"),
                                       ("chunked", "unfused")])
def test_remat_is_bit_identical(weights, remat, attn, impl):
    """Every remat policy recomputes the same operations on the same
    inputs: the loss and every gradient equal remat="none"'s bit for bit
    (GPT2_TINY's 4 layers make "scan2" one checkpointed group of 4
    checkpointed layers), on three attention and loss routes."""
    _, tparams = weights
    _, tb = _batch(B=2, S=16)
    model = get_model(TCFG32)
    out = []
    for r in ("none", remat):
        loss, _ = model.loss_fn(TCFG32, tparams, tb, attn_impl=attn,
                                loss_impl=impl, remat=r)
        out.append((loss, _grads(tparams, loss)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(flat_tensors(g0), flat_tensors(g1)):
        assert torch.equal(a, b)


def test_unknown_remat_raises(weights):
    _, tparams = weights
    with pytest.raises(ValueError, match="remat"):
        get_model(TCFG32).forward_hidden(TCFG32, tparams,
                                         torch.zeros(1, 4, dtype=torch.int32),
                                         remat="nope")


def test_parameters_train_but_serving_builds_no_graph(weights):
    _, tparams = weights
    assert all(p.requires_grad for p in tparams.parameters())
    model = get_model(TCFG32)
    cache = model.init_slots(TCFG32, 2, 16)
    logits = model.decode_slots(TCFG32, tparams, cache,
                                torch.zeros(2, 1, dtype=torch.int32),
                                torch.zeros(2, dtype=torch.int32))
    assert not logits.requires_grad and logits.grad_fn is None
    assert not any(t.requires_grad for t in cache.values())
